"""mxtpu_torch → ONNX graph exporter (the mx2onnx direction), the port
of ``mxtpu/contrib/onnx/_export.py``: walk the Symbol DAG in
topological order and emit one or more ONNX ``NodeProto`` per op
through a converter registry, with parameters becoming graph
initializers. The converter table is the reference's, so a graph and
its parameters give the reference's file byte for byte.

- The Symbol graph is framework-neutral (op nodes with Python-value
  attrs), so conversion is a name/attr mapping, not a trace. Shapes and
  dtypes come from the symbol's inference on the ``meta`` device
  (``Symbol._infer_structs``): no kernel runs and nothing touches the
  card during export.
- Export is inference-oriented (like the reference exporter): BatchNorm
  uses its running stats, Dropout is the identity.
"""
from __future__ import annotations

import json
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as _np
import torch

from ...base import MXNetError, dtype_name
from . import onnx_pb2 as _pb

# dtype name ↔ TensorProto.DataType
_NP2ONNX = {
    "float32": _pb.TensorProto.FLOAT,
    "float64": _pb.TensorProto.DOUBLE,
    "float16": _pb.TensorProto.FLOAT16,
    "bfloat16": _pb.TensorProto.BFLOAT16,
    "uint8": _pb.TensorProto.UINT8,
    "int8": _pb.TensorProto.INT8,
    "int16": _pb.TensorProto.INT16,
    "uint16": _pb.TensorProto.UINT16,
    "int32": _pb.TensorProto.INT32,
    "int64": _pb.TensorProto.INT64,
    "uint32": _pb.TensorProto.UINT32,
    "uint64": _pb.TensorProto.UINT64,
    "bool": _pb.TensorProto.BOOL,
}
_ONNX2NP = {v: k for k, v in _NP2ONNX.items()}


class _Struct:
    """A value's shape (tuple) and numpy dtype, what the converters read
    (the reference's ``jax.ShapeDtypeStruct``)."""

    __slots__ = ("shape", "dtype")

    def __init__(self, shape, dtype):
        self.shape = tuple(int(d) for d in shape)
        self.dtype = _np_dtype(dtype)


def _np_dtype(dt) -> _np.dtype:
    """A numpy dtype for a numpy or torch dtype; bfloat16 is ml_dtypes'
    (numpy has none)."""
    name = dtype_name(dt) if isinstance(dt, torch.dtype) else str(dt)
    if name == "bfloat16":
        import ml_dtypes
        return _np.dtype(ml_dtypes.bfloat16)
    return _np.dtype(dt if not isinstance(dt, torch.dtype) else name)


def to_numpy(v) -> _np.ndarray:
    """An NDArray, tensor or array as numpy in its own dtype (bfloat16
    as ml_dtypes', where ``asnumpy`` would widen it to float32)."""
    t = getattr(v, "_data", v)
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_np_dtype(t.dtype))
        return t.numpy()
    return _np.asarray(t)


def np_dtype_to_onnx(dt) -> int:
    name = _np.dtype(dt).name if str(dt) != "bfloat16" else "bfloat16"
    try:
        return _NP2ONNX[name]
    except KeyError:
        raise ValueError(f"dtype {dt!r} has no ONNX TensorProto mapping")


def make_tensor(name: str, arr: _np.ndarray) -> _pb.TensorProto:
    """numpy → TensorProto with raw_data payload (little-endian, the ONNX
    raw encoding). bfloat16 is stored as its raw 2-byte payload."""
    t = _pb.TensorProto()
    t.name = name
    t.dims.extend(int(d) for d in arr.shape)
    if str(arr.dtype) == "bfloat16":
        t.data_type = _pb.TensorProto.BFLOAT16
        t.raw_data = arr.tobytes()
        return t
    t.data_type = np_dtype_to_onnx(arr.dtype)
    a = _np.ascontiguousarray(arr)
    if a.dtype.byteorder == ">":
        a = a.byteswap().view(a.dtype.newbyteorder("<"))
    t.raw_data = a.tobytes()
    return t


def tensor_to_np(t: _pb.TensorProto) -> _np.ndarray:
    """TensorProto → numpy, accepting both raw_data and the typed
    repeated fields (both appear in the wild)."""
    shape = tuple(t.dims)
    if t.data_type == _pb.TensorProto.BFLOAT16:
        try:
            import ml_dtypes
            dt = _np.dtype(ml_dtypes.bfloat16)
        except ImportError:  # pragma: no cover
            raise ValueError("bfloat16 tensor requires ml_dtypes")
        if t.raw_data:
            return _np.frombuffer(t.raw_data, dtype=dt).reshape(shape).copy()
        # int32_data carries the raw 16-bit payloads per the ONNX spec
        u16 = _np.asarray(t.int32_data, dtype=_np.uint16)
        return u16.view(dt).reshape(shape).copy()
    np_dt = _np.dtype(_ONNX2NP[t.data_type])
    if t.raw_data:
        return _np.frombuffer(t.raw_data, dtype=np_dt).reshape(shape).copy()
    if t.data_type == _pb.TensorProto.FLOAT16:
        # typed storage carries fp16 BIT PATTERNS in int32_data (spec),
        # not numeric values — bitcast, don't convert
        u16 = _np.asarray(t.int32_data, dtype=_np.uint16)
        return u16.view(_np.float16).reshape(shape).copy()
    if t.data_type == _pb.TensorProto.FLOAT:
        data = t.float_data
    elif t.data_type == _pb.TensorProto.DOUBLE:
        data = t.double_data
    elif t.data_type == _pb.TensorProto.INT64:
        data = t.int64_data
    elif t.data_type in (_pb.TensorProto.UINT32, _pb.TensorProto.UINT64):
        data = t.uint64_data  # spec: uint32 values also ride uint64_data
    else:  # int32 field carries every narrower integer/bool/fp16 type
        data = t.int32_data
    return _np.asarray(data, dtype=np_dt).reshape(shape)


class GraphBuilder:
    """Accumulates ONNX graph pieces while the symbol topo-walk runs."""

    def __init__(self, opset: int = 13):
        self.opset = opset
        self.nodes: List[_pb.NodeProto] = []
        self.initializers: List[_pb.TensorProto] = []
        self.inputs: List[_pb.ValueInfoProto] = []
        self.outputs: List[_pb.ValueInfoProto] = []
        self._names_used: set = set()
        self._struct_of: Dict[str, Any] = {}  # value name → ShapeDtypeStruct
        # constant values known at export time (params + folded nodes);
        # materialized as initializers lazily, only when referenced by an
        # emitted node or a graph output
        self.const_np: Dict[str, _np.ndarray] = {}
        self.zero_states: set = set()  # _rnn_init_state outputs

    # -- naming ---------------------------------------------------------
    def unique(self, hint: str) -> str:
        name, i = hint, 0
        while name in self._names_used:
            i += 1
            name = f"{hint}_{i}"
        self._names_used.add(name)
        return name

    # -- emission -------------------------------------------------------
    def add_node(self, op_type: str, inputs: Sequence[str],
                 outputs: Sequence[str], name: Optional[str] = None,
                 **attrs) -> _pb.NodeProto:
        n = _pb.NodeProto()
        n.op_type = op_type
        n.input.extend(inputs)
        n.output.extend(outputs)
        n.name = name or self.unique(op_type.lower())
        for k, v in attrs.items():
            n.attribute.append(self._attr(k, v))
        self.nodes.append(n)
        for o in outputs:
            self._names_used.add(o)
        return n

    @staticmethod
    def _attr(name: str, v) -> _pb.AttributeProto:
        a = _pb.AttributeProto()
        a.name = name
        if isinstance(v, bool):
            a.type = _pb.AttributeProto.INT
            a.i = int(v)
        elif isinstance(v, (int, _np.integer)):
            a.type = _pb.AttributeProto.INT
            a.i = int(v)
        elif isinstance(v, (float, _np.floating)):
            a.type = _pb.AttributeProto.FLOAT
            a.f = float(v)
        elif isinstance(v, str):
            a.type = _pb.AttributeProto.STRING
            a.s = v.encode()
        elif isinstance(v, (list, tuple)):
            if all(isinstance(x, (int, _np.integer)) for x in v):
                a.type = _pb.AttributeProto.INTS
                a.ints.extend(int(x) for x in v)
            elif all(isinstance(x, (int, float, _np.floating)) for x in v):
                a.type = _pb.AttributeProto.FLOATS
                a.floats.extend(float(x) for x in v)
            else:
                raise ValueError(f"attr {name}: unsupported list {v!r}")
        elif isinstance(v, _pb.TensorProto):
            a.type = _pb.AttributeProto.TENSOR
            a.t.CopyFrom(v)
        else:
            raise ValueError(f"attr {name}: unsupported value {v!r}")
        return a

    def add_initializer(self, hint: str, arr: _np.ndarray) -> str:
        name = self.unique(hint)
        self.initializers.append(make_tensor(name, _np.asarray(arr)))
        return name

    def const_like(self, hint: str, value, ref: str) -> str:
        """Scalar constant initializer matching `ref`'s inferred dtype
        (falls back to f32 when the dtype is unknown)."""
        st = self._struct_of.get(ref)
        dt = st.dtype if st is not None else _np.float32
        return self.add_initializer(hint, _np.asarray(value, dtype=dt))

    def i64(self, hint: str, values) -> str:
        return self.add_initializer(
            hint, _np.asarray(list(values), dtype=_np.int64))

    def dtype_of(self, value_name: str):
        st = self._struct_of.get(value_name)
        return st.dtype if st is not None else None

    def shape_of(self, value_name: str):
        st = self._struct_of.get(value_name)
        return tuple(st.shape) if st is not None else None

    @staticmethod
    def value_info(name: str, struct) -> _pb.ValueInfoProto:
        vi = _pb.ValueInfoProto()
        vi.name = name
        tt = vi.type.tensor_type
        tt.elem_type = np_dtype_to_onnx(struct.dtype)
        for d in struct.shape:
            tt.shape.dim.add().dim_value = int(d)
        return vi


# -- converter registry ------------------------------------------------------
_CONVERTERS: Dict[str, Callable] = {}


def converts(*op_names):
    def deco(fn):
        for n in op_names:
            _CONVERTERS[n] = fn
        return fn
    return deco


def _spatial(attr, nd, default=1):
    if attr is None:
        return [default] * nd
    return [int(x) for x in attr]


def _sym_pads(pad: Sequence[int]) -> List[int]:
    # mxtpu symmetric pad → ONNX [begin..., end...] order
    return list(pad) + list(pad)


@converts("Convolution")
def _conv(b: GraphBuilder, node, ins, outs):
    k = [int(x) for x in node.attrs["kernel"]]
    nd = len(k)
    b.add_node(
        "Conv", ins, outs, name=node.name,
        kernel_shape=k,
        strides=_spatial(node.attrs.get("stride"), nd),
        dilations=_spatial(node.attrs.get("dilate"), nd),
        pads=_sym_pads(_spatial(node.attrs.get("pad"), nd, 0)),
        group=int(node.attrs.get("num_group", 1)))


@converts("Deconvolution")
def _deconv(b, node, ins, outs):
    k = [int(x) for x in node.attrs["kernel"]]
    nd = len(k)
    b.add_node(
        "ConvTranspose", ins, outs, name=node.name,
        kernel_shape=k,
        strides=_spatial(node.attrs.get("stride"), nd),
        dilations=_spatial(node.attrs.get("dilate"), nd),
        pads=_sym_pads(_spatial(node.attrs.get("pad"), nd, 0)),
        output_padding=_spatial(node.attrs.get("adj"), nd, 0),
        group=int(node.attrs.get("num_group", 1)))


@converts("FullyConnected")
def _fc(b, node, ins, outs):
    data = ins[0]
    no_bias = node.attrs.get("no_bias", False) or len(ins) < 3
    shp = b.shape_of(data)
    if node.attrs.get("flatten", True):
        if shp is None or len(shp) != 2:
            flat = b.unique(node.name + "_flat")
            b.add_node("Flatten", [data], [flat], axis=1)
            data = flat
    elif shp is None or len(shp) != 2:
        # ONNX Gemm is 2-D only; N-D flatten=False lowers to
        # MatMul(data, Wᵀ) (+ Add bias), which broadcasts over batch dims
        wt = b.unique(node.name + "_wt")
        b.add_node("Transpose", [ins[1]], [wt], perm=[1, 0])
        mm_out = outs if no_bias else [b.unique(node.name + "_mm")]
        b.add_node("MatMul", [data, wt], mm_out,
                   name=None if no_bias else node.name + "_matmul")
        if not no_bias:
            b.add_node("Add", [mm_out[0], ins[2]], outs, name=node.name)
        return
    gemm_in = [data, ins[1]] + ([] if no_bias else [ins[2]])
    b.add_node("Gemm", gemm_in, outs, name=node.name,
               alpha=1.0, beta=1.0, transA=0, transB=1)


_ACT2ONNX = {"relu": "Relu", "sigmoid": "Sigmoid", "tanh": "Tanh",
             "softrelu": "Softplus", "softsign": "Softsign"}


@converts("Activation")
def _act(b, node, ins, outs):
    b.add_node(_ACT2ONNX[node.attrs.get("act_type", "relu")],
               ins, outs, name=node.name)


@converts("LeakyReLU")
def _leaky(b, node, ins, outs):
    at = node.attrs.get("act_type", "leaky")
    slope = float(node.attrs.get("slope", 0.25))
    if at in ("leaky", "rrelu"):
        b.add_node("LeakyRelu", ins[:1], outs, name=node.name, alpha=slope)
    elif at == "elu":
        b.add_node("Elu", ins[:1], outs, name=node.name, alpha=slope)
    elif at == "selu":
        b.add_node("Selu", ins[:1], outs, name=node.name)
    elif at == "prelu":
        b.add_node("PRelu", ins, outs, name=node.name)
    elif at == "gelu":
        # exact gelu: x * 0.5 * (1 + erf(x / sqrt(2)))
        x = ins[0]
        d = b.unique(node.name + "_div")
        e = b.unique(node.name + "_erf")
        p = b.unique(node.name + "_p1")
        h = b.unique(node.name + "_half")
        b.add_node("Div", [x, b.const_like("sqrt2", _np.sqrt(2.0), x)], [d])
        b.add_node("Erf", [d], [e])
        b.add_node("Add", [e, b.const_like("one", 1.0, x)], [p])
        b.add_node("Mul", [x, p], [h])
        b.add_node("Mul", [h, b.const_like("half", 0.5, x)], outs,
                   name=node.name)
    else:
        raise ValueError(f"LeakyReLU act_type {at!r} not exportable")


@converts("softmax")
def _softmax(b, node, ins, outs):
    if node.attrs.get("temperature") not in (None, 1.0):
        raise ValueError("softmax with temperature is not exportable")
    b.add_node("Softmax", ins[:1], outs, name=node.name,
               axis=int(node.attrs.get("axis", -1)))


@converts("log_softmax")
def _log_softmax(b, node, ins, outs):
    b.add_node("LogSoftmax", ins[:1], outs, name=node.name,
               axis=int(node.attrs.get("axis", -1)))


@converts("SoftmaxOutput")
def _softmax_output(b, node, ins, outs):
    # inference semantics of the training head: softmax over the data input
    b.add_node("Softmax", ins[:1], outs, name=node.name, axis=-1)


@converts("Pooling")
def _pooling(b, node, ins, outs):
    pt = node.attrs.get("pool_type", "max")
    if node.attrs.get("global_pool", False):
        op = {"max": "GlobalMaxPool", "avg": "GlobalAveragePool"}.get(pt)
        if op is None:
            # global sum-pool: ReduceSum over spatial axes
            shp = b.shape_of(ins[0])
            nd = (len(shp) - 2) if shp else 2
            b.add_node("ReduceSum",
                       [ins[0], b.i64(node.name + "_axes",
                                      range(2, 2 + nd))],
                       outs, name=node.name, keepdims=1)
            return
        b.add_node(op, ins, outs, name=node.name)
        return
    k = [int(x) for x in node.attrs["kernel"]]
    nd = len(k)
    stride = node.attrs.get("stride")
    kw = dict(
        kernel_shape=k,
        strides=k if stride is None else _spatial(stride, nd),
        pads=_sym_pads(_spatial(node.attrs.get("pad"), nd, 0)),
        ceil_mode=int(node.attrs.get("pooling_convention", "valid") == "full"))
    if pt == "max":
        b.add_node("MaxPool", ins, outs, name=node.name, **kw)
    elif pt == "avg":
        kw["count_include_pad"] = int(node.attrs.get("count_include_pad",
                                                     True))
        b.add_node("AveragePool", ins, outs, name=node.name, **kw)
    else:
        raise ValueError(f"pool_type {pt!r} not exportable")


@converts("BatchNorm")
def _batchnorm(b, node, ins, outs):
    if int(node.attrs.get("axis", 1)) != 1:
        raise ValueError("BatchNorm(axis != 1) not exportable — ONNX "
                         "BatchNormalization is defined over axis 1 only")
    if node.attrs.get("fix_gamma", False):
        # reference semantic: gamma is pinned to 1 regardless of its
        # stored value. Emit a FRESH ones initializer for THIS node —
        # rewriting the original tensor would also change any other
        # consumer of the same value.
        shp = b.shape_of(ins[1])
        if shp is None:
            raise ValueError(
                f"BatchNorm(fix_gamma=True) export needs gamma's shape "
                f"({node.name})")
        dt = b.dtype_of(ins[1]) or _np.dtype(_np.float32)
        ins = list(ins)
        ins[1] = b.add_initializer(node.name + "_fixed_gamma",
                                   _np.ones(shp, dtype=dt))
    b.add_node("BatchNormalization", ins, outs, name=node.name,
               epsilon=float(node.attrs.get("eps", 1e-5)),
               momentum=float(node.attrs.get("momentum", 0.9)))


@converts("LayerNorm")
def _layernorm(b, node, ins, outs):
    if node.attrs.get("output_mean_var"):
        raise ValueError("LayerNorm(output_mean_var=True) not exportable")
    b.opset = max(b.opset, 17)  # LayerNormalization standardized in 17
    b.add_node("LayerNormalization", ins, outs, name=node.name,
               axis=int(node.attrs.get("axis", -1)),
               epsilon=float(node.attrs.get("eps", 1e-5)))


@converts("LRN")
def _lrn(b, node, ins, outs):
    b.add_node("LRN", ins, outs, name=node.name,
               alpha=float(node.attrs.get("alpha", 1e-4)),
               beta=float(node.attrs.get("beta", 0.75)),
               bias=float(node.attrs.get("knorm", 2.0)),
               size=int(node.attrs["nsize"]))


@converts("Dropout")
def _dropout(b, node, ins, outs):
    # ONNX Dropout defaults to inference (identity) when training_mode
    # is absent; ratio rides along for consumers that re-train.
    b.add_node("Dropout", ins[:1], outs, name=node.name)


@converts("Embedding")
def _embedding(b, node, ins, outs):
    idx = b.unique(node.name + "_idx")
    b.add_node("Cast", [ins[0]], [idx], to=int(_pb.TensorProto.INT64))
    b.add_node("Gather", [ins[1], idx], outs, name=node.name, axis=0)


@converts("take")
def _take(b, node, ins, outs):
    idx = b.unique(node.name + "_idx")
    b.add_node("Cast", [ins[1]], [idx], to=int(_pb.TensorProto.INT64))
    b.add_node("Gather", [ins[0], idx], outs, name=node.name,
               axis=int(node.attrs.get("axis", 0)))


# -- elementwise binary ------------------------------------------------------
_BINOP = {"broadcast_add": "Add", "elemwise_add": "Add", "add": "Add",
          "broadcast_sub": "Sub", "elemwise_sub": "Sub",
          "broadcast_mul": "Mul", "elemwise_mul": "Mul",
          "broadcast_div": "Div", "elemwise_div": "Div",
          "broadcast_power": "Pow",
          "broadcast_maximum": "Max", "broadcast_minimum": "Min",
          "maximum": "Max", "minimum": "Min"}


def _binop(b, node, ins, outs):
    b.add_node(_BINOP[node.op], ins, outs, name=node.name)


for _name in _BINOP:
    _CONVERTERS[_name] = _binop

_CMPOP = {"broadcast_equal": "Equal", "broadcast_not_equal": "Equal",
          "broadcast_greater": "Greater", "broadcast_lesser": "Less",
          "broadcast_greater_equal": "GreaterOrEqual",
          "broadcast_lesser_equal": "LessOrEqual"}


def _cmpop(b, node, ins, outs):
    raw = b.unique(node.name + "_bool")
    b.add_node(_CMPOP[node.op], ins, [raw])
    cur = raw
    if node.op == "broadcast_not_equal":
        nn = b.unique(node.name + "_not")
        b.add_node("Not", [cur], [nn])
        cur = nn
    # mxtpu comparisons return 0/1 in the operand dtype, ONNX returns bool
    dt = b.dtype_of(ins[0]) or _np.dtype(_np.float32)
    b.add_node("Cast", [cur], outs, name=node.name,
               to=int(np_dtype_to_onnx(dt)))


for _name in _CMPOP:
    _CONVERTERS[_name] = _cmpop

# -- scalar ops --------------------------------------------------------------
_SCALAR = {"_plus_scalar": ("Add", False), "_minus_scalar": ("Sub", False),
           "_rminus_scalar": ("Sub", True), "_mul_scalar": ("Mul", False),
           "_div_scalar": ("Div", False), "_rdiv_scalar": ("Div", True),
           "_power_scalar": ("Pow", False), "_rpower_scalar": ("Pow", True),
           "_maximum_scalar": ("Max", False), "_minimum_scalar": ("Min", False),
           "_mod_scalar": ("Mod", False)}


def _scalar_op(b, node, ins, outs):
    op, rev = _SCALAR[node.op]
    sc = node.attrs.get("scalar", 0.0)
    # the scalar const takes the NODE OUTPUT dtype (what jnp's promotion
    # produced natively — e.g. int32 / 2 → float32); when that differs
    # from the input dtype, cast the input so the ONNX binary op sees
    # matching operand types and reproduces the native numerics
    out_dt = b.dtype_of(node.name)
    in_dt = b.dtype_of(ins[0])
    x = ins[0]
    if out_dt is not None and in_dt is not None and out_dt != in_dt:
        cast_in = b.unique(node.name + "_castin")
        b.add_node("Cast", [x], [cast_in], to=int(np_dtype_to_onnx(out_dt)))
        x = cast_in
    dt = out_dt or in_dt or _np.dtype(_np.float32)
    c = b.add_initializer(node.name + "_scalar", _np.asarray(sc, dtype=dt))
    lhs, rhs = (c, x) if rev else (x, c)
    if op == "Mod" and dt.kind == "f":
        # jnp.mod is floor-mod; ONNX float Mod must be fmod=1 (C fmod),
        # which differs on negatives — decompose: a - floor(a/b)*b
        d = b.unique(node.name + "_div")
        fl = b.unique(node.name + "_floor")
        mu = b.unique(node.name + "_mul")
        b.add_node("Div", [lhs, rhs], [d])
        b.add_node("Floor", [d], [fl])
        b.add_node("Mul", [fl, rhs], [mu])
        b.add_node("Sub", [lhs, mu], outs, name=node.name)
        return
    b.add_node(op, [lhs, rhs], outs, name=node.name)


for _name in _SCALAR:
    _CONVERTERS[_name] = _scalar_op

# -- unary -------------------------------------------------------------------
_UNARY = {"relu": "Relu", "sigmoid": "Sigmoid", "tanh": "Tanh",
          "exp": "Exp", "log": "Log", "sqrt": "Sqrt", "negative": "Neg",
          "abs": "Abs", "erf": "Erf", "floor": "Floor", "ceil": "Ceil",
          "round": "Round", "sign": "Sign", "sin": "Sin", "cos": "Cos",
          "identity": "Identity", "BlockGrad": "Identity",
          "stop_gradient": "Identity", "reciprocal": "Reciprocal"}


def _unary(b, node, ins, outs):
    b.add_node(_UNARY[node.op], ins[:1], outs, name=node.name)


for _name in _UNARY:
    _CONVERTERS[_name] = _unary


@converts("square")
def _square(b, node, ins, outs):
    b.add_node("Mul", [ins[0], ins[0]], outs, name=node.name)


@converts("rsqrt")
def _rsqrt(b, node, ins, outs):
    s = b.unique(node.name + "_sqrt")
    b.add_node("Sqrt", ins[:1], [s])
    b.add_node("Reciprocal", [s], outs, name=node.name)


# -- shape ops ---------------------------------------------------------------
@converts("reshape")
def _reshape(b, node, ins, outs):
    if node.attrs.get("reverse"):
        raise ValueError("reshape(reverse=True) not exportable")
    shape = [int(x) for x in node.attrs["shape"]]
    if any(s in (-2, -3, -4) for s in shape):
        # resolve MXNet special codes against the inferred output shape
        shp = b.shape_of(node.name)
        if shp is None:
            raise ValueError(f"reshape special codes need inferred shapes "
                             f"({node.name})")
        shape = [int(x) for x in shp]
    b.add_node("Reshape", [ins[0], b.i64(node.name + "_shape", shape)],
               outs, name=node.name)


@converts("Flatten", "flatten")
def _flatten(b, node, ins, outs):
    b.add_node("Flatten", ins, outs, name=node.name, axis=1)


@converts("reshape_like")
def _reshape_like(b, node, ins, outs):
    shp = b.shape_of(ins[1]) or b.shape_of(node.name)
    if shp is None:
        raise ValueError("reshape_like export needs inferred shapes")
    b.add_node("Reshape",
               [ins[0], b.i64(node.name + "_shape",
                              [int(x) for x in shp])],
               outs, name=node.name)


@converts("transpose")
def _transpose(b, node, ins, outs):
    axes = node.attrs.get("axes")
    kw = {"perm": [int(a) for a in axes]} if axes else {}
    b.add_node("Transpose", ins, outs, name=node.name, **kw)


@converts("swapaxes")
def _swapaxes(b, node, ins, outs):
    shp = b.shape_of(ins[0])
    if shp is None:
        raise ValueError("swapaxes export needs inferred input shape")
    perm = list(range(len(shp)))
    d1, d2 = int(node.attrs.get("dim1", 0)), int(node.attrs.get("dim2", 0))
    perm[d1], perm[d2] = perm[d2], perm[d1]
    b.add_node("Transpose", ins, outs, name=node.name, perm=perm)


@converts("expand_dims")
def _expand_dims(b, node, ins, outs):
    b.add_node("Unsqueeze",
               [ins[0], b.i64(node.name + "_axes",
                              [int(node.attrs["axis"])])],
               outs, name=node.name)


@converts("squeeze")
def _squeeze(b, node, ins, outs):
    ax = node.attrs.get("axis")
    inputs = [ins[0]]
    if ax is not None:
        axes = [ax] if isinstance(ax, int) else list(ax)
        inputs.append(b.i64(node.name + "_axes", [int(a) for a in axes]))
    b.add_node("Squeeze", inputs, outs, name=node.name)


@converts("concat")
def _concat(b, node, ins, outs):
    b.add_node("Concat", ins, outs, name=node.name,
               axis=int(node.attrs.get("dim", 1)))


@converts("stack")
def _stack(b, node, ins, outs):
    axis = int(node.attrs.get("axis", 0))
    axes = b.i64(node.name + "_axes", [axis])
    unsq = []
    for i, x in enumerate(ins):
        u = b.unique(f"{node.name}_u{i}")
        b.add_node("Unsqueeze", [x, axes], [u])
        unsq.append(u)
    b.add_node("Concat", unsq, outs, name=node.name, axis=axis)


@converts("split")
def _split(b, node, ins, outs):
    axis = int(node.attrs.get("axis", 1))
    if node.attrs.get("squeeze_axis"):
        raw = [b.unique(f"{node.name}_p{i}") for i in range(len(outs))]
        b.add_node("Split", ins, raw, name=node.name, axis=axis)
        axes = b.i64(node.name + "_axes", [axis])
        for r, o in zip(raw, outs):
            b.add_node("Squeeze", [r, axes], [o])
    else:
        b.add_node("Split", ins, outs, name=node.name, axis=axis)


@converts("slice")
def _slice(b, node, ins, outs):
    begin = [0 if x is None else int(x) for x in node.attrs["begin"]]
    end = [2 ** 62 if e is None else int(e) for e in node.attrs["end"]]
    step = node.attrs.get("step")
    if step and any(s is not None and int(s) < 0 for s in step):
        # the open-end sentinel below is wrong under reversed traversal
        raise ValueError("slice with negative step is not exportable")
    inputs = [ins[0],
              b.i64(node.name + "_starts", begin),
              b.i64(node.name + "_ends", end),
              b.i64(node.name + "_axes", range(len(begin)))]
    if step:
        inputs.append(b.i64(node.name + "_steps",
                            [1 if s is None else int(s) for s in step]))
    b.add_node("Slice", inputs, outs, name=node.name)


@converts("slice_axis")
def _slice_axis(b, node, ins, outs):
    axis = int(node.attrs["axis"])
    begin = int(node.attrs["begin"])
    end = node.attrs.get("end")
    b.add_node("Slice",
               [ins[0],
                b.i64(node.name + "_starts", [begin]),
                b.i64(node.name + "_ends",
                      [2 ** 62 if end is None else int(end)]),
                b.i64(node.name + "_axes", [axis])],
               outs, name=node.name)


@converts("clip")
def _clip(b, node, ins, outs):
    # ONNX Clip takes optional min/max inputs; an absent bound is an
    # empty-string placeholder, NOT a materialized ±inf (which would
    # overflow integer dtypes)
    inputs = [ins[0]]
    a_min, a_max = node.attrs.get("a_min"), node.attrs.get("a_max")
    inputs.append("" if a_min is None
                  else b.const_like(node.name + "_min", a_min, ins[0]))
    if a_max is not None:
        inputs.append(b.const_like(node.name + "_max", a_max, ins[0]))
    elif inputs[1] == "":
        inputs = inputs[:1]  # no bounds at all
    b.add_node("Clip", inputs, outs, name=node.name)


@converts("cast")
def _cast(b, node, ins, outs):
    b.add_node("Cast", ins, outs, name=node.name,
               to=int(np_dtype_to_onnx(node.attrs["dtype"])))


@converts("pad")
def _pad(b, node, ins, outs):
    pw = [int(x) for x in node.attrs["pad_width"]]
    nd = len(pw) // 2
    onnx_pads = [pw[2 * i] for i in range(nd)] + \
                [pw[2 * i + 1] for i in range(nd)]
    mode = node.attrs.get("mode", "constant")
    inputs = [ins[0], b.i64(node.name + "_pads", onnx_pads)]
    if mode == "constant":
        inputs.append(b.const_like(node.name + "_cval",
                                   node.attrs.get("constant_value", 0),
                                   ins[0]))
    b.add_node("Pad", inputs, outs, name=node.name,
               mode={"constant": "constant", "edge": "edge",
                     "reflect": "reflect"}[mode])


@converts("where")
def _where(b, node, ins, outs):
    cond = b.unique(node.name + "_cond")
    b.add_node("Cast", [ins[0]], [cond], to=int(_pb.TensorProto.BOOL))
    b.add_node("Where", [cond, ins[1], ins[2]], outs, name=node.name)


@converts("add_n")
def _add_n(b, node, ins, outs):
    b.add_node("Sum", ins, outs, name=node.name)


# -- reductions --------------------------------------------------------------
_REDUCE = {"mean": "ReduceMean", "max": "ReduceMax", "min": "ReduceMin",
           "prod": "ReduceProd"}


def _reduce_axes(b, node, ins):
    """Resolve the mxtpu axis/exclude attrs to explicit ONNX axes
    (None = reduce all)."""
    ax = node.attrs.get("axis")
    if ax is None:
        return None  # reduce all (exclude has no effect without axis)
    axes = [int(ax)] if isinstance(ax, int) else [int(a) for a in ax]
    if node.attrs.get("exclude"):
        shp = b.shape_of(ins[0])
        if shp is None:
            raise ValueError(
                f"{node.op}(exclude=True) export needs inferred shapes")
        nd_ = len(shp)
        listed = {a % nd_ for a in axes}
        axes = [i for i in range(nd_) if i not in listed]
    return axes


def _reduce(b, node, ins, outs):
    axes = _reduce_axes(b, node, ins)
    kw = {"keepdims": int(bool(node.attrs.get("keepdims", False)))}
    if axes is not None:
        kw["axes"] = axes
    b.add_node(_REDUCE[node.op], ins[:1], outs, name=node.name, **kw)


for _name in _REDUCE:
    _CONVERTERS[_name] = _reduce


@converts("sum")
def _reduce_sum(b, node, ins, outs):
    # opset 13 moved ReduceSum's axes from attr to input
    axes = _reduce_axes(b, node, ins)
    inputs = [ins[0]]
    if axes is not None:
        inputs.append(b.i64(node.name + "_axes", axes))
    b.add_node("ReduceSum", inputs, outs, name=node.name,
               keepdims=int(bool(node.attrs.get("keepdims", False))))


@converts("dot")
def _dot(b, node, ins, outs):
    a, c = ins
    sa, sc = b.shape_of(a), b.shape_of(c)
    if node.attrs.get("transpose_a"):
        if sa is None or len(sa) != 2:
            raise ValueError("dot(transpose_a) export needs 2-D lhs")
        t = b.unique(node.name + "_at")
        b.add_node("Transpose", [a], [t], perm=[1, 0])
        a = t
    if node.attrs.get("transpose_b"):
        if sc is None or len(sc) != 2:
            raise ValueError("dot(transpose_b) export needs 2-D rhs")
        t = b.unique(node.name + "_bt")
        b.add_node("Transpose", [c], [t], perm=[1, 0])
        c = t
    # MXNet dot contracts lhs-last with rhs-first: MatMul agrees when the
    # rhs is ≤2-D (the overwhelmingly common case)
    if sc is not None and len(sc) > 2:
        raise ValueError("dot with >2-D rhs is not exportable to MatMul")
    b.add_node("MatMul", [a, c], outs, name=node.name)


@converts("RNN")
def _rnn(b, node, ins, outs):
    """Fused RNN → ONNX LSTM/GRU/RNN, one node per layer.

    The cuDNN-packed 1-D parameter vector is unpacked via the op's own
    ``rnn_param_layout`` — constant folding has already collapsed the
    gluon-side reshape/concat packing chain, so ``ins[1]`` is a known
    constant. Gate orders are remapped (ours i,f,g,o / r,z,n → ONNX
    i,o,f,c / z,r,h); GRU exports with ``linear_before_reset=1``, the
    cuDNN semantic this op implements."""
    from ...ndarray.ops import rnn_param_layout, rnn_gates

    mode = node.attrs.get("mode", "lstm").lower()
    if node.attrs.get("projection_size") is not None:
        raise ValueError("RNN projection_size not exportable")
    if node.attrs.get("lstm_state_clip_min") is not None or \
            node.attrs.get("lstm_state_clip_max") is not None:
        raise ValueError("RNN state clipping not exportable")
    L = int(node.attrs.get("num_layers", 1))
    bi = bool(node.attrs.get("bidirectional", False))
    H = int(node.attrs["state_size"])
    d = 2 if bi else 1
    is_lstm = mode == "lstm"
    pvec = b.const_np.get(ins[1])
    if pvec is None:
        raise ValueError("RNN export needs compile-time-constant "
                         "parameters (an initializer or foldable chain)")
    shp = b.shape_of(ins[0])
    if shp is None:
        raise ValueError("RNN export needs the inferred input shape")
    T, N, C = (int(x) for x in shp)
    ng = rnn_gates(mode)
    layout, total = rnn_param_layout(mode, C, H, L, bi)
    pvec = _np.asarray(pvec).reshape(-1)
    if pvec.shape[0] != total:
        raise ValueError(f"RNN parameters size {pvec.shape[0]} != "
                         f"expected {total}")

    def get(kind, layer, dr):
        off, shape = layout[(kind, layer, dr)]
        n = int(_np.prod(shape))
        return pvec[off:off + n].reshape(shape)

    def reorder(w):  # rows grouped per gate, our order → ONNX order
        if mode == "lstm":  # i,f,g,o → i,o,f,c(=g)
            i, f, g, o = _np.split(w, 4, axis=0)
            return _np.concatenate([i, o, f, g], axis=0)
        if mode == "gru":  # r,z,n → z,r,h(=n)
            r, z, n_ = _np.split(w, 3, axis=0)
            return _np.concatenate([z, r, n_], axis=0)
        return w

    onnx_op = {"lstm": "LSTM", "gru": "GRU",
               "rnn_tanh": "RNN", "rnn_relu": "RNN"}[mode]
    h0_given = ins[2] not in b.zero_states
    c0_given = is_lstm and len(ins) > 3 and ins[3] not in b.zero_states

    def layer_state(src, layer, hint):
        if L == 1:
            return src
        sl = b.unique(f"{node.name}_{hint}{layer}")
        b.add_node("Slice",
                   [src, b.i64(f"{sl}_starts", [layer * d]),
                    b.i64(f"{sl}_ends", [(layer + 1) * d]),
                    b.i64(f"{sl}_axes", [0])], [sl])
        return sl

    cur = ins[0]
    hts, cts = [], []
    for layer in range(L):
        W = _np.stack([reorder(get("i2h_weight", layer, dr))
                       for dr in range(d)])
        R = _np.stack([reorder(get("h2h_weight", layer, dr))
                       for dr in range(d)])
        Bv = _np.stack([_np.concatenate(
            [reorder(get("i2h_bias", layer, dr)[:, None])[:, 0],
             reorder(get("h2h_bias", layer, dr)[:, None])[:, 0]])
            for dr in range(d)])
        inputs = [cur,
                  b.add_initializer(f"{node.name}_W{layer}", W),
                  b.add_initializer(f"{node.name}_R{layer}", R),
                  b.add_initializer(f"{node.name}_B{layer}", Bv),
                  ""]  # sequence_lens absent
        if h0_given:
            inputs.append(layer_state(ins[2], layer, "h0"))
        elif is_lstm and c0_given:
            inputs.append("")
        if is_lstm and c0_given:
            inputs.append(layer_state(ins[3], layer, "c0"))
        while inputs and inputs[-1] == "":
            inputs.pop()
        y = b.unique(f"{node.name}_Y{layer}")
        yh = b.unique(f"{node.name}_Yh{layer}")
        node_outs = [y, yh]
        if is_lstm:
            yc = b.unique(f"{node.name}_Yc{layer}")
            node_outs.append(yc)
            cts.append(yc)
        hts.append(yh)
        kw = dict(hidden_size=H,
                  direction="bidirectional" if bi else "forward")
        if mode == "gru":
            kw["linear_before_reset"] = 1
        if onnx_op == "RNN":
            kw["activations"] = \
                ["Tanh" if mode == "rnn_tanh" else "Relu"] * d
        b.add_node(onnx_op, inputs, node_outs, **kw)
        # Y (T, D, N, H) → (T, N, D*H), the fused-op layout
        tr = b.unique(f"{node.name}_Ytr{layer}")
        b.add_node("Transpose", [y], [tr], perm=[0, 2, 1, 3])
        nxt = outs[0] if layer == L - 1 else \
            b.unique(f"{node.name}_l{layer}")
        b.add_node("Reshape",
                   [tr, b.i64(f"{node.name}_yshape{layer}",
                              [T, N, d * H])], [nxt])
        cur = nxt
    if len(outs) > 1:  # final hidden: per-layer (D,N,H) → (L*D, N, H)
        if len(hts) == 1:
            b.add_node("Identity", [hts[0]], [outs[1]])
        else:
            b.add_node("Concat", hts, [outs[1]], axis=0)
    if len(outs) > 2:
        if len(cts) == 1:
            b.add_node("Identity", [cts[0]], [outs[2]])
        else:
            b.add_node("Concat", cts, [outs[2]], axis=0)


@converts("batch_dot")
def _batch_dot(b, node, ins, outs):
    a, c = ins
    for key, idx in (("transpose_a", 0), ("transpose_b", 1)):
        if node.attrs.get(key):
            shp = b.shape_of(ins[idx])
            if shp is None:
                raise ValueError(f"batch_dot({key}) export needs shapes")
            perm = list(range(len(shp)))
            perm[-1], perm[-2] = perm[-2], perm[-1]
            t = b.unique(f"{node.name}_t{idx}")
            b.add_node("Transpose", [ins[idx]], [t], perm=perm)
            if idx == 0:
                a = t
            else:
                c = t
    b.add_node("MatMul", [a, c], outs, name=node.name)


# -- constant folding --------------------------------------------------------
# never fold: stochastic ops (one folded sample would freeze the
# randomness). _rnn_init_state never reaches here — export_graph
# `continue`s on it before the fold check.
_NO_FOLD_OPS = {"Dropout"}


def _fold_node(b: GraphBuilder, node, ins, outs) -> bool:
    """Constant-fold one op node: when every input value is already
    known at export time (a parameter initializer or an earlier folded
    node), evaluate the op eagerly through the shared op registry and
    record the results in ``b.const_np`` instead of emitting ONNX nodes.

    This is what collapses the RNN converter's parameter-packing chain
    (per-layer reshape/concat of the cuDNN-packed vector) into the
    single constant ``ins[1]`` the converter reads back; folded
    intermediates never reach the file (the lazy initializer
    materialization in export_graph only writes referenced names).
    Returns True when the node was folded (caller skips conversion)."""
    if not ins or any(i not in b.const_np for i in ins):
        return False
    op = node.op
    low = op.lower()
    if op in _NO_FOLD_OPS or "random" in low or "sample" in low or \
            "rand" in low:
        return False
    from ... import autograd as _autograd
    from ...ndarray import NDArray as _NDArray
    from ...symbol.symbol import _call_registry_op

    def host(a):
        if str(a.dtype) == "bfloat16":
            return torch.from_numpy(a.view(_np.int16)).view(torch.bfloat16)
        return torch.from_numpy(_np.ascontiguousarray(a))
    try:
        with _autograd.pause(), torch.no_grad():
            in_nds = [_NDArray(host(b.const_np[i])) for i in ins]
            results = _call_registry_op(node, in_nds, "cpu")
    except Exception:
        return False  # not evaluable eagerly — emit through a converter
    if len(results) < len(outs):
        return False
    for o, r in zip(outs, results):
        arr = to_numpy(r)
        b.const_np[o] = arr
        b._struct_of.setdefault(o, _Struct(arr.shape, arr.dtype))
    return True


# -- graph-level export ------------------------------------------------------
def _onnx_value_names(node) -> List[str]:
    n_out = node.num_outputs or 1
    return [node.name if i == 0 else f"{node.name}_out{i}"
            for i in range(n_out)]


def export_graph(sym, params: Dict[str, Any],
                 input_shapes: Optional[Dict[str, Tuple[int, ...]]] = None,
                 opset: int = 13,
                 graph_name: str = "mxtpu") -> _pb.ModelProto:
    """Symbol + params → ModelProto. `params` maps var name → NDArray or
    numpy array (becomes an initializer); remaining vars are graph inputs
    whose shapes come from `input_shapes`."""
    from ...symbol.symbol import _meta

    np_params = {k: to_numpy(v) for k, v in params.items()}

    nodes = sym._topo()
    b = GraphBuilder(opset=opset)

    # shape/dtype inference over the whole graph, on the meta device
    kw = {k: _meta(v.shape, v.dtype) for k, v in np_params.items()}
    for k, v in (input_shapes or {}).items():
        kw.setdefault(k, _meta(tuple(v), "float32"))
    try:
        structs = sym._infer_structs(**kw)
    except MXNetError as e:
        # re-run as the mxlint graph-validity pass (MXL100) so the
        # failure names the first inconsistent node with its op and
        # inferred input shapes, instead of a deep trace-internal error
        from ..analysis.graph import format_issues, validate_graph
        issues = validate_graph(sym, params=np_params,
                                input_shapes=input_shapes)
        detail = format_issues(issues) if issues else str(e)
        raise ValueError(
            f"ONNX export aborted — graph failed validation:\n{detail}"
        ) from e
    entry_structs = {}
    if structs is not None:
        entry_structs, var_structs = structs

    value_names: Dict[Tuple[int, int], str] = {}
    for node in nodes:
        if node.is_var():
            value_names[(id(node), 0)] = node.name
            b._names_used.add(node.name)
            if node.name in np_params:
                arr = np_params[node.name]
                b.const_np[node.name] = arr
                b._struct_of[node.name] = _Struct(arr.shape, arr.dtype)
            else:
                if structs is not None and node.name in var_structs:
                    t = var_structs[node.name]
                    st = _Struct(t.shape, t.dtype)
                elif input_shapes and node.name in input_shapes:
                    st = _Struct(input_shapes[node.name], _np.float32)
                else:
                    raise ValueError(
                        f"input {node.name!r}: no shape available — pass "
                        f"input_shapes={{'{node.name}': (...)}}")
                b.inputs.append(b.value_info(node.name, st))
                b._struct_of[node.name] = st

    for node in nodes:
        if node.is_var():
            continue
        outs = _onnx_value_names(node)
        for i, o in enumerate(outs):
            value_names[(id(node), i)] = o
            t = entry_structs.get((id(node), i))
            if t is not None:
                b._struct_of[o] = _Struct(t.shape, t.dtype)
        ins = [value_names[(id(p), i)] for p, i in node.inputs]
        if node.op == "_rnn_init_state":
            # a zero initial state — the RNN converter omits the
            # corresponding optional ONNX input (defaults to zeros)
            b.zero_states.update(outs)
            continue
        if _fold_node(b, node, ins, outs):
            continue
        conv = _CONVERTERS.get(node.op)
        if conv is None:
            raise ValueError(
                f"op {node.op!r} ({node.name}) has no ONNX converter; "
                f"supported: {sorted(_CONVERTERS)}")
        conv(b, node, ins, outs)

    # prune nodes whose outputs never reach a graph output (e.g. the
    # state heads a converter emits for a multi-output op whose states
    # the symbol never consumed) — reverse sweep over the topo order
    head_names = {value_names[(id(h), i)] for h, i in sym._entries}
    needed = set(head_names)
    kept: List[_pb.NodeProto] = []
    for n2 in reversed(b.nodes):
        if any(o in needed for o in n2.output):
            kept.append(n2)
            needed.update(i for i in n2.input if i)
    b.nodes = kept[::-1]

    # lazily materialize constants (params + folded values) that emitted
    # nodes or graph outputs actually reference — folding intermediates
    # (e.g. the RNN packing chain) never hit the file
    referenced = set(head_names)
    for n2 in b.nodes:
        referenced.update(n2.input)
    # drop initializers that only pruned nodes consumed
    b.initializers = [t for t in b.initializers if t.name in referenced]
    existing = {t.name for t in b.initializers}
    produced = {o for n2 in b.nodes for o in n2.output}
    bridge = {n for n in head_names
              if n in b.const_np and n not in produced}
    for name in sorted(referenced):
        if name and name not in existing and name in b.const_np and \
                name not in bridge:
            b.initializers.append(
                make_tensor(name, _np.asarray(b.const_np[name])))
            existing.add(name)
    for name in sorted(bridge):
        # a fully-folded graph output: initializers are not valid
        # outputs, so bridge with Identity
        cname = b.unique(name + "_const")
        b.initializers.append(
            make_tensor(cname, _np.asarray(b.const_np[name])))
        b.add_node("Identity", [cname], [name])
        produced.add(name)
    inputs_set = {vi.name for vi in b.inputs}
    for name in sorted(referenced):
        if name and name not in existing and name not in produced and \
                name not in inputs_set:
            raise ValueError(
                f"value {name!r} is consumed but never produced — "
                f"likely an unsupported zero-state or optional output")

    model = _pb.ModelProto()
    model.ir_version = 8
    model.producer_name = "mxtpu"
    model.producer_version = "1.0"
    model.opset_import.add(domain="", version=b.opset)
    g = model.graph
    g.name = graph_name
    g.node.extend(b.nodes)
    g.initializer.extend(b.initializers)
    g.input.extend(b.inputs)
    for head, i in sym._entries:
        name = value_names[(id(head), i)]
        st = b._struct_of.get(name)
        if st is not None:
            g.output.append(b.value_info(name, st))
        else:
            vi = _pb.ValueInfoProto()
            vi.name = name
            g.output.append(vi)
    return model
