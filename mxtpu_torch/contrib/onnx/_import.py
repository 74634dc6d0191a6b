"""ONNX → mxtpu_torch graph importer (the onnx2mx direction), the port
of ``mxtpu/contrib/onnx/_import.py``: walk the ONNX graph's nodes and
rebuild each as a Symbol op through the reference's converter table.
Initializers become parameter NDArrays on the caller's device;
BatchNormalization's running stats land in ``aux_params`` (the
reference's arg/aux split).

Opset semantics target 13+ (per-axis Softmax, axes-as-inputs for
Squeeze/Unsqueeze/ReduceSum); attr-style axes from older opsets are
accepted where they are unambiguous.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as _np

from . import onnx_pb2 as _pb
from ._export import tensor_to_np, _ONNX2NP

_IMPORTERS: Dict[str, Callable] = {}


def imports(*op_types):
    def deco(fn):
        for t in op_types:
            _IMPORTERS[t] = fn
        return fn
    return deco


class _Ctx:
    """Per-import state: value name → Symbol, plus constant lookup for
    inputs that must be compile-time values (shapes, axes, pads...)."""

    def __init__(self, sym_mod, consts: Dict[str, _np.ndarray]):
        self.sym = sym_mod
        self.values: Dict[str, Any] = {}
        self.consts = consts  # initializer/Constant values by name

    def const(self, name: str, what: str) -> _np.ndarray:
        if name not in self.consts:
            raise ValueError(
                f"{what}: input {name!r} must be a constant "
                f"(initializer or Constant node) to import")
        return self.consts[name]

    def maybe_const(self, name: Optional[str]):
        return self.consts.get(name) if name else None


def _opt(ins, i):
    """i-th input or None — ONNX encodes absent optional inputs as ""
    (mapped to None), so presence means BOTH in range and non-None."""
    return ins[i] if len(ins) > i and ins[i] is not None else None


def _attrs(node) -> Dict[str, Any]:
    out = {}
    for a in node.attribute:
        if a.type == _pb.AttributeProto.INT:
            out[a.name] = int(a.i)
        elif a.type == _pb.AttributeProto.FLOAT:
            out[a.name] = float(a.f)
        elif a.type == _pb.AttributeProto.STRING:
            out[a.name] = a.s.decode()
        elif a.type == _pb.AttributeProto.INTS:
            out[a.name] = [int(x) for x in a.ints]
        elif a.type == _pb.AttributeProto.FLOATS:
            out[a.name] = [float(x) for x in a.floats]
        elif a.type == _pb.AttributeProto.TENSOR:
            out[a.name] = tensor_to_np(a.t)
        else:
            out[a.name] = a
    return out


def _sym_pad_pair(pads: Optional[List[int]], nd: int,
                  what: str) -> Tuple[List[int], Optional[List[int]]]:
    """ONNX [begin..., end...] pads → (symmetric mxtpu pad, or explicit
    flat pad_width when asymmetric)."""
    if not pads:
        return [0] * nd, None
    begin, end = pads[:nd], pads[nd:]
    if begin == end:
        return [int(p) for p in begin], None
    pw = [0, 0, 0, 0]  # N, C
    for b, e in zip(begin, end):
        pw += [int(b), int(e)]
    return [0] * nd, pw


def _check_auto_pad(at, what):
    ap = at.get("auto_pad", "NOTSET")
    if ap not in ("NOTSET", "VALID"):  # VALID ≡ explicit zero pads
        raise ValueError(f"{what}: auto_pad={ap!r} unsupported — "
                         f"re-export with explicit pads")


@imports("Conv")
def _conv(ctx, node, ins, at):
    _check_auto_pad(at, "Conv")
    w = ctx.maybe_const(node.input[1])
    kernel = at.get("kernel_shape")
    if kernel is None:
        if w is None:
            raise ValueError("Conv without kernel_shape needs const weight")
        kernel = list(w.shape[2:])
    nd = len(kernel)
    group = int(at.get("group", 1))
    pad, pw = _sym_pad_pair(at.get("pads"), nd, "Conv")
    data = ins[0]
    if pw is not None:
        data = ctx.sym.pad(data, mode="constant", pad_width=tuple(pw))
    num_filter = w.shape[0] if w is not None else None
    return ctx.sym.Convolution(
        data, ins[1], _opt(ins, 2),
        kernel=tuple(int(k) for k in kernel),
        stride=tuple(at.get("strides", [1] * nd)),
        dilate=tuple(at.get("dilations", [1] * nd)),
        pad=tuple(pad), num_filter=num_filter, num_group=group,
        no_bias=_opt(ins, 2) is None)


@imports("ConvTranspose")
def _conv_transpose(ctx, node, ins, at):
    kernel = at.get("kernel_shape")
    if kernel is None:
        w = ctx.const(node.input[1], "ConvTranspose weight")
        kernel = list(w.shape[2:])
    nd = len(kernel)
    if at.get("output_shape") or at.get("auto_pad", "NOTSET") != "NOTSET":
        raise ValueError("ConvTranspose output_shape/auto_pad unsupported")
    pad, pw = _sym_pad_pair(at.get("pads"), nd, "ConvTranspose")
    if pw is not None:
        raise ValueError("asymmetric ConvTranspose pads unsupported")
    return ctx.sym.Deconvolution(
        ins[0], ins[1], _opt(ins, 2),
        kernel=tuple(int(k) for k in kernel),
        stride=tuple(at.get("strides", [1] * nd)),
        dilate=tuple(at.get("dilations", [1] * nd)),
        pad=tuple(pad),
        adj=tuple(at.get("output_padding", [0] * nd)),
        num_group=int(at.get("group", 1)),
        no_bias=_opt(ins, 2) is None)


@imports("Gemm")
def _gemm(ctx, node, ins, at):
    alpha, beta = at.get("alpha", 1.0), at.get("beta", 1.0)
    transA, transB = at.get("transA", 0), at.get("transB", 0)
    if alpha == 1.0 and beta == 1.0 and not transA and transB:
        return ctx.sym.FullyConnected(
            ins[0], ins[1], _opt(ins, 2),
            no_bias=_opt(ins, 2) is None, flatten=False)
    a, b = ins[0], ins[1]
    y = ctx.sym.dot(a, b, transpose_a=bool(transA), transpose_b=bool(transB))
    if alpha != 1.0:
        y = y * alpha
    c = _opt(ins, 2)
    if c is not None:
        y = ctx.sym.broadcast_add(y, c * beta if beta != 1.0 else c)
    return y


@imports("MatMul")
def _matmul(ctx, node, ins, at):
    # mxtpu `dot` (contract lhs-last/rhs-first) == MatMul for rhs ≤ 2-D;
    # SymbolBlock abstract-eval will surface rank mismatches if the model
    # actually feeds batched rhs — those import as batch_dot by hand.
    return ctx.sym.dot(ins[0], ins[1])


_ACT = {"Relu": "relu", "Sigmoid": "sigmoid", "Tanh": "tanh",
        "Softplus": "softrelu", "Softsign": "softsign"}


def _act(ctx, node, ins, at):
    return ctx.sym.Activation(ins[0], act_type=_ACT[node.op_type])


for _t in _ACT:
    _IMPORTERS[_t] = _act


@imports("LeakyRelu")
def _leaky(ctx, node, ins, at):
    return ctx.sym.LeakyReLU(ins[0], act_type="leaky",
                             slope=at.get("alpha", 0.01))


@imports("Elu")
def _elu(ctx, node, ins, at):
    return ctx.sym.LeakyReLU(ins[0], act_type="elu",
                             slope=at.get("alpha", 1.0))


@imports("Selu")
def _selu(ctx, node, ins, at):
    return ctx.sym.LeakyReLU(ins[0], act_type="selu")


@imports("PRelu")
def _prelu(ctx, node, ins, at):
    return ctx.sym.LeakyReLU(ins[0], gamma=ins[1], act_type="prelu")


@imports("Erf")
def _erf(ctx, node, ins, at):
    return ctx.sym.erf(ins[0])


@imports("Softmax")
def _softmax(ctx, node, ins, at):
    return ctx.sym.softmax(ins[0], axis=at.get("axis", -1))


@imports("LogSoftmax")
def _log_softmax(ctx, node, ins, at):
    return ctx.sym.log_softmax(ins[0], axis=at.get("axis", -1))


@imports("MaxPool", "AveragePool")
def _pool(ctx, node, ins, at):
    kernel = at["kernel_shape"]
    nd = len(kernel)
    _check_auto_pad(at, node.op_type)
    pt = "max" if node.op_type == "MaxPool" else "avg"
    pad, pw = _sym_pad_pair(at.get("pads"), nd, node.op_type)
    data = ins[0]
    if pw is not None:
        if pt == "max":
            raise ValueError("asymmetric MaxPool pads unsupported")
        if not at.get("count_include_pad", 0):
            # pre-padding zeros would silently include them in the mean
            raise ValueError("asymmetric AveragePool pads with "
                             "count_include_pad=0 unsupported")
        data = ctx.sym.pad(data, mode="constant", pad_width=tuple(pw))
        pad = [0] * nd
    return ctx.sym.Pooling(
        data, kernel=tuple(int(k) for k in kernel), pool_type=pt,
        stride=tuple(at.get("strides", [1] * nd)),
        pad=tuple(pad),
        pooling_convention="full" if at.get("ceil_mode") else "valid",
        count_include_pad=bool(at.get("count_include_pad", 0)))


@imports("GlobalMaxPool", "GlobalAveragePool")
def _global_pool(ctx, node, ins, at):
    pt = "max" if node.op_type == "GlobalMaxPool" else "avg"
    return ctx.sym.Pooling(ins[0], global_pool=True, pool_type=pt)


@imports("BatchNormalization")
def _bn(ctx, node, ins, at):
    # inference semantics: normalize with the provided running stats
    return ctx.sym.BatchNorm(
        ins[0], ins[1], ins[2], ins[3], ins[4],
        eps=at.get("epsilon", 1e-5), momentum=at.get("momentum", 0.9),
        use_global_stats=True)


@imports("LayerNormalization")
def _ln(ctx, node, ins, at):
    return ctx.sym.LayerNorm(
        ins[0], ins[1],
        _opt(ins, 2) if _opt(ins, 2) is not None
        else ctx.sym.zeros_like(ins[1]),
        axis=at.get("axis", -1), eps=at.get("epsilon", 1e-5))


@imports("LRN")
def _lrn(ctx, node, ins, at):
    return ctx.sym.LRN(ins[0], alpha=at.get("alpha", 1e-4),
                       beta=at.get("beta", 0.75),
                       knorm=at.get("bias", 1.0), nsize=at["size"])


@imports("Dropout")
def _dropout(ctx, node, ins, at):
    # opset ≥ 12 carries ratio as the optional second input (a constant
    # scalar); older opsets use the attribute; default 0.5 per the spec.
    # A PRESENT ratio input that is a runtime tensor must fail loudly —
    # silently training the re-imported model at 0.5 would corrupt it.
    if len(node.input) > 1 and node.input[1]:
        p = float(_np.asarray(
            ctx.const(node.input[1], "Dropout ratio")).reshape(()))
    else:
        p = at.get("ratio", 0.5)
    return ctx.sym.Dropout(ins[0], p=p)


@imports("Identity")
def _identity(ctx, node, ins, at):
    return ctx.sym.identity(ins[0])


_BIN = {"Add": "broadcast_add", "Sub": "broadcast_sub",
        "Mul": "broadcast_mul", "Div": "broadcast_div",
        "Pow": "broadcast_power"}


def _bin(ctx, node, ins, at):
    return getattr(ctx.sym, _BIN[node.op_type])(ins[0], ins[1])


for _t in _BIN:
    _IMPORTERS[_t] = _bin


@imports("Mod")
def _mod(ctx, node, ins, at):
    if at.get("fmod"):
        # C fmod (sign of dividend): a - trunc(a/b)*b — jnp.mod is
        # floor-mod and would flip the sign for negative dividends
        q = ctx.sym.trunc(ctx.sym.broadcast_div(ins[0], ins[1]))
        return ctx.sym.broadcast_sub(
            ins[0], ctx.sym.broadcast_mul(q, ins[1]))
    return ctx.sym.broadcast_mod(ins[0], ins[1])


@imports("Max", "Min")
def _maxmin(ctx, node, ins, at):
    op = "broadcast_maximum" if node.op_type == "Max" else "broadcast_minimum"
    y = ins[0]
    for x in ins[1:]:
        y = getattr(ctx.sym, op)(y, x)
    return y


@imports("Sum")
def _sum_n(ctx, node, ins, at):
    return ctx.sym.add_n(*ins) if len(ins) > 1 else ctx.sym.identity(ins[0])


_CMP = {"Greater": "broadcast_greater", "Less": "broadcast_lesser",
        "Equal": "broadcast_equal",
        "GreaterOrEqual": "broadcast_greater_equal",
        "LessOrEqual": "broadcast_lesser_equal"}


def _cmp(ctx, node, ins, at):
    # mxtpu comparisons return 0/1 in the operand dtype; ONNX returns
    # bool — downstream Cast/Where handle either
    return getattr(ctx.sym, _CMP[node.op_type])(ins[0], ins[1])


for _t in _CMP:
    _IMPORTERS[_t] = _cmp


@imports("Not")
def _not(ctx, node, ins, at):
    return 1.0 - ins[0]


_UN = {"Exp": "exp", "Log": "log", "Sqrt": "sqrt", "Neg": "negative",
       "Abs": "abs", "Floor": "floor", "Ceil": "ceil", "Round": "round",
       "Sign": "sign", "Sin": "sin", "Cos": "cos",
       "Reciprocal": "reciprocal"}


def _un(ctx, node, ins, at):
    return getattr(ctx.sym, _UN[node.op_type])(ins[0])


for _t in _UN:
    _IMPORTERS[_t] = _un


@imports("Cast")
def _cast(ctx, node, ins, at):
    return ctx.sym.cast(ins[0], dtype=_ONNX2NP[at["to"]])


@imports("Clip")
def _clip(ctx, node, ins, at):
    if len(node.input) > 1:  # opset 11+: min/max as inputs
        def bound(i):
            name = node.input[i] if len(node.input) > i else ""
            if not name:
                return None
            v = ctx.const(name, "Clip bound")  # raises if a runtime tensor
            return None if not _np.isfinite(v).all() else float(v)
        a_min, a_max = bound(1), bound(2)
    else:  # opset < 11: attrs
        a_min, a_max = at.get("min"), at.get("max")
    return ctx.sym.clip(ins[0], a_min=a_min, a_max=a_max)


@imports("Concat")
def _concat(ctx, node, ins, at):
    return ctx.sym.concat(*ins, dim=at.get("axis", 0))


@imports("Reshape")
def _reshape(ctx, node, ins, at):
    if len(node.input) > 1:
        shape = ctx.const(node.input[1], "Reshape shape")
    else:  # opset 1-4 attr form
        shape = _np.asarray(at["shape"])
    if at.get("allowzero"):
        raise ValueError("Reshape(allowzero=1) unsupported")
    return ctx.sym.reshape(ins[0], shape=tuple(int(s) for s in shape))


@imports("Flatten")
def _flatten(ctx, node, ins, at):
    axis = at.get("axis", 1)
    if axis == 1:
        return ctx.sym.Flatten(ins[0])
    if axis == 0:
        return ctx.sym.reshape(ins[0], shape=(1, -1))
    raise ValueError(f"Flatten(axis={axis}) unsupported")


@imports("Transpose")
def _transpose(ctx, node, ins, at):
    perm = at.get("perm")
    return ctx.sym.transpose(ins[0], axes=tuple(perm) if perm else None)


@imports("Unsqueeze")
def _unsqueeze(ctx, node, ins, at):
    axes = ctx.const(node.input[1], "Unsqueeze axes") \
        if len(node.input) > 1 else _np.asarray(at["axes"])
    # ONNX axes index the OUTPUT rank. Rank-agnostic ordering: front
    # inserts (positive axes, ascending) never shift back-relative
    # positions, and back inserts (negative axes, descending — closest
    # to -1 first) never shift front or deeper-negative positions.
    axes = [int(a) for a in axes]
    y = ins[0]
    for a in sorted(a for a in axes if a >= 0):
        y = ctx.sym.expand_dims(y, axis=a)
    for a in sorted((a for a in axes if a < 0), reverse=True):
        y = ctx.sym.expand_dims(y, axis=a)
    return y


@imports("Squeeze")
def _squeeze(ctx, node, ins, at):
    if len(node.input) > 1:
        axes = ctx.const(node.input[1], "Squeeze axes")
        return ctx.sym.squeeze(ins[0], axis=tuple(int(a) for a in axes))
    if "axes" in at:
        return ctx.sym.squeeze(ins[0], axis=tuple(at["axes"]))
    return ctx.sym.squeeze(ins[0])


@imports("Slice")
def _slice(ctx, node, ins, at):
    if len(node.input) > 1:
        starts = ctx.const(node.input[1], "Slice starts")
        ends = ctx.const(node.input[2], "Slice ends")
        axes = ctx.const(node.input[3], "Slice axes") \
            if len(node.input) > 3 else _np.arange(len(starts))
        steps = ctx.const(node.input[4], "Slice steps") \
            if len(node.input) > 4 else _np.ones(len(starts), _np.int64)
    else:  # opset < 10 attr form
        starts = _np.asarray(at["starts"])
        ends = _np.asarray(at["ends"])
        axes = _np.asarray(at.get("axes", list(range(len(starts)))))
        steps = _np.ones(len(starts), _np.int64)
    y = ins[0]
    big = 2 ** 31  # clamp ONNX's INT64_MAX-style "to the end" sentinels
    for s, e, a, st in zip(starts, ends, axes, steps):
        if int(st) != 1:
            raise ValueError("Slice with step != 1 unsupported")
        if int(s) == 0 and int(e) >= big:
            continue  # full-range no-op on this axis
        # python-slice clamping makes an over-large end equal open-ended
        y = ctx.sym.slice_axis(y, axis=int(a), begin=int(s),
                               end=min(int(e), big - 1))
    return y


@imports("Gather")
def _gather(ctx, node, ins, at):
    # mode="wrap": ONNX Gather allows negative (from-the-end) indices,
    # which modulo-wrap reproduces; the take default "clip" would clamp
    # them to index 0
    return ctx.sym.take(ins[0], ins[1], axis=at.get("axis", 0),
                        mode="wrap")


@imports("Where")
def _where(ctx, node, ins, at):
    return ctx.sym.where(ins[0], ins[1], ins[2])


_RED = {"ReduceMean": "mean", "ReduceMax": "max", "ReduceMin": "min",
        "ReduceProd": "prod", "ReduceSum": "sum"}


def _reduce(ctx, node, ins, at):
    if len(node.input) > 1 and node.input[1]:  # axes input (opset 13+)
        axes = tuple(int(a) for a in ctx.const(node.input[1],
                                               f"{node.op_type} axes"))
    else:
        axes = tuple(at["axes"]) if "axes" in at else None
    if axes == ():  # empty axes = reduce all, unless noop flag is set
        if at.get("noop_with_empty_axes"):
            return ctx.sym.identity(ins[0])
        axes = None
    return getattr(ctx.sym, _RED[node.op_type])(
        ins[0], axis=axes, keepdims=bool(at.get("keepdims", 1)))


for _t in _RED:
    _IMPORTERS[_t] = _reduce


@imports("Pad")
def _pad(ctx, node, ins, at):
    if len(node.input) > 3 and node.input[3]:
        # opset 18 added an axes input (pads cover only those axes) —
        # len(pads)//2 below would pad the wrong dims silently
        raise ValueError("Pad with axes input unsupported")
    if len(node.input) > 1:
        pads = ctx.const(node.input[1], "Pad pads")
        cval = ctx.const(node.input[2], "Pad constant_value") \
            if len(node.input) > 2 and node.input[2] else None
    else:
        pads = _np.asarray(at["pads"])
        cval = at.get("value", 0.0)
    nd = len(pads) // 2
    pw = []
    for i in range(nd):
        pw += [int(pads[i]), int(pads[i + nd])]
    return ctx.sym.pad(ins[0], mode=at.get("mode", "constant"),
                       pad_width=tuple(pw),
                       constant_value=0.0 if cval is None else float(cval))


@imports("Split")
def _split(ctx, node, ins, at):
    axis = at.get("axis", 0)
    n = len(node.output)
    sizes = None
    if len(node.input) > 1 and node.input[1]:  # opset 13+: sizes as input
        sizes = ctx.const(node.input[1], "Split sizes")
    elif "split" in at:
        sizes = at["split"]
    if sizes is not None and len(set(int(s) for s in sizes)) != 1:
        raise ValueError("unequal Split unsupported")
    return ctx.sym.split(ins[0], num_outputs=n, axis=axis)


@imports("Constant")
def _constant(ctx, node, ins, at):
    raise AssertionError("Constant nodes are folded before conversion")


def _param(v, device):
    """An initializer as an NDArray on ``device`` in its own dtype."""
    from ... import ndarray as nd
    dt = "bfloat16" if str(v.dtype) == "bfloat16" else None
    return nd.array(v, ctx=device, dtype=dt)


def import_graph(model: _pb.ModelProto, device=None):
    """ModelProto → (Symbol, arg_params, aux_params, input_names); the
    params are made on ``device`` (None: the innermost ``with ctx:``
    scope, else the card)."""
    from ... import symbol as sym_mod

    g = model.graph
    init_np = {t.name: tensor_to_np(t) for t in g.initializer}

    # fold Constant nodes into the initializer table
    nodes = []
    for n in g.node:
        if n.op_type == "Constant":
            at = _attrs(n)
            if "value" not in at:
                raise ValueError("Constant without tensor value unsupported")
            init_np[n.output[0]] = at["value"]
        else:
            nodes.append(n)

    # running stats (BatchNormalization inputs 3,4) are aux, rest are args
    aux_names = set()
    for n in nodes:
        if n.op_type == "BatchNormalization":
            aux_names.update(n.input[3:5])

    ctx = _Ctx(sym_mod, init_np)
    input_names = []
    for vi in g.input:
        if vi.name in init_np:
            continue  # pre-IR4 models list initializers as inputs too
        ctx.values[vi.name] = sym_mod.var(vi.name)
        input_names.append(vi.name)

    def value(name: str):
        if name in ctx.values:
            return ctx.values[name]
        if name in init_np:
            v = sym_mod.var(name, aux=name in aux_names)
            ctx.values[name] = v
            return v
        raise ValueError(f"value {name!r} referenced before definition")

    for n in nodes:
        fn = _IMPORTERS.get(n.op_type)
        if fn is None:
            raise ValueError(
                f"ONNX op {n.op_type!r} has no mxtpu importer; "
                f"supported: {sorted(_IMPORTERS)}")
        at = _attrs(n)
        # converters receive a Symbol for every input; structural inputs
        # (shapes/axes/pads) are read via ctx.const() instead and their
        # unused placeholder symbols never enter the graph
        ins = [value(nm) if nm else None for nm in n.input]
        out = fn(ctx, n, ins, at)
        if isinstance(out, (list, tuple)):
            outs = list(out)
        elif len(n.output) > 1:
            # multi-entry Symbol (e.g. Split) — but a node may also
            # declare OPTIONAL extra outputs (Dropout mask, MaxPool
            # indices) the converter doesn't produce; leave those
            # unbound so only an actual consumer errors, by name
            n_avail = len(out)
            outs = [out[i] for i in range(min(len(n.output), n_avail))]
        else:
            outs = [out]
        for name, s in zip(n.output, outs):
            if name:
                ctx.values[name] = s

    heads = [ctx.values[vi.name] for vi in g.output]
    sym = sym_mod.Group(heads) if len(heads) > 1 else heads[0]

    # only keep params the final graph actually references
    referenced = set(sym.list_arguments()) | \
        set(sym.list_auxiliary_states())
    arg_params = {k: _param(v, device) for k, v in init_np.items()
                  if k in referenced and k not in aux_names}
    aux_params = {k: _param(v, device) for k, v in init_np.items()
                  if k in referenced and k in aux_names}
    return sym, arg_params, aux_params, input_names
