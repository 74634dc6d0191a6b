"""The op table that ``test_torch_ops.py`` and ``test_torch_ops_nn.py``
run through both packages' ``mx.nd``: for every op that
``mxtpu/ndarray/ops.py`` registers (by its first name; its aliases are
held to the same function), one or more cases of numpy inputs drawn from
``np.random.default_rng``, with the keyword arguments and how to compare.
The inputs follow ``benchmark/opperf/opperf.py``'s choices of which
arrays each op takes, at small shapes.

A case compares:

- every output: shapes and dtype names equal; values exactly for shape,
  selection, integer and comparison results (``exact``), else within
  1e-6 relative or 2 float32 ulps of the output's largest magnitude;
- for differentiable ops (``grad``: the indices of the float inputs),
  the gradients of ``backward`` from a seeded head gradient on the first
  output, with the same tolerance.

``scale`` raises the magnitude the ulps are counted at, for a sum whose
terms cancel: its rounding error scales with the sum of |terms|, not
with the result.

``x64`` marks cases where the reference (x64 on in the tests) returns a
64-bit float or int and the port the 32-bit one: values are compared,
and the port's dtype is checked to be the 32-bit counterpart.
"""
import contextlib

import numpy as np

rng = np.random.default_rng(0)
f32 = np.float32
X = rng.standard_normal((3, 4)).astype(f32)
Y = rng.standard_normal((3, 4)).astype(f32)
ROW = rng.standard_normal((4,)).astype(f32)
P = rng.uniform(0.5, 2.0, (3, 4)).astype(f32)
U = rng.uniform(-0.9, 0.9, (3, 4)).astype(f32)
GT1 = rng.uniform(1.1, 3.0, (3, 4)).astype(f32)
B3 = rng.standard_normal((2, 3, 4)).astype(f32)
B4 = rng.standard_normal((2, 4, 5)).astype(f32)
M = rng.standard_normal((4, 5)).astype(f32)
I = rng.integers(-5, 6, (3, 4)).astype(np.int32)
IP = rng.integers(1, 6, (3, 4)).astype(np.int32)
XZ = np.where(rng.uniform(size=(3, 4)) < 0.3, 0, X).astype(f32)
XN = X.copy()
XN[0, 1], XN[1, 2], XN[2, 0] = np.nan, np.inf, -np.inf
XNAN = X.copy()
XNAN[1, 1] = np.nan
SPD = (M @ M.T + 4 * np.eye(4)).astype(f32)
TRI = (np.tril(rng.standard_normal((4, 4))) + 3 * np.eye(4)).astype(f32)
IMG = rng.standard_normal((2, 3, 6, 6)).astype(f32)
IMG1 = rng.standard_normal((2, 3, 7)).astype(f32)
IMG3 = rng.standard_normal((1, 2, 4, 4, 4)).astype(f32)
TNC = rng.standard_normal((4, 3, 2)).astype(f32)
SEQ_LEN = np.array([2, 4, 1], f32)
IDX = np.array([2, 0, 1, 2], np.int32)
IDX_OOR = np.array([3, -1, 1, 5], np.int32)


class Case:
    def __init__(self, args, kw=None, exact=False, grad=None, train=False,
                 x64=False, seed=None, ctx=False, scale=0.0):
        self.args, self.kw = args, dict(kw or {})
        self.scale = scale
        self.exact, self.train, self.x64 = exact, train, x64
        self.seed, self.ctx = seed, ctx
        if grad is None:
            grad = [] if exact else [
                i for i, a in enumerate(args) if isinstance(a, np.ndarray)
                and a.dtype.kind == "f"]
        self.grad = grad


def C(*args, **kw):
    opts = {k: kw.pop(k) for k in ("exact", "grad", "train", "x64", "seed",
                                   "ctx", "scale") if k in kw}
    return Case(list(args), kw, **opts)


def E(*args, **kw):
    return C(*args, exact=True, **kw)


_UNARY_DOMAIN = {
    "sqrt": P, "rsqrt": P, "log": P, "log10": P, "log2": P, "log1p": P,
    "tan": U, "arcsin": U, "arccos": U, "arctanh": U, "arccosh": GT1,
    "reciprocal": P, "erfinv": U, "gamma": P, "gammaln": P,
}
_UNARY = ("negative abs square sqrt rsqrt cbrt rcbrt exp expm1 log log10 "
          "log2 log1p sin cos tan arcsin arccos arctan sinh cosh tanh "
          "arcsinh arccosh arctanh degrees radians reciprocal erf erfinv "
          "gamma gammaln relu sigmoid softsign zeros_like ones_like identity "
          "stop_gradient make_loss").split()
_ROUNDING = "sign round rint ceil floor trunc fix".split()

CASES = {}
for _n in _UNARY:
    CASES[_n] = [C(_UNARY_DOMAIN.get(_n, X))]
for _n in ("negative", "abs", "square", "zeros_like", "identity"):
    CASES[_n].append(E(I))
for _n in _ROUNDING:
    CASES[_n] = [C(3 * X), E(I, x64=_n == "rint")]
CASES["logical_not"] = [E(XZ), E(I)]
for _n in ("isnan", "isinf", "isfinite"):
    CASES[_n] = [E(XN)]

for _n in ("broadcast_add", "broadcast_sub", "broadcast_mul"):
    CASES[_n] = [C(X, Y), C(X, ROW), C(X, 2.5), E(I, IP)]
CASES["broadcast_div"] = [C(X, P), C(X, ROW.reshape(1, 4) + 3), C(X, 2.5)]
CASES["broadcast_mod"] = [C(X, P), E(I, IP)]
CASES["broadcast_power"] = [C(P, X), C(P, 2.0)]
for _n in ("broadcast_maximum", "broadcast_minimum"):
    CASES[_n] = [C(X, Y), C(X, 0.1), E(I, IP)]
CASES["broadcast_hypot"] = [C(X, Y)]
CASES["arctan2"] = [C(X, Y)]
for _n in ("equal", "not_equal", "greater", "greater_equal", "lesser",
           "lesser_equal"):
    CASES["broadcast_" + _n] = [E(X, Y), E(X, 0.0), E(I, IP)]
for _n in ("logical_and", "logical_or", "logical_xor"):
    CASES["broadcast_" + _n] = [E(XZ, Y), E(XZ, 0.0)]

for _n in ("sum", "mean", "prod", "max", "min"):
    CASES[_n] = [C(B3, axis=1), C(B3, axis=(0, 2), keepdims=True),
                 C(B3, axis=1, exclude=True), C(B3)]
CASES["sum"].append(E(I, axis=1, x64=False))
CASES["prod"].append(E(IP, axis=0))
CASES["max"].append(E(I, axis=1))
CASES["mean"].append(C(I, axis=1, x64=True))
CASES["nansum"] = [C(XNAN, axis=1), C(XNAN, scale=np.nansum(np.abs(XNAN)))]
CASES["nanprod"] = [C(XNAN, axis=1)]
CASES["norm"] = [C(X), C(X, axis=1), C(X, ord=1, axis=1, keepdims=True)]
for _n in ("argmax", "argmin"):
    CASES[_n] = [E(X, axis=1), E(X), E(B3, axis=2, keepdims=True)]
CASES["topk"] = [E(X, k=2), C(X, k=2, ret_typ="value"),
                 C(X, k=3, ret_typ="both", axis=0, grad=[0]),
                 E(X, k=2, is_ascend=True, dtype="int32")]
CASES["sort"] = [C(X), C(X, axis=0, is_ascend=False)]
CASES["argsort"] = [E(X), E(X, axis=0, is_ascend=False, dtype="int32")]

CASES["reshape"] = [C(B3, shape=(4, -1)), C(B3, shape=(0, -1))]
CASES["transpose"] = [C(B3, axes=(2, 0, 1)), C(B3)]
CASES["swapaxes"] = [C(B3, dim1=0, dim2=2)]
CASES["expand_dims"] = [C(X, axis=1)]
CASES["squeeze"] = [C(X.reshape(3, 1, 4), axis=1), C(X.reshape(1, 3, 1, 4))]
CASES["flatten"] = [C(B3)]
CASES["broadcast_to"] = [C(ROW.reshape(1, 4), shape=(3, 4)),
                         C(ROW.reshape(1, 4), shape=(3, 0))]
CASES["broadcast_axis"] = [C(X[:, :1].copy(), axis=1, size=4)]
CASES["slice"] = [C(B3, begin=(0, 1, None), end=(2, 3, None)),
                  C(B3, begin=(None, 2, None), end=(None, 0, None),
                    step=(None, -1, 2))]
CASES["slice_axis"] = [C(X, axis=1, begin=1, end=3),
                       C(X, axis=0, begin=1, end=None)]
CASES["slice_like"] = [C(B3, X[:2, :3].copy(), axes=(0, 1), grad=[0]),
                       C(X, X[:2, :2].copy(), grad=[0])]
CASES["concat"] = [C(X, Y, dim=0), C(X, Y, P)]
CASES["stack"] = [C(X, Y, axis=1)]
CASES["split"] = [C(B3, num_outputs=2, axis=0),
                  C(B3, num_outputs=3, axis=1, squeeze_axis=True)]
CASES["tile"] = [C(X, reps=(2, 1)), C(ROW, reps=3)]
CASES["repeat"] = [C(X, repeats=2, axis=1), C(X, repeats=2)]
CASES["flip"] = [C(X, axis=1), C(B3, axis=(0, 2))]
_IMG4 = IMG[:1, :1, :3, :4].copy()
CASES["pad"] = [C(_IMG4, mode="constant", pad_width=(0, 0, 0, 0, 1, 2, 2, 1),
                  constant_value=0.5),
                C(_IMG4, mode="edge", pad_width=(0, 0, 0, 0, 2, 1, 1, 3)),
                C(_IMG4, mode="reflect", pad_width=(0, 0, 0, 0, 2, 1, 1, 3))]
CASES["clip"] = [C(X, a_min=-0.5, a_max=0.5)]
CASES["cast"] = [E(X * 3, dtype="int32"), C(I, dtype="float32", grad=[]),
                 C(X, dtype="float16", grad=[])]
CASES["shape_array"] = [E(B3)]
CASES["size_array"] = [E(B3)]
CASES["diag"] = [C(X), C(ROW), C(X, k=1), C(B3)]
CASES["where"] = [C((X > 0).astype(f32), X, Y, grad=[1, 2])]

CASES["dot"] = [C(X, M), C(ROW, ROW), C(M, X, transpose_a=True,
                                         transpose_b=True),
                C(B3, M)]
CASES["batch_dot"] = [C(B3, B4), C(B3, B3, transpose_b=True)]
CASES["linalg_gemm2"] = [C(X, M, alpha=0.5), C(B3, B3, transpose_a=True)]
CASES["linalg_potrf"] = [C(SPD)]
CASES["linalg_syrk"] = [C(X, alpha=2.0), C(X, transpose=True)]
CASES["linalg_trsm"] = [C(TRI, M, grad=[1]),
                        C(TRI, M.T.copy(), rightside=True, grad=[1]),
                        C(TRI, M, transpose=True, alpha=2.0, grad=[1])]

CASES["take"] = [C(X, IDX, grad=[0]), C(X, IDX_OOR, grad=[0]),
                 C(X, IDX_OOR, axis=1, mode="wrap", grad=[0])]
CASES["pick"] = [C(X, np.array([0, 3, 1], f32), grad=[0]),
                 C(X, np.array([1, 0, 2, 2], f32), axis=0, keepdims=True,
                   grad=[0])]
CASES["gather_nd"] = [C(X, np.array([[0, 2, 1], [3, 0, 3]], np.int32),
                        grad=[0])]
CASES["scatter_nd"] = [C(np.array([1.5, -2.0, 3.0], f32),
                         np.array([[0, 2, 0], [3, 0, 3]], np.int32),
                         shape=(3, 4), grad=[0])]
CASES["one_hot"] = [C(IDX, depth=4), C(IDX_OOR, depth=4, on_value=2.0,
                                       off_value=-1.0)]
CASES["Embedding"] = [C(np.array([[0, 4, 1], [2, 2, 3]], f32), M.T.copy(),
                        input_dim=5, output_dim=4, grad=[1])]
CASES["sequence_mask"] = [
    C(TNC, SEQ_LEN, use_sequence_length=True, value=-1.0, grad=[0]),
    C(TNC, grad=[])]
CASES["sequence_last"] = [C(TNC, SEQ_LEN, use_sequence_length=True,
                            grad=[0]), C(TNC)]
CASES["sequence_reverse"] = [C(TNC, SEQ_LEN, use_sequence_length=True,
                               grad=[0]), C(TNC)]

_W5 = rng.standard_normal((5, 4)).astype(f32)
_B5 = rng.standard_normal((5,)).astype(f32)
CASES["FullyConnected"] = [C(B3.reshape(3, 2, 4)[:, :, :2].copy(), _W5,
                             _B5, num_hidden=5),
                           C(X, _W5, None, num_hidden=5, no_bias=True,
                             flatten=False),
                           C(B3, _W5, _B5, num_hidden=5, flatten=False)]
CASES["Activation"] = [C(X, act_type=a) for a in
                       ("relu", "sigmoid", "tanh", "softrelu", "softsign")]
CASES["LeakyReLU"] = [C(X, act_type="leaky", slope=0.1),
                      C(X, act_type="elu", slope=0.7),
                      C(X, act_type="selu"), C(X, act_type="gelu"),
                      C(X, ROW, act_type="prelu")]
CASES["softmax"] = [C(X), C(X, axis=0, temperature=2.0)]
CASES["log_softmax"] = [C(X), C(X, axis=0, temperature=0.5)]
CASES["softmin"] = [C(X, axis=1)]
_LAB = np.array([0, 3, 1], f32)
CASES["SoftmaxOutput"] = [
    C(X, _LAB, grad=[0]), C(X, _LAB, normalization="batch", grad=[0],
                           grad_scale=2.0),
    C(X, np.array([0, -1, 1], f32), use_ignore=True, normalization="valid",
      grad=[0]),
    C(B3, np.array([[0, 2, 1, 1], [2, 2, 0, 1]], f32), multi_output=True,
      grad=[0]),
    C(X)]
_CW = rng.standard_normal((4, 3, 3, 3)).astype(f32)
_CB = rng.standard_normal((4,)).astype(f32)
CASES["Convolution"] = [
    C(IMG, _CW, _CB, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
      num_filter=4),
    C(IMG, rng.standard_normal((6, 1, 3, 3)).astype(f32), None,
      kernel=(3, 3), dilate=(2, 2), num_filter=6, num_group=3,
      no_bias=True),
    C(IMG1, rng.standard_normal((4, 3, 3)).astype(f32), _CB, kernel=(3,),
      pad=(1,), num_filter=4),
    C(IMG3, rng.standard_normal((3, 2, 2, 2, 2)).astype(f32), None,
      kernel=(2, 2, 2), stride=(2, 2, 2), num_filter=3, no_bias=True)]
CASES["Deconvolution"] = [
    C(IMG, rng.standard_normal((3, 4, 3, 3)).astype(f32), None,
      kernel=(3, 3), stride=(2, 2), pad=(1, 1), adj=(1, 1), num_filter=4),
    C(IMG, rng.standard_normal((3, 2, 3, 3)).astype(f32), _CB[:2].copy(),
      kernel=(3, 3), num_filter=2, no_bias=False),
    C(IMG, rng.standard_normal((3, 2, 2, 2)).astype(f32), None,
      kernel=(2, 2), stride=(2, 2), num_filter=6, num_group=3)]
CASES["Pooling"] = [
    C(IMG, kernel=(3, 3), stride=(2, 2), pad=(1, 1)),
    C(IMG, kernel=(2, 2), pool_type="avg"),
    C(IMG, kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
      count_include_pad=False),
    C(IMG, kernel=(3, 3), stride=(2, 2), pool_type="max",
      pooling_convention="full"),
    C(IMG, kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="sum",
      pooling_convention="full"),
    C(IMG, global_pool=True, pool_type="avg"),
    C(IMG, global_pool=True, pool_type="max"),
    C(IMG1, kernel=(2,), stride=(1,), pool_type="avg")]
_G3 = rng.uniform(0.5, 1.5, (3,)).astype(f32)
_BE3 = rng.standard_normal((3,)).astype(f32)
_MM3 = rng.standard_normal((3,)).astype(f32)
_MV3 = rng.uniform(0.5, 1.5, (3,)).astype(f32)
CASES["BatchNorm"] = [
    C(IMG, _G3, _BE3, _MM3, _MV3, grad=[0, 1, 2]),
    C(IMG, _G3, _BE3, _MM3, _MV3, train=True, grad=[0, 1, 2]),
    C(IMG, _G3, _BE3, _MM3, _MV3, fix_gamma=True, eps=1e-3, grad=[0, 2]),
    C(B3, ROW, ROW, ROW, ROW * ROW + 1, axis=-1, train=True,
      grad=[0, 1, 2])]
CASES["LayerNorm"] = [C(B3, ROW, ROW * 2), C(B3, _G3, _BE3, axis=1)]
CASES["InstanceNorm"] = [C(IMG, _G3, _BE3)]
CASES["L2Normalization"] = [C(IMG), C(IMG, mode="channel"),
                            C(IMG, mode="spatial")]
CASES["Dropout"] = [C(X, p=0.5, train=True, seed=7),
                    C(B3, p=0.3, axes=(1,), train=True, seed=3),
                    C(X, p=0.5)]
CASES["where_v2"] = [C((X > 0).astype(f32), X, Y, grad=[1, 2])]
CASES["smooth_l1"] = [C(X * 2), C(X, scalar=2.0)]
CASES["softmax_cross_entropy"] = [C(X, _LAB, grad=[0])]
_CTC_X = rng.standard_normal((6, 2, 5)).astype(f32)
CASES["ctc_loss"] = [
    C(_CTC_X, np.array([[1, 2, 2], [3, 0, 0]], f32), grad=[0]),
    C(_CTC_X, np.array([[1, 2, 0], [4, 4, 1]], f32),
      np.array([6, 4], f32), np.array([2, 3], f32), grad=[0]),
    C(_CTC_X, np.zeros((2, 2), f32), grad=[0])]
for _n, _s in (("_plus_scalar", 2.5), ("_minus_scalar", 2.5),
               ("_rminus_scalar", 2.5), ("_mul_scalar", -1.5),
               ("_div_scalar", 3.0), ("_rdiv_scalar", 3.0),
               ("_maximum_scalar", 0.2), ("_minimum_scalar", 0.2),
               ("_hypot_scalar", 1.5)):
    CASES[_n] = [C(X, scalar=_s)]
CASES["_mod_scalar"] = [C(X, scalar=0.7), E(I, scalar=3)]
CASES["_rmod_scalar"] = [C(P, scalar=2.5)]
CASES["_power_scalar"] = [C(P, scalar=1.5)]
CASES["_rpower_scalar"] = [C(X, scalar=1.5)]
for _n in ("_equal_scalar", "_not_equal_scalar", "_greater_scalar",
           "_greater_equal_scalar", "_lesser_scalar",
           "_lesser_equal_scalar"):
    CASES[_n] = [E(X, scalar=0.0), E(I, scalar=1)]
CASES["add_n"] = [C(X, Y, P), C(X)]
CASES["cumsum"] = [C(X, axis=1), C(X), E(I, axis=0, dtype="int64"),
                   C(X, axis=0, dtype="float64", grad=[], x64=False)]
CASES["full"] = [E((2, 3), 1.5, ctx=True), E((4,), 7, dtype="int32",
                                              ctx=True)]
CASES["_rnn_init_state"] = [E(TNC, num_states=2, state_size=5)]


def _rnn_case(mode, layers, bidir, outputs):
    gates = {"lstm": 4, "gru": 3, "rnn_tanh": 1, "rnn_relu": 1}[mode]
    h, c, d = 3, TNC.shape[-1], 2 if bidir else 1
    n = 0
    for layer in range(layers):
        isz = c if layer == 0 else h * d
        n += d * (gates * h * isz + gates * h * h + 2 * gates * h)
    params = (0.3 * rng.standard_normal((n,))).astype(f32)
    h0 = rng.standard_normal((layers * d, TNC.shape[1], h)).astype(f32)
    args = [TNC, params, h0]
    if mode == "lstm":
        args.append(rng.standard_normal(h0.shape).astype(f32))
    return C(*args, state_size=h, num_layers=layers, mode=mode,
             bidirectional=bidir, state_outputs=outputs)


CASES["RNN"] = [_rnn_case("lstm", 2, False, True),
                _rnn_case("gru", 1, True, False),
                _rnn_case("rnn_tanh", 2, True, True),
                _rnn_case("rnn_relu", 1, False, False)]

# the reference's ops.py names, each with its aliases (the first name of
# each group is the key of CASES)
GROUPS = [
    ["identity", "copy"], ["stop_gradient", "BlockGrad"],
    ["make_loss", "MakeLoss"],
    ["broadcast_add", "elemwise_add", "add"],
    ["broadcast_sub", "elemwise_sub", "subtract", "broadcast_minus"],
    ["broadcast_mul", "elemwise_mul", "multiply"],
    ["broadcast_div", "elemwise_div", "divide"],
    ["broadcast_mod", "modulo"], ["broadcast_power", "power"],
    ["broadcast_maximum", "maximum"], ["broadcast_minimum", "minimum"],
    ["broadcast_hypot", "hypot"], ["broadcast_equal", "equal"],
    ["broadcast_not_equal", "not_equal"], ["broadcast_greater", "greater"],
    ["broadcast_greater_equal", "greater_equal"],
    ["broadcast_lesser", "lesser"],
    ["broadcast_lesser_equal", "lesser_equal"],
    ["broadcast_logical_and", "logical_and"],
    ["broadcast_logical_or", "logical_or"],
    ["broadcast_logical_xor", "logical_xor"], ["sum", "sum_axis"],
    ["max", "max_axis"], ["min", "min_axis"], ["reshape", "Reshape"],
    ["swapaxes", "SwapAxis"], ["flatten", "Flatten"],
    ["broadcast_axis", "broadcast_axes"], ["concat", "Concat"],
    ["split", "SliceChannel"], ["flip", "reverse"], ["pad", "Pad"],
    ["cast", "Cast", "amp_cast"], ["Embedding", "embedding"],
    ["sequence_mask", "SequenceMask"], ["sequence_last", "SequenceLast"],
    ["sequence_reverse", "SequenceReverse"],
    ["FullyConnected", "fully_connected"], ["Activation", "activation"],
    ["SoftmaxOutput", "softmax_output"], ["Convolution", "convolution"],
    ["Deconvolution", "deconvolution"], ["Pooling", "pooling"],
    ["BatchNorm", "batch_norm"], ["LayerNorm", "layer_norm"],
    ["Dropout", "dropout"], ["ctc_loss", "CTCLoss"],
    ["add_n", "ElementWiseSum"],
]
ALIASES = {a: g[0] for g in GROUPS for a in g[1:]}

# ops.py's names in registration order: CASES keys before NN_FROM go to
# test_torch_ops.py, the recurrences (SEQ) to test_torch_ops_rnn.py, the
# rest (nn, linalg, indexing) to test_torch_ops_nn.py
NN_FROM = "dot"
SEQ = ("ctc_loss", "RNN")


def case_ids(cases):
    return list(range(len(cases)))


def _ulp_tol(want, scale=0.0):
    finite = np.abs(want[np.isfinite(want)]) if want.size else want
    top = float(finite.max()) if finite.size else 0.0
    return 2 * float(np.spacing(np.float32(max(top, scale))))


def assert_close(got, want, exact, what, scale=0.0):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if exact or got.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=_ulp_tol(want, scale), err_msg=what)


class Side:
    """One package's way of running a case."""

    def __init__(self, mx, ctx):
        self.mx, self.ctx = mx, ctx

    def run(self, op, case):
        mx = self.mx
        if case.seed is not None:
            mx.random.seed(case.seed)
        args = [mx.nd.array(a, ctx=self.ctx, dtype=a.dtype.name)
                if isinstance(a, np.ndarray) else a for a in case.args]
        kw = dict(case.kw)
        if case.ctx:
            kw["ctx"] = self.ctx
        for i in case.grad:
            args[i].attach_grad()
        fn = mx.nd.OP_REGISTRY[op]
        if case.grad:
            scope = mx.autograd.record(train_mode=case.train)
        elif case.train:
            scope = mx.autograd.train_mode()
        else:
            scope = contextlib.nullcontext()
        with scope:
            out = fn(*args, **kw)
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        grads = []
        if case.grad:
            head = np.random.default_rng(1).standard_normal(
                outs[0].shape).astype(np.float32)
            outs[0].backward(mx.nd.array(head, ctx=self.ctx))
            grads = [args[i].grad for i in case.grad]
        return outs, grads
