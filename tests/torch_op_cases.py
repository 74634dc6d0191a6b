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

The random ops' cases are exact: after one ``mx.random.seed`` both
packages draw the same bits (the reference's draws in 64-bit mode); so
are the optimizer update ops' (outputs and rebound states): the port
takes a correctly rounded sqrt and divides elementwise, as XLA does.

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
                 x64=False, seed=None, ctx=False, scale=0.0, mutates=()):
        self.args, self.kw = args, dict(kw or {})
        self.mutates = tuple(mutates)
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
                                   "ctx", "scale", "mutates") if k in kw}
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

# -- the rest of the op set (ops_extended, Custom, contrib.quantization) --
# EXT_FROM's half goes to test_torch_ops.py, the rest from EXT_NN_FROM to
# test_torch_ops_nn.py; ``mutates`` also compares the state arrays an op
# rebinds, after the call
EXT_FROM = "digamma"
EXT_NN_FROM = "linalg_gemm"
_G4 = rng.standard_normal((2, 4, 3, 3)).astype(f32)
_THETA = np.array([[0.9, 0.1, 0.05, -0.2, 1.1, 0.1],
                   [1.2, -0.3, 0.2, 0.25, 0.8, -0.1]], f32)
_FLOW = rng.standard_normal((2, 2, 4, 5)).astype(f32)
_GRID = rng.uniform(-1.1, 1.1, (2, 2, 5, 4)).astype(f32)
_IMG2 = rng.standard_normal((2, 3, 6, 6)).astype(f32)
_OFF = (0.7 * rng.standard_normal((2, 18, 6, 6))).astype(f32)
_OFF3 = (0.7 * rng.standard_normal((2, 54, 3, 3))).astype(f32)
_LOWER = np.linalg.cholesky(SPD.astype(np.float64)).astype(f32)
_MASK = np.array([[1, 0, 1, 1], [0, 1, 1, 0], [1, 1, 0, 1]], np.int32)
_STATE = rng.uniform(0.1, 1.0, (3, 4)).astype(f32)
_PROBS = np.array([[0.1, 0.2, 0.3, 0.4], [0.5, 0.0, 0.25, 0.25]], f32)
_QW = rng.integers(-127, 128, (5, 4)).astype(np.int8)
_QCW = rng.integers(-127, 128, (4, 3, 3, 3)).astype(np.int8)
_QGW = rng.integers(-127, 128, (6, 1, 3, 3)).astype(np.int8)

for _n in ("digamma", "log_sigmoid", "mish", "gelu", "selu", "softrelu",
           "erfc"):
    CASES[_n] = [C(P if _n == "digamma" else X)]
CASES["digamma"].append(C(np.abs(X) + 0.5))
CASES["erfc"].append(C(np.array([3.0, 4.0, 5.0, 6.0], f32)))   # the tail
CASES["gelu"].append(C(4 * X))
CASES["elu"] = [C(X), C(X, alpha=0.5)]
CASES["hard_sigmoid"] = [C(3 * X), C(X, alpha=0.3, beta=0.4)]
CASES["SoftmaxActivation"] = [C(X), C(IMG, mode="channel")]
CASES["LRN"] = [C(IMG), C(IMG, alpha=1e-2, beta=0.5, knorm=1.0, nsize=3)]
CASES["GroupNorm"] = [C(_G4, _G3[:2].repeat(2), _BE3[:2].repeat(2),
                        num_groups=2), C(IMG, _G3, _BE3, num_groups=3)]
CASES["UpSampling"] = [
    C(IMG, scale=2), C(IMG, scale=2, sample_type="bilinear", num_filter=3),
    C(IMG, IMG[:, :, :3, :3].copy(), scale=2, num_args=2),
    C(IMG, IMG[:, :, :4, :4].copy(), scale=1, num_args=2,
      multi_input_mode="sum")]
CASES["BilinearResize2D"] = [C(IMG, height=9, width=8),
                             C(IMG, scale_height=0.5, scale_width=0.5)]
CASES["Crop"] = [C(IMG, h_w=(3, 4), offset=(1, 2)),
                 C(IMG, h_w=(4, 4), center_crop=True),
                 C(IMG, IMG[:, :, :3, :5].copy(), num_args=2, grad=[0])]
CASES["GridGenerator"] = [C(_THETA, target_shape=(4, 5), x64=True, grad=[]),
                          C(_FLOW, transform_type="warp",
                            target_shape=(4, 5))]
CASES["BilinearSampler"] = [C(IMG, _GRID)]
CASES["SpatialTransformer"] = [C(IMG, _THETA, target_shape=(5, 4))]
CASES["DeformableConvolution"] = [
    C(IMG, _OFF, _CW, _CB, kernel=(3, 3), pad=(1, 1), num_filter=4),
    C(IMG, _OFF3, _QGW.astype(f32) / 64, None, kernel=(3, 3),
      stride=(2, 2), pad=(1, 1), num_filter=6, num_group=3,
      num_deformable_group=3, no_bias=True)]
CASES["Correlation"] = [
    C(IMG, _IMG2, max_displacement=2, pad_size=2),
    C(IMG, _IMG2, kernel_size=3, max_displacement=2, stride1=2, stride2=2,
      pad_size=3),
    C(IMG, _IMG2, max_displacement=1, is_multiply=False, pad_size=1)]
CASES["SVMOutput"] = [C(X, _LAB, grad=[0]),
                      C(X, _LAB, use_linear=True, margin=0.5,
                        regularization_coefficient=2.0, grad=[0]), C(X)]
CASES["linalg_gemm"] = [C(X, M, X @ M, alpha=0.5, beta=2.0),
                        C(X, X, SPD, transpose_a=True),
                        C(B3, B3, B3[:, :, :3] @ B3[:, :, :3].transpose(
                            0, 2, 1), transpose_b=True, scale=8.0)]
CASES["linalg_trmm"] = [C(TRI, M), C(TRI, M.T.copy(), rightside=True,
                                     lower=False, transpose=True,
                                     alpha=2.0)]
CASES["linalg_potri"] = [C(_LOWER)]
CASES["linalg_sumlogdiag"] = [C(SPD)]
CASES["linalg_extractdiag"] = [C(X), C(SPD, offset=1), C(B3, offset=-1)]
CASES["linalg_makediag"] = [C(ROW), C(ROW, offset=-1), C(X, offset=2)]
CASES["linalg_extracttrian"] = [C(SPD), C(SPD, offset=1, lower=False),
                                C(SPD, offset=-1)]
CASES["linalg_maketrian"] = [C(ROW[:3].copy()), C(X.reshape(2, 6),
                                                  offset=1, lower=False)]
CASES["linalg_syevd"] = [C(SPD, grad=[], scale=4.0)]
CASES["linalg_det"] = [C(SPD), C(np.stack([SPD, TRI]))]
CASES["linalg_slogdet"] = [C(TRI)]
CASES["linalg_inverse"] = [C(SPD), C(TRI)]
CASES["linalg_gelqf"] = [C(X, grad=[])]
CASES["histogram"] = [C(X, bins=5, range=(-2.0, 2.0), grad=[]),
                      C(X, bins=4, grad=[]),
                      C(X, np.array([-2, -0.5, 0, 0.5, 2], f32), grad=[])]
CASES["khatri_rao"] = [C(X, Y[:2].copy())]
CASES["batch_take"] = [C(X, np.array([0, 3, 1], np.int32))]
CASES["argmax_channel"] = [E(IMG), E(X)]
CASES["broadcast_like"] = [C(ROW.reshape(1, 4), X, grad=[0]),
                           C(X[:, :1].copy(), X, lhs_axes=(1,),
                             rhs_axes=(1,), grad=[0])]
CASES["unravel_index"] = [E(np.array([0, 5, 11, 7], f32), shape=(3, 4)),
                          E(np.array([3, 14, -3], np.int32), shape=(3, 4))]
CASES["ravel_multi_index"] = [E(np.array([[0, 2, 1, 5], [3, 0, 1, -1]], f32),
                                shape=(3, 4))]
CASES["index_add"] = [C(X, np.array([0, 2, 0], np.int32), Y, grad=[0, 2])]
CASES["moments"] = [C(B3, axes=(1,)), C(B3, axes=(0, 2), keepdims=True),
                    C(X, scale=1.0)]
CASES["roll"] = [C(X, shift=1, axis=1), C(B3, shift=(1, -2), axis=(0, 2)),
                 C(X, shift=2)]
CASES["rot90"] = [C(X), C(B3, k=2, axes=(1, 2)), C(X, k=-1)]
CASES["ediff1d"] = [C(X)]
CASES["searchsorted"] = [E(np.sort(ROW), X), E(np.sort(ROW), X,
                                               side="right")]
CASES["index_array"] = [E(B3, x64=True), E(B3, axes=(0, 2), x64=True)]
CASES["trace"] = [C(SPD), C(B3, offset=1, axis1=1, axis2=2)]
CASES["unique"] = [E(np.array([3, 1, 3, 2, 1], f32)), E(I)]
CASES["scatter_set_nd"] = [C(np.zeros((3, 4), f32), np.array([5, 6], f32),
                             np.array([[0, 1], [1, 2]], np.int32))]
CASES["fill_element_0index"] = [C(X, np.array([9, 8, 7], f32),
                                  np.array([0, 2, 3], f32), grad=[0, 1])]
CASES["cast_storage"] = [C(X, stype="default", grad=[])]
CASES["IdentityAttachKLSparseReg"] = [C(X)]
CASES["random_uniform"] = [E(low=-1.0, high=2.0, shape=(3, 4), ctx=True,
                             seed=5)]
CASES["random_normal"] = [E(loc=1.0, scale=2.0, shape=(3, 4), ctx=True,
                            seed=5)]
CASES["random_gamma"] = [E(alpha=2.0, beta=1.5, shape=(5,), ctx=True,
                           seed=5)]
CASES["random_exponential"] = [E(lam=2.0, shape=(5,), ctx=True, seed=5)]
CASES["random_poisson"] = [E(lam=3.0, shape=(6,), ctx=True, seed=5)]
CASES["sample_uniform"] = [E(ROW[:2].copy(), ROW[:2] + 2, shape=3, seed=5)]
CASES["sample_normal"] = [E(ROW[:2].copy(), P[0, :2].copy(), shape=(2, 3),
                            seed=5)]
CASES["sample_gamma"] = [E(P[0, :3].copy(), P[1, :3].copy(), shape=4,
                           seed=5)]
CASES["sample_exponential"] = [E(P[0, :3].copy(), shape=4, seed=5)]
CASES["sample_poisson"] = [E(3 * P[0, :3], shape=4, seed=5)]
CASES["sample_multinomial"] = [E(_PROBS, shape=3, seed=5),
                               E(_PROBS[0].copy(), shape=(2,),
                                 get_prob=True, seed=5)]
CASES["shuffle"] = [E(X, seed=5)]
CASES["sgd_update"] = [E(X, Y, lr=0.1, wd=0.01, grad=[0, 1]),
                       E(X, 10 * Y, lr=0.1, rescale_grad=0.5,
                         clip_gradient=1.0, grad=[0, 1])]
for _n in ("sgd_mom_update", "nag_mom_update"):
    CASES[_n] = [E(X, Y, _STATE - 0.5, lr=0.1, momentum=0.9, wd=0.01,
                   mutates=[2], grad=[0])]
CASES["adam_update"] = [E(X, Y, _STATE - 0.5, _STATE, lr=0.01, wd=0.01,
                          mutates=[2, 3], grad=[0]),
                        E(X, 10 * Y, _STATE - 0.5, _STATE, lr=0.01,
                          clip_gradient=2.0, mutates=[2, 3], grad=[0])]
CASES["adamw_update"] = [E(X, Y, _STATE - 0.5, _STATE, lr=0.01, wd=0.1,
                           eta=0.5, mutates=[2, 3], grad=[0])]
CASES["signsgd_update"] = [E(X, Y, lr=0.1, wd=0.01, grad=[0, 1])]
CASES["rmsprop_update"] = [E(X, Y, _STATE, lr=0.01, wd=0.01, mutates=[2],
                             grad=[0])]
CASES["ftrl_update"] = [E(X, Y, _STATE - 0.5, _STATE, lr=0.1, lamda1=0.3,
                          mutates=[2, 3], grad=[0])]
CASES["mp_sgd_update"] = [E(X.astype(np.float16), Y.astype(np.float16), X,
                            lr=0.1, wd=0.01, mutates=[2], grad=[])]
CASES["all_finite"] = [E(X), E(XN)]
CASES["multi_all_finite"] = [E(X, Y, num_arrays=2),
                             E(X, XN, num_arrays=2)]
CASES["im2col"] = [C(IMG, kernel=(3, 3), pad=(1, 1)),
                   C(IMG, kernel=(2, 3), stride=(2, 1), dilate=(1, 2))]
CASES["col2im"] = [C(rng.standard_normal((2, 27, 36)).astype(f32),
                     output_size=(6, 6), kernel=(3, 3), pad=(1, 1))]
for _n in ("masked_softmax", "masked_log_softmax"):
    CASES[_n] = [C(X, _MASK), C(X), C(X, _MASK, axis=0, temperature=2.0)]
CASES["Custom"] = [C(X, op_type="op_cases_scaled_square", scale=3.0)]
CASES["_contrib_quantize_v2"] = [E(X), E(X, min_calib_range=-1.0,
                                        max_calib_range=1.5)]
CASES["_contrib_dequantize"] = [E(_QW, np.array(-1.5, f32),
                                  np.array(0.5, f32))]
CASES["_contrib_quantized_fully_connected"] = [
    E(X, _QW, _B5, num_hidden=5, w_thr=0.8),
    E(2 * X, _QW, None, num_hidden=5, no_bias=True, w_thr=0.8,
      calib_min=-1.0, calib_max=1.0)]
CASES["_contrib_quantized_conv"] = [
    E(IMG, _QCW, _CB, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
      num_filter=4, w_thr=0.5),
    E(IMG, _QGW, None, kernel=(3, 3), num_filter=6, num_group=3,
      no_bias=True, w_thr=0.5, calib_min=-2.0, calib_max=2.0),
    E(IMG1, _QCW[:, :, 1], _CB, kernel=(3,), pad=(1,), num_filter=4,
      w_thr=0.5)]


def register_custom(mx):
    """Register the ``Custom`` case's op (``scale · x²``, numpy on the
    host, as MXNet's custom-op examples are written) in ``mx``."""
    class ScaledSquare(mx.operator.CustomOp):
        def __init__(self, scale):
            self.scale = scale

        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            self.assign(out_data[0], req[0], self.scale * x * x)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            x = in_data[0].asnumpy()
            g = out_grad[0].asnumpy()
            self.assign(in_grad[0], req[0], 2.0 * self.scale * x * g)

    @mx.operator.register("op_cases_scaled_square")
    class ScaledSquareProp(mx.operator.CustomOpProp):
        def __init__(self, scale="1.0"):
            super().__init__(need_top_grad=True)
            self.scale = float(scale)

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return ScaledSquare(self.scale)


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
    ["gelu", "GELU"], ["softrelu", "softplus"],
    ["SoftmaxActivation", "softmax_activation"], ["LRN", "lrn"],
    ["GroupNorm", "groupnorm"], ["UpSampling", "upsampling"],
    ["BilinearResize2D", "_contrib_BilinearResize2D", "bilinear_resize2d"],
    ["Crop", "crop"],
    ["DeformableConvolution", "_contrib_DeformableConvolution"],
    ["SVMOutput", "svm_output"], ["linalg_det", "det"],
    ["linalg_slogdet", "slogdet"], ["linalg_inverse", "inverse"],
    ["index_add", "_contrib_index_add"],
    ["random_uniform", "_random_uniform"],
    ["random_normal", "_random_normal"], ["random_gamma", "_random_gamma"],
    ["random_exponential", "_random_exponential"],
    ["random_poisson", "_random_poisson"],
    ["sample_multinomial", "_sample_multinomial"], ["shuffle", "_shuffle"],
    ["adamw_update", "_adamw_update"], ["scatter_set_nd", "_scatter_set_nd"],
    ["_contrib_quantize_v2", "quantize_v2"],
    ["_contrib_dequantize", "dequantize"],
    ["Convolution", "Convolution_v1"], ["Pooling", "Pooling_v1"],
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
        outs += [args[i] for i in case.mutates]
        grads = []
        if case.grad:
            head = np.random.default_rng(1).standard_normal(
                outs[0].shape).astype(np.float32)
            outs[0].backward(mx.nd.array(head, ctx=self.ctx))
            grads = [args[i].grad for i in case.grad]
        return outs, grads
