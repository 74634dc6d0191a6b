"""The case table of ``mx.np``: one case per callable ``jax.numpy``
serves (and ``linalg.*``, ``fft.*``), run through the reference's
``mxtpu.numpy`` and the port's ``mxtpu_torch.numpy`` on the same numpy
inputs (made from ``np.random.default_rng``), and the comparison.

A case is ``(args, kwargs)`` and options. numpy arrays anywhere in the
arguments become each package's arrays (``Host(x)`` passes ``x`` as
host data instead); Python values pass as they are. The reference runs
jax in 64-bit mode, so where a result's dtype comes from a Python value
or an integer input (``x64``), its float64 is the port's float32 and
the values are compared at float32's bound. Otherwise float64 values
agree within ``rtol`` (1e-12 where both compute the same formula;
looser, stated bounds where the algorithms differ), and a case marked
``check`` is held by a function of both results (invariants, for
eigenvectors and other results defined up to a sign or an order).
Where the reference raises, the port raises the same exception type.
"""
from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import torch

import mxtpu as jmx
import mxtpu_torch as tmx
from mxtpu_torch.base import dtype_name

RNG = np.random.default_rng(23)


class Host:
    """An argument passed to both packages as host data."""

    def __init__(self, v):
        self.v = v


def F(*shape):
    return RNG.standard_normal(shape)


def P(*shape):          # in (0.1, 0.9): logs, arcsin, ...
    return RNG.random(shape) * 0.8 + 0.1


def I(*shape, lo=-5, hi=6, dtype=np.int32):
    return RNG.integers(lo, hi, shape).astype(dtype)


def B(*shape):
    return RNG.random(shape) > 0.5


def SPD(n):
    a = RNG.standard_normal((n, n))
    return a @ a.T + n * np.eye(n)


def SQ(n):
    return RNG.standard_normal((n, n)) + n * np.eye(n)


class Case:
    def __init__(self, args=(), kwargs=None, rtol=1e-12, x64=False,
                 check=None, exact=False):
        self.args, self.kwargs = args, kwargs or {}
        self.rtol, self.x64, self.check, self.exact = rtol, x64, check, \
            exact


def C(*args, **kwargs):
    return Case(args, kwargs)


def X(*args, **kwargs):          # a result dtype from a Python value
    c = Case(args, kwargs)
    c.x64 = True
    return c


def T(rtol, *args, **kwargs):    # a stated bound
    return Case(args, kwargs, rtol=rtol)


def K(check, *args, **kwargs):   # held by invariants
    return Case(args, kwargs, check=check)


def _sorted_complex(v):
    v = np.asarray(v).reshape(-1)
    return v[np.lexsort((np.round(v.imag, 8), np.round(v.real, 8)))]


def same_eigvals(ref, got, args):
    np.testing.assert_allclose(_sorted_complex(got), _sorted_complex(ref),
                               rtol=1e-10, atol=1e-10)


def eig_pairs(ref, got, args):
    a = np.asarray(args[0])
    w, v = (np.asarray(x) for x in got)
    np.testing.assert_allclose(a @ v, v * w[None, :], rtol=1e-9, atol=1e-9)
    same_eigvals(ref[0], w, args)


def eigh_pairs(ref, got, args):
    a = np.asarray(args[0])
    w, v = (np.asarray(x) for x in got)
    np.testing.assert_allclose(w, np.asarray(ref[0]), rtol=1e-10)
    np.testing.assert_allclose(a @ v, v * w[None, :], rtol=1e-9, atol=1e-9)


def qr_product(ref, got, args):
    q, r = (np.asarray(x) for x in got)
    np.testing.assert_allclose(q @ r, np.asarray(args[0]), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(q.T @ q, np.eye(q.shape[1]), atol=1e-10)
    np.testing.assert_allclose(np.abs(r), np.abs(np.asarray(ref[1])),
                               rtol=1e-9, atol=1e-10)


def svd_product(ref, got, args):
    u, s, vh = (np.asarray(x) for x in got)
    np.testing.assert_allclose(s, np.asarray(ref[1]), rtol=1e-10)
    k = s.shape[-1]
    np.testing.assert_allclose((u[:, :k] * s) @ vh[:k], np.asarray(args[0]),
                               rtol=1e-9, atol=1e-9)


def lstsq_solution(ref, got, args):
    for k in (0, 2, 3):
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(ref[k]),
                                   rtol=1e-9, atol=1e-10)


def repr_body(ref, got, args):
    """jax prints its own class name (and indents by it); the array's
    text is numpy's."""
    def body(r):
        return "".join(r[r.index("("):].split())
    assert body(got) == body(ref)


def path_only(ref, got, args):
    assert [tuple(p) for p in got[0][1:]] == [tuple(p) for p in ref[0]]


def as_set(ref, got, args):
    np.testing.assert_allclose(_sorted_complex(got), _sorted_complex(ref),
                               rtol=1e-9, atol=1e-9)


def partition_holds(ref, got, args):
    a, kth = np.asarray(args[0]), args[1]
    got = np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert got[..., kth].tolist() == np.sort(a, -1)[..., kth].tolist()


A34, A45, V8, P34 = F(3, 4), F(4, 5), F(8), P(3, 4)
S4, PD4 = SQ(4), SPD(4)
I34 = I(3, 4)
U8 = RNG.integers(0, 255, (3, 4)).astype(np.uint8)

CASES = {
    # unary elementwise
    **{n: C(P34) for n in (
        "abs", "absolute", "acos", "arccos", "asin", "arcsin", "atan",
        "arctan", "asinh", "arcsinh", "atanh", "arctanh", "cbrt", "ceil",
        "conj", "conjugate", "cos", "cosh", "deg2rad", "degrees", "exp",
        "exp2", "expm1", "fabs", "floor", "i0", "imag", "isfinite", "isinf",
        "isnan", "isneginf", "isposinf", "isreal", "iscomplex", "log",
        "log10", "log1p", "log2", "logical_not", "negative", "positive",
        "rad2deg", "radians", "real", "reciprocal", "rint", "sign",
        "signbit", "sin", "sinc", "sinh", "spacing", "sqrt", "square",
        "tan", "tanh", "trunc", "angle", "frexp", "modf", "nan_to_num")},
    "acosh": C(P34 + 1.0), "arccosh": C(P34 + 1.0),
    "round": C(A34 * 10, 1), "around": C(A34 * 10, 2),
    "invert": C(I34), "bitwise_not": C(I34), "bitwise_invert": C(I34),
    "bitwise_count": C(I34),
    # binary elementwise
    **{n: C(P34 + 0.5, P(4) + 0.5) for n in (
        "add", "subtract", "multiply", "divide", "true_divide",
        "floor_divide", "mod", "remainder", "fmod", "power", "pow",
        "float_power", "maximum", "minimum", "fmax", "fmin", "hypot",
        "arctan2", "atan2", "logaddexp", "logaddexp2", "copysign",
        "nextafter", "heaviside", "equal", "not_equal", "greater",
        "greater_equal", "less", "less_equal", "logical_and",
        "logical_or", "logical_xor", "divmod", "isclose", "allclose",
        "array_equal", "array_equiv")},
    **{n: C(I34, I(4, lo=0, hi=4)) for n in (
        "bitwise_and", "bitwise_or", "bitwise_xor", "left_shift",
        "bitwise_left_shift", "right_shift", "bitwise_right_shift")},
    "gcd": C(I34, I(4, lo=1, hi=9)), "lcm": C(I34, I(4, lo=1, hi=9)),
    "ldexp": C(A34, I(4, lo=-3, hi=4)),
    # reductions
    **{n: C(A45, 1) for n in (
        "sum", "prod", "mean", "std", "var", "max", "min", "amax", "amin",
        "argmax", "argmin", "ptp", "count_nonzero", "median", "average",
        "nansum", "nanprod", "nanmean", "nanstd", "nanvar", "nanmax",
        "nanmin", "nanargmax", "nanargmin", "nanmedian", "cumsum",
        "cumprod", "nancumsum", "nancumprod")},
    "all": C(B(3, 4), 0), "any": C(B(3, 4), 1),
    "quantile": C(A45, 0.3, 1), "nanquantile": C(A45, 0.7),
    "percentile": C(A45, 30), "nanpercentile": C(A45, 90, 0),
    "cumulative_sum": C(A45, axis=1), "cumulative_prod": C(A45, axis=0),
    # shape
    "reshape": C(A34, (4, 3)), "ravel": C(A34), "transpose": C(A34),
    "permute_dims": C(F(2, 3, 4), (2, 0, 1)), "matrix_transpose": C(A34),
    "swapaxes": C(A34, 0, 1), "moveaxis": C(F(2, 3, 4), 0, 2),
    "rollaxis": C(F(2, 3, 4), 2), "squeeze": C(F(3, 1, 4)),
    "expand_dims": C(A34, 1), "atleast_1d": X(2.5),
    "atleast_2d": C(V8), "atleast_3d": C(A34),
    "broadcast_to": C(V8, (3, 8)),
    "broadcast_arrays": C(F(3, 1), F(4)),
    "concatenate": C([A34, F(2, 4)]), "concat": C([A34, A34], axis=1),
    "stack": C([V8, V8], 1), "vstack": C([A34, A34]),
    "hstack": C([A34, A34]), "dstack": C([A34, A34]),
    "column_stack": C([V8, V8]), "block": C([[A34, A34], [A34, A34]]),
    "split": C(F(6, 4), 3), "array_split": C(F(7, 4), 3),
    "hsplit": C(F(3, 6), 2), "vsplit": C(F(6, 3), 3),
    "dsplit": C(F(2, 2, 4), 2), "unstack": C(A34),
    "tile": C(A34, (2, 1)), "repeat": C(A34, 2, 1),
    "flip": C(A34, 0), "fliplr": C(A34), "flipud": C(A34),
    "roll": C(A34, 2, 1), "rot90": C(A34), "resize": C(A34, (5, 3)),
    "append": C(A34, A34, 0), "insert": C(A34, 1, 5.0, 0),
    "delete": C(A34, 1, 1), "pad": C(A34, ((1, 2), (2, 1))),
    "trim_zeros": C(np.array([0., 0., 1., 2., 0., 3., 0.])),
    "diag": C(V8), "diagflat": C(F(2, 2), 1), "diagonal": C(A45),
    "trace": C(A45), "tril": C(A45), "triu": C(A45, 1),
    "astype": C(A34, "int32"), "copy": C(A34),
    "clip": C(A34, -0.5, 0.5), "where": C(B(3, 4), A34, F(4)),
    # creation
    "arange": C(2, 11, 3), "linspace": X(0.0, 1.0, 7),
    "logspace": X(0.0, 2.0, 5), "geomspace": X(1.0, 64.0, 4),
    "eye": X(4, 5, 1), "identity": X(3), "tri": X(3, 4, 1),
    "zeros": C((2, 3)), "ones": C((2, 3)), "empty": C((2, 3)),
    "full": C((2, 3), 7), "zeros_like": C(A34), "ones_like": C(I34),
    "empty_like": C(A34), "full_like": C(A34, 7.5),
    "array": C(A34), "asarray": C(I34),
    "indices": C((2, 3)), "meshgrid": C(F(3), F(4)),
    "ix_": C(np.array([0, 2]), np.array([1, 3])),
    "diag_indices": C(3), "diag_indices_from": C(S4),
    "tril_indices": C(4, 1), "triu_indices": C(4, -1, 5),
    "tril_indices_from": C(A45), "triu_indices_from": C(A45, 1),
    "bartlett": X(7), "blackman": X(7), "hamming": X(7), "hanning": X(7),
    "kaiser": X(7, 3.0),
    "frombuffer": C(Host(np.arange(4.0).tobytes())),
    "fromstring": C(Host("1 2 3.5"), sep=" "),
    "fromfile": C(Host("missing.bin")), "fromiter": C(Host(range(3))),
    "from_dlpack": C(A34),
    # indexing, searching, sorting
    "take_along_axis": C(A34, np.argsort(A34, 1), 1),
    "choose": C(I(3, 4, lo=0, hi=3), [F(3, 4), F(3, 4), F(3, 4)]),
    "compress": C(np.array([True, False, True]), A34, 0),
    "extract": C(A34 > 0, A34),
    "select": C([A34 > 0.5, A34 < -0.5], [A34, -A34], 0.0),
    "nonzero": C(A34 > 0), "argwhere": C(A34 > 0),
    "flatnonzero": C(A34 > 0),
    "searchsorted": C(np.sort(V8), F(5)),
    "digitize": C(F(6), np.array([-1.0, 0.0, 0.5, 1.0])),
    "sort": C(A45, 1), "argsort": C(A45, 0),
    "partition": K(partition_holds, A45, 2),
    "argpartition": C(A45, 3),
    "lexsort": C((I(10, lo=0, hi=3), I(10, lo=0, hi=3))),
    "sort_complex": C(F(6)),
    "unravel_index": C(np.array([0, 5, 11]), (3, 4)),
    "ravel_multi_index": C((np.array([0, 2]), np.array([1, 3])), (3, 4)),
    "put": C(A34, np.array([0, 5]), np.array([9.0, 8.0]), inplace=False),
    "put_along_axis": C(A34, np.argmax(A34, 1)[:, None], 0.0, 1,
                        inplace=False),
    "place": C(A34, A34 > 0, np.array([1.0, 2.0]), inplace=False),
    "fill_diagonal": C(A34, 5.0, inplace=False),
    # sets
    "unique": C(I(20, lo=0, hi=5), return_counts=True),
    "unique_all": C(I(20, lo=0, hi=5)),
    "unique_counts": C(I(20, lo=0, hi=5)),
    "unique_inverse": C(I(4, 5, lo=0, hi=5)),
    "unique_values": C(I(20, lo=0, hi=5)),
    "intersect1d": C(I(10, lo=0, hi=6), I(10, lo=0, hi=6)),
    "union1d": C(I(10, lo=0, hi=6), I(10, lo=0, hi=6)),
    "setdiff1d": C(I(10, lo=0, hi=6), I(5, lo=0, hi=6)),
    "setxor1d": C(I(10, lo=0, hi=6), I(10, lo=0, hi=6)),
    "isin": C(I(3, 4, lo=0, hi=8), np.array([1, 3, 5])),
    # products
    "matmul": C(A34, A45), "dot": C(A34, A45), "vdot": C(A34, A34),
    "inner": C(A34, A34), "outer": C(V8, F(3)),
    "tensordot": C(F(2, 3, 4), F(3, 4, 5)),
    "einsum": C("ij,jk->ik", A34, A45),
    "einsum_path": K(path_only, "ij,jk,kl->il", A34, A45, F(5, 2)),
    "kron": C(F(2, 3), F(3, 2)), "cross": C(F(4, 3), F(4, 3)),
    "vecdot": C(A34, A34), "matvec": C(A34, F(4)), "vecmat": C(F(3), A34),
    # statistics and signals
    "bincount": C(I(20, lo=0, hi=7)),
    "histogram": C(F(50), 5), "histogram_bin_edges": C(F(50), 6),
    "histogram2d": C(F(40), F(40), 4),
    "histogramdd": C(F(40, 3), 3),
    "interp": C(P(5), np.sort(P(10)), F(10)),
    "convolve": C(F(7), F(3)), "correlate": C(F(7), F(3), "full"),
    "cov": C(A34), "corrcoef": C(A34), "gradient": C(A34),
    "diff": C(A34), "ediff1d": C(V8), "trapezoid": C(A34),
    "unwrap": C(np.cumsum(RNG.random(12) * 3)),
    # polynomials
    "poly": C(np.array([1.0, -2.0, 0.5])),
    "polyadd": C(F(3), F(5)), "polysub": C(F(4), F(2)),
    "polymul": C(F(3), F(4)), "polydiv": T(1e-10, F(6), F(3)),
    "polyder": C(F(5), 2), "polyint": C(F(4)),
    "polyval": C(F(4), F(6)), "vander": C(F(4), 3),
    "polyfit": T(1e-8, F(10), F(10), 2),
    "roots": K(as_set, np.array([1.0, -6.0, 11.0, -6.0])),
    # bits
    "packbits": C(B(3, 10)), "unpackbits": C(U8),
    # functions of functions
    "apply_along_axis": C(lambda v: v.sum(), 1, A34),
    "apply_over_axes": C("sum", A34, [0]),
    "piecewise": C(V8, [V8 < 0, V8 > 0.5], [lambda x: -x, 3.0]),
    "fromfunction": X(lambda i, j: i * 3 + j, (3, 4)),
    "mask_indices": C(4, "triu"),
    # host answers
    "shape": C(A34), "ndim": C(A34), "size": C(A34),
    "result_type": X(I34, 1.5), "can_cast": C("int32", "float64"),
    "issubdtype": C("float32", "floating"),
    "isdtype": C("float32", "real floating"),
    "iscomplexobj": C(A34), "isrealobj": C(A34), "isscalar": C(2.5),
    "iterable": C(A34), "broadcast_shapes": C((3, 1), (4,)),
    "array_repr": K(repr_body, A34), "array_str": C(A34),
    "save": C(Host("SAVE"), A34), "savez": C(Host("SAVEZ"), A34),
    "load": C(Host("LOAD")),
    # linalg
    "linalg_cholesky": C(PD4), "linalg_cond": T(1e-10, S4),
    "linalg_cross": C(F(4, 3), F(4, 3)), "linalg_det": T(1e-10, S4),
    "linalg_diagonal": C(A45), "linalg_eig": K(eig_pairs, S4),
    "linalg_eigh": K(eigh_pairs, PD4),
    "linalg_eigvals": K(same_eigvals, S4),
    "linalg_eigvalsh": T(1e-10, PD4), "linalg_inv": T(1e-10, S4),
    "linalg_lstsq": K(lstsq_solution, F(6, 3), F(6)),
    "linalg_matmul": C(A34, A45), "linalg_matrix_norm": C(A34),
    "linalg_matrix_power": T(1e-10, S4, 3),
    "linalg_matrix_rank": C(A34), "linalg_matrix_transpose": C(A34),
    "linalg_multi_dot": C([A34, A45, F(5, 2)]),
    "linalg_norm": C(A34), "linalg_outer": C(V8, F(3)),
    "linalg_pinv": T(1e-9, A34), "linalg_qr": K(qr_product, A45),
    "linalg_slogdet": T(1e-10, S4), "linalg_solve": T(1e-10, S4, F(4)),
    "linalg_svd": K(svd_product, A34), "linalg_svdvals": T(1e-10, A34),
    "linalg_tensordot": C(F(2, 3, 4), F(3, 4, 5)),
    "linalg_tensorinv": T(1e-9, np.eye(6).reshape(2, 3, 6)
                          + 0.1 * F(2, 3, 6)),
    "linalg_tensorsolve": T(1e-9, SQ(6).reshape(2, 3, 6), F(2, 3)),
    "linalg_trace": C(A45), "linalg_vecdot": C(A34, A34),
    "linalg_vector_norm": C(A34),
    # fft
    **{f"fft_{n}": T(1e-12, A45) for n in (
        "fft", "ifft", "rfft", "ihfft", "fft2", "ifft2", "rfft2", "fftn",
        "ifftn", "rfftn", "fftshift", "ifftshift")},
    **{f"fft_{n}": T(1e-12, A45, 6) for n in ("irfft", "hfft")},
    **{f"fft_{n}": T(1e-12, A45, (4, 6)) for n in ("irfft2", "irfftn")},
    "fft_fftfreq": X(8, 0.5), "fft_rfftfreq": X(8, 0.5),
}

# the scalar types: a cast of an array
TYPE_NAMES = ["bool", "bool_", "uint8", "uint16", "uint32", "uint64", "uint",
              "int8", "int16", "int32", "int64", "int_", "float16",
              "bfloat16", "float32", "single", "float64", "double",
              "float_", "complex64", "csingle", "complex128", "cdouble",
              "complex_", "float8_e4m3fn", "float8_e5m2", "float8_e4m3fnuz",
              "float8_e5m2fnuz", "float8_e8m0fnu"]
for _n in TYPE_NAMES:
    CASES[_n] = C(I34 if _n.startswith(("u", "b")) else A34 * 4)
# an exponent-only type: powers of two
CASES["float8_e8m0fnu"] = C(2.0 ** I(3, 4, lo=-3, hi=4))
# types torch has not: the port raises TypeError
NO_TORCH_TYPE = ["int2", "int4", "uint2", "uint4", "float4_e2m1fn",
                 "float8_e3m4", "float8_e4m3", "float8_e4m3b11fnuz"]
# NumPy's abstract type classes: served as they are, for issubdtype
ABSTRACT = ["character", "complexfloating", "flexible", "floating",
            "generic", "inexact", "integer", "number", "object_",
            "signedinteger", "unsignedinteger"]
# the reference's wrapper raises on these (its result is no array); the
# port returns what jax.numpy returns, held against jax.numpy itself
JAX_ORACLE = ["finfo", "iinfo", "dtype", "promote_types", "printoptions",
              "get_printoptions", "set_printoptions", "vectorize",
              "ComplexWarning"]
# not ported: the reference's wrapper refuses them too (TypeError)
REFUSED = ["ufunc", "frompyfunc"]


# ---------------------------------------------------------------------------
# the harness
# ---------------------------------------------------------------------------
_X64 = {"float64": "float32", "complex128": "complex64"}


def _fn(pkg, name):
    for sub in ("linalg", "fft"):
        if name.startswith(sub + "_"):
            return getattr(getattr(pkg.np, sub), name[len(sub) + 1:])
    return getattr(pkg.np, name)


def _arg(pkg, v, tmp):
    if isinstance(v, Host):
        if isinstance(v.v, str) and v.v in ("SAVE", "SAVEZ", "LOAD"):
            return os.path.join(tmp, f"{v.v}_{pkg.__name__}.npy")
        return v.v
    if isinstance(v, np.ndarray):
        return pkg.np.array(v, dtype=v.dtype.name)
    if isinstance(v, list):
        return [_arg(pkg, x, tmp) for x in v]
    if isinstance(v, tuple):
        return tuple(_arg(pkg, x, tmp) for x in v)
    return v


def run(pkg, name, case, tmp):
    args = [_arg(pkg, a, tmp) for a in case.args]
    kwargs = {k: _arg(pkg, v, tmp) for k, v in case.kwargs.items()}
    # the function argument: jax.numpy's own for the reference (whose
    # mx.np functions return arrays jax.numpy cannot take), mx.np's here
    native = jnp if pkg is jmx else tmx.np
    if name in ("apply_over_axes",):
        args[0] = getattr(native, args[0])
    if name == "mask_indices":
        args[1] = getattr(native, args[1])
    if name == "load":
        np.save(args[0], A34)
    try:
        return "ok", _fn(pkg, name)(*args, **kwargs)
    except Exception as e:      # the reference's exception type is held
        return "raised", e


def plain(v):
    """A result as nested lists of (kind, dtype name, numpy value)."""
    if isinstance(v, jmx.nd.NDArray):
        return plain(v._data)
    if isinstance(v, tmx.nd.NDArray):
        return ("A", dtype_name(v.dtype), v.asnumpy())
    if hasattr(v, "__array__") and hasattr(v, "dtype") and \
            not isinstance(v, torch.Tensor):
        a = np.asarray(v)
        return ("A", a.dtype.name, a)
    if isinstance(v, torch.dtype):
        return ("D", dtype_name(v))
    if isinstance(v, np.dtype):
        return ("D", v.name)
    if isinstance(v, (bool, int, float, complex)):
        return ("S", None, np.asarray(v))
    if isinstance(v, (list, tuple)):
        return [plain(x) for x in v]
    return v


def raw(v):
    """A result as nested lists of numpy values (for ``check``)."""
    if isinstance(v, jmx.nd.NDArray):
        return raw(v._data)
    if isinstance(v, tmx.nd.NDArray):
        return v.asnumpy()
    if hasattr(v, "__array__") and not isinstance(v, (list, tuple)):
        return np.asarray(v)
    if isinstance(v, (list, tuple)):
        return [raw(x) for x in v]
    return v


def _stack(v):
    if isinstance(v, list):
        leaves = [_stack(x) for x in v]
        return ("A", leaves[0][1] if leaves else None,
                np.stack([x[2] for x in leaves]) if leaves
                else np.zeros(0))
    return v


def compare(r, g, case, where="result"):
    if isinstance(r, list) != isinstance(g, list):
        r, g = _stack(r), _stack(g)
    if isinstance(r, list):
        assert len(r) == len(g), (where, len(r), len(g))
        for i, (a, b) in enumerate(zip(r, g)):
            compare(a, b, case, f"{where}[{i}]")
        return
    if not (isinstance(r, tuple) and r and r[0] in "ASD"):
        assert r == g, (where, r, g)
        return
    if r[0] == "D" or g[0] == "D":
        want = _X64.get(r[1], r[1]) if case.x64 else r[1]
        assert g[1] == want, (where, r, g)
        return
    ra, ga = np.asarray(r[2]), np.asarray(g[2])
    assert ga.shape == ra.shape, (where, ga.shape, ra.shape)
    if r[1] is not None and g[1] is not None:
        want = _X64.get(r[1], r[1]) if case.x64 else r[1]
        assert g[1] == want, (where, g[1], r[1])
    if ra.dtype.kind in "biuSU" or case.exact:
        np.testing.assert_array_equal(ga, ra, err_msg=where)
        return
    rtol = max(case.rtol, 1e-6) if case.x64 or \
        ga.dtype in (np.float32, np.complex64) else case.rtol
    scale = float(np.max(np.abs(ra))) if ra.size else 0.0
    np.testing.assert_allclose(ga.astype(np.complex128 if np.iscomplexobj(
        ga) else np.float64), ra, rtol=rtol, atol=rtol * scale,
        equal_nan=True, err_msg=where)


def check_case(name, tmp_path):
    case = CASES[name]
    rk, ref = run(jmx, name, case, str(tmp_path))
    with tmx.cpu():
        gk, got = run(tmx, name, case, str(tmp_path))
    if rk == "raised":
        assert gk == "raised" and type(got) is type(ref), \
            (name, repr(ref), got)
        return
    assert gk == "ok", (name, repr(got))
    if case.check is not None:
        args = [a.v if isinstance(a, Host) else a for a in case.args]
        case.check(raw(ref), raw(got), args)
        return
    compare(plain(ref), plain(got), case, name)
    if isinstance(got, tmx.nd.NDArray):
        assert isinstance(got, tmx.np.ndarray), (name, type(got))


_NAMES = sorted(CASES)
FIRST_HALF, SECOND_HALF = _NAMES[:len(_NAMES) // 2], _NAMES[len(_NAMES) // 2:]
