"""Parity of mxtpu_torch.ndarray (NDArray, its constructors and methods)
with mxtpu.ndarray on the CPU.

Every case runs the same numpy inputs (from ``np.random.default_rng``)
through both packages' ``mx.nd`` — the reference on its default (CPU)
context, the port with ``ctx="cpu"`` — and compares the results: values,
shapes and dtype names. A case that should raise returns the name of
the exception both packages raise.

Tolerances: elementwise results within 1e-6 relative (float32; the two
libraries' ``exp``, ``tanh``, ``pow`` and friends differ by an ulp or
two, about 1.2e-7 each), reductions within 1e-5 relative (another
summation order), integer and bool results exactly.

x64 promotion: the reference's tests run jax with x64 on
(``tests/conftest.py``), where ``int32 * 2.5``, ``float32 *
np.float64(2)`` and ``one_hot`` are float64. The port follows torch,
which (like jax with x64 off) gives float32. Those cases (kind "x64")
compare values, and check that the port gives float32 where the
reference gives float64; every other case checks that the dtypes
agree.
"""
import pickle

import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu_torch as tmx
from mxtpu_torch.base import dtype_name

torch.set_num_threads(2)

ELEM = dict(rtol=1e-6, atol=1e-7)
RED = dict(rtol=1e-5, atol=1e-6)

rng = np.random.default_rng(0)
A = rng.standard_normal((3, 4)).astype(np.float32)
B = rng.standard_normal((3, 4)).astype(np.float32)
P = rng.uniform(0.5, 2.0, (3, 4)).astype(np.float32)
C3 = rng.standard_normal((2, 3, 4)).astype(np.float32)
M = rng.standard_normal((4, 5)).astype(np.float32)
I = rng.integers(-5, 6, (3, 4)).astype(np.int32)
IP = rng.integers(1, 6, (3, 4)).astype(np.int32)
IDX = np.array([2, 0, 1, 2])


class Pkg:
    """One package's frontend, with how it places arrays."""

    def __init__(self, mx, ctx):
        self.mx, self.nd, self.ag, self.ctx = mx, mx.nd, mx.autograd, ctx

    def arr(self, a, **kw):
        return self.nd.array(a, ctx=self.ctx, **kw)

    def kw(self):
        return {"ctx": self.ctx}


REF, PORT = Pkg(jmx, None), Pkg(tmx, "cpu")


def raises(fn):
    try:
        fn()
    except Exception as e:   # the case compares the exception's name
        return type(e).__name__
    return "no error"


def iop(op, other):
    """An in-place operator on a fresh copy of A, the array returned."""
    def f(m):
        a = m.arr(A)
        o = m.arr(other) if isinstance(other, np.ndarray) else other
        if op == "+":
            a += o
        elif op == "-":
            a -= o
        elif op == "*":
            a *= o
        else:
            a /= o
        return a
    return f


def setitem(key, value, whole=A):
    def f(m):
        a = m.arr(whole)
        v = m.arr(value) if isinstance(value, np.ndarray) else value
        a[key(m) if callable(key) else key] = v
        return a
    return f


def write_under_record(how):
    def f(m):
        x = m.arr(A)
        x.attach_grad()
        with m.ag.record():
            y = x * 2
            if how == "setitem":
                y[0] = 5.0
            else:
                y += 1
    return lambda m: raises(lambda: f(m))


def it_list(m):
    return [r for r in m.arr(A)]


def pickled(m):
    return pickle.loads(pickle.dumps(m.arr(A)))


def astype_nocopy(m):
    a = m.arr(A)
    return a.astype("float32", copy=False) is a


def copyto_array(m):
    dst = m.arr(I)
    m.arr(A).copyto(dst)
    return dst


def version_bump(m):
    a = m.arr(A)
    a[0] = 1.0
    a += 1
    return a._version


# name -> (fn(pkg), kind); kind: "elem", "red", "exact" or "x64"
CASES = {
    # constructors
    "array_float64": (lambda m: m.arr(A.astype(np.float64)), "exact"),
    "array_int32": (lambda m: m.arr(I), "exact"),
    "array_int64": (lambda m: m.arr(I.astype(np.int64)), "exact"),
    "array_uint8": (lambda m: m.arr(IP.astype(np.uint8)), "exact"),
    "array_bool": (lambda m: m.arr(A > 0), "exact"),
    "array_list_of_ints": (lambda m: m.arr([[1, 2], [3, 4]]), "exact"),
    "array_scalar": (lambda m: m.arr(3.5), "exact"),
    "array_dtype": (lambda m: m.arr(A, dtype="float16"), "exact"),
    "array_of_ndarray": (lambda m: m.arr(m.arr(I)), "exact"),
    "array_of_ndarray_dtype": (lambda m: m.arr(m.arr(I), dtype="float32"),
                               "exact"),
    "empty": (lambda m: m.nd.empty((2, 3), **m.kw()), "exact"),
    "zeros_int_shape": (lambda m: m.nd.zeros(4, **m.kw()), "exact"),
    "zeros_dtype": (lambda m: m.nd.zeros((2, 3), dtype="int32", **m.kw()),
                    "exact"),
    "ones": (lambda m: m.nd.ones((2, 3), **m.kw()), "exact"),
    "ones_dtype": (lambda m: m.nd.ones(3, dtype="int64", **m.kw()), "exact"),
    "full": (lambda m: m.nd.full((2, 2), 7.5, **m.kw()), "exact"),
    "full_dtype": (lambda m: m.nd.full(3, 7, dtype="int32", **m.kw()),
                   "exact"),
    "arange_stop": (lambda m: m.nd.arange(5, **m.kw()), "exact"),
    "arange_step": (lambda m: m.nd.arange(0, 10, 2, **m.kw()), "exact"),
    "arange_float_step": (lambda m: m.nd.arange(1, 3, 0.25, **m.kw()),
                          "elem"),
    "arange_repeat": (lambda m: m.nd.arange(0, 3, 1, repeat=2, **m.kw()),
                      "exact"),
    "arange_dtype": (lambda m: m.nd.arange(0, 6, 2, dtype="int32",
                                           **m.kw()), "exact"),
    "concat_default_dim": (lambda m: m.nd.concat(m.arr(A), m.arr(B)),
                           "exact"),
    "concat_list_dim0": (lambda m: m.nd.concat([m.arr(A), m.arr(B)], dim=0),
                         "exact"),
    "stack": (lambda m: m.nd.stack(m.arr(A), m.arr(B)), "exact"),
    "stack_list_axis1": (lambda m: m.nd.stack([m.arr(A), m.arr(B)], axis=1),
                         "exact"),
    "waitall": (lambda m: m.nd.waitall(), "exact"),
    # properties and protocol
    "shape_size_ndim": (lambda m: (m.arr(C3).shape, m.arr(C3).size,
                                   m.arr(C3).ndim), "exact"),
    "stype": (lambda m: m.arr(A).stype, "exact"),
    "T": (lambda m: m.arr(C3).T, "exact"),
    "T_1d": (lambda m: m.arr(A[0]).T, "exact"),
    "len": (lambda m: len(m.arr(C3)), "exact"),
    "len_0d": (lambda m: raises(lambda: len(m.arr(2.0))), "exact"),
    "iter": (it_list, "exact"),
    "float": (lambda m: float(m.arr([2.5])), "exact"),
    "int": (lambda m: int(m.arr([[7.9]])), "exact"),
    "bool_true": (lambda m: bool(m.arr([3.0])), "exact"),
    "bool_false": (lambda m: bool(m.arr(0.0)), "exact"),
    "bool_error": (lambda m: raises(lambda: bool(m.arr(A))), "exact"),
    "asscalar": (lambda m: m.arr([[4.25]]).asscalar(), "exact"),
    "item": (lambda m: m.arr(I[:1, :1]).item(), "exact"),
    "asscalar_error": (lambda m: raises(lambda: m.arr(A).asscalar()),
                       "exact"),
    "repr": (lambda m: "NDArray (3, 4)" in repr(m.arr(A)), "exact"),
    "hash_is_identity": (lambda m: len({m.arr(A), m.arr(A)}), "exact"),
    "pickle": (pickled, "exact"),
    "wait_to_read": (lambda m: m.arr(A).wait_to_read(), "exact"),
    # dtype and device movement
    "astype_int32": (lambda m: m.arr(A * 3).astype("int32"), "exact"),
    "astype_float16": (lambda m: m.arr(A).astype(np.float16), "exact"),
    "astype_int_to_float": (lambda m: m.arr(I).astype("float32"), "exact"),
    "astype_no_copy": (astype_nocopy, "exact"),
    "asfloat": (lambda m: m.arr(I).asfloat(), "exact"),
    "as_in_context_same": (lambda m: (lambda a: a.as_in_context(a.context)
                                      is a)(m.arr(A)), "exact"),
    "copyto_array": (copyto_array, "exact"),
    "copyto_device": (lambda m: m.arr(A).copyto(m.arr(B).context), "exact"),
    "copy": (lambda m: m.arr(A).copy(), "exact"),
    "detach": (lambda m: m.arr(A).detach(), "exact"),
    "zeros_like": (lambda m: m.arr(I).zeros_like(), "exact"),
    "ones_like": (lambda m: m.arr(A).ones_like(), "exact"),
    "tostype_default": (lambda m: m.arr(A).tostype("default"), "exact"),
    # the reference's dense tostype raises; its csr_matrix converts
    "tostype_csr": (lambda m: (m.arr(A).tostype("csr") if m is PORT else
                               m.nd.sparse.csr_matrix(m.arr(A)))
                    .tostype("default"), "exact"),
    # binary dunders, NDArray and scalar operands, and reflected
    "add": (lambda m: m.arr(A) + m.arr(B), "elem"),
    "add_scalar": (lambda m: m.arr(A) + 1.5, "elem"),
    "radd": (lambda m: 1.5 + m.arr(A), "elem"),
    "add_broadcast": (lambda m: m.arr(C3) + m.arr(A[0]), "elem"),
    "add_numpy": (lambda m: m.arr(A) + B, "elem"),
    "sub": (lambda m: m.arr(A) - m.arr(B), "elem"),
    "sub_scalar": (lambda m: m.arr(A) - 2.0, "elem"),
    "rsub": (lambda m: 2.0 - m.arr(A), "elem"),
    "mul": (lambda m: m.arr(A) * m.arr(B), "elem"),
    "mul_scalar": (lambda m: m.arr(A) * 3.0, "elem"),
    "rmul": (lambda m: 3.0 * m.arr(A), "elem"),
    "truediv": (lambda m: m.arr(A) / m.arr(P), "elem"),
    "truediv_scalar": (lambda m: m.arr(A) / 4.0, "elem"),
    "rtruediv": (lambda m: 2.0 / m.arr(P), "elem"),
    "mod": (lambda m: m.arr(A * 5) % m.arr(P), "elem"),
    "mod_scalar": (lambda m: m.arr(A * 5) % 1.5, "elem"),
    "rmod": (lambda m: 5.0 % m.arr(P), "elem"),
    "mod_int": (lambda m: m.arr(I) % m.arr(IP), "exact"),
    "pow": (lambda m: m.arr(P) ** m.arr(B), "elem"),
    "pow_scalar": (lambda m: m.arr(A) ** 2, "elem"),
    "rpow": (lambda m: 2.0 ** m.arr(A), "elem"),
    "matmul": (lambda m: m.arr(A) @ m.arr(M), "red"),
    "neg": (lambda m: -m.arr(A), "exact"),
    "abs": (lambda m: abs(m.arr(A)), "exact"),
    "int_add_int": (lambda m: m.arr(I) + m.arr(IP), "exact"),
    "int_div_int": (lambda m: m.arr(I) / m.arr(IP), "elem"),
    "int_mul_int_scalar": (lambda m: m.arr(I) * 3, "exact"),
    "eq": (lambda m: m.arr(A) == m.arr(A * (A > 0)), "exact"),
    "eq_scalar": (lambda m: m.arr(I) == 2, "exact"),
    "ne": (lambda m: m.arr(A) != m.arr(B), "exact"),
    "gt": (lambda m: m.arr(A) > m.arr(B), "exact"),
    "gt_scalar": (lambda m: m.arr(A) > 0.0, "exact"),
    "ge": (lambda m: m.arr(I) >= m.arr(IP), "exact"),
    "lt": (lambda m: m.arr(A) < 0.5, "exact"),
    "le": (lambda m: m.arr(A) <= m.arr(B), "exact"),
    # in-place operators rebind the buffer
    "iadd": (iop("+", B), "elem"),
    "iadd_scalar": (iop("+", 2.0), "elem"),
    "isub": (iop("-", B), "elem"),
    "isub_scalar": (iop("-", 0.5), "elem"),
    "imul": (iop("*", B), "elem"),
    "imul_scalar": (iop("*", 3.0), "elem"),
    "itruediv": (iop("/", P), "elem"),
    "itruediv_scalar": (iop("/", 4.0), "elem"),
    "version_bumps": (version_bump, "exact"),
    # writes to arrays produced under record() raise
    "setitem_under_record": (write_under_record("setitem"), "exact"),
    "iadd_under_record": (write_under_record("iadd"), "exact"),
    # shape methods
    "reshape_tuple": (lambda m: m.arr(C3).reshape((4, 6)), "exact"),
    "reshape_varargs": (lambda m: m.arr(C3).reshape(6, 4), "exact"),
    "reshape_infer": (lambda m: m.arr(C3).reshape(-1, 3), "exact"),
    "reshape_zero_copies": (lambda m: m.arr(C3).reshape(0, -1), "exact"),
    "reshape_like": (lambda m: m.arr(A).reshape_like(m.arr(A.reshape(4, 3))),
                     "exact"),
    "transpose": (lambda m: m.arr(C3).transpose(), "exact"),
    "transpose_axes": (lambda m: m.arr(C3).transpose((1, 0, 2)), "exact"),
    "swapaxes": (lambda m: m.arr(C3).swapaxes(0, 2), "exact"),
    "flatten": (lambda m: m.arr(C3).flatten(), "exact"),
    "expand_dims": (lambda m: m.arr(A).expand_dims(1), "exact"),
    "expand_dims_neg": (lambda m: m.arr(A).expand_dims(-1), "exact"),
    "squeeze": (lambda m: m.arr(A.reshape(3, 1, 4, 1)).squeeze(), "exact"),
    "squeeze_axis": (lambda m: m.arr(A.reshape(3, 1, 4, 1)).squeeze(1),
                     "exact"),
    "broadcast_to": (lambda m: m.arr(A[:1]).broadcast_to((3, 4)), "exact"),
    "broadcast_like": (lambda m: m.arr(A[0]).broadcast_like(m.arr(C3)),
                       "exact"),
    "slice_axis": (lambda m: m.arr(C3).slice_axis(2, 1, 3), "exact"),
    "take": (lambda m: m.arr(A).take(m.arr(IDX)), "exact"),
    "take_numpy_axis1": (lambda m: m.arr(A).take(np.array([3, 0, -1]),
                                                 axis=1), "exact"),
    "one_hot": (lambda m: m.arr(np.array([0, 2, 1, 5])).one_hot(4), "x64"),
    "one_hot_values": (lambda m: m.arr(np.array([1, 0])).one_hot(
        3, on_value=5.0, off_value=-1.0), "x64"),
    "tile": (lambda m: m.arr(A).tile((2, 1)), "exact"),
    "tile_int": (lambda m: m.arr(A).tile(2), "exact"),
    "repeat": (lambda m: m.arr(A).repeat(2), "exact"),
    "repeat_axis": (lambda m: m.arr(A).repeat(3, axis=1), "exact"),
    # reductions
    "sum": (lambda m: m.arr(C3).sum(), "red"),
    "sum_axis": (lambda m: m.arr(C3).sum(axis=1), "red"),
    "sum_axes_keepdims": (lambda m: m.arr(C3).sum(axis=(0, 2),
                                                  keepdims=True), "red"),
    "sum_int": (lambda m: m.arr(I).sum(axis=0), "exact"),
    "mean": (lambda m: m.arr(C3).mean(), "red"),
    "mean_axis_keepdims": (lambda m: m.arr(C3).mean(axis=2, keepdims=True),
                           "red"),
    "mean_int": (lambda m: m.arr(I).mean(), "red"),
    "max": (lambda m: m.arr(C3).max(), "exact"),
    "max_axis": (lambda m: m.arr(C3).max(axis=1), "exact"),
    "min_keepdims": (lambda m: m.arr(C3).min(axis=0, keepdims=True),
                     "exact"),
    "min_int": (lambda m: m.arr(I).min(axis=1), "exact"),
    "prod": (lambda m: m.arr(P).prod(), "red"),
    "prod_axis": (lambda m: m.arr(C3).prod(axis=1), "red"),
    "prod_axes_keepdims": (lambda m: m.arr(C3).prod(axis=(0, 2),
                                                    keepdims=True), "red"),
    "norm": (lambda m: m.arr(C3).norm(), "red"),
    "norm_keepdims": (lambda m: m.arr(A).norm(keepdims=True), "red"),
    "norm_axis": (lambda m: m.arr(C3).norm(axis=1), "red"),
    "norm_ord1_axis": (lambda m: m.arr(A).norm(ord=1, axis=0), "red"),
    "argmax": (lambda m: m.arr(C3).argmax(), "exact"),
    "argmax_axis": (lambda m: m.arr(C3).argmax(axis=2), "exact"),
    "argmax_keepdims": (lambda m: m.arr(A).argmax(axis=0, keepdims=True),
                        "exact"),
    "argmin": (lambda m: m.arr(A).argmin(axis=1), "exact"),
    "argmin_all_keepdims": (lambda m: m.arr(A).argmin(keepdims=True),
                            "exact"),
    # elementwise math
    "clip": (lambda m: m.arr(A).clip(-0.5, 0.5), "exact"),
    "clip_min": (lambda m: m.arr(A).clip(a_min=0.0), "exact"),
    "abs_method": (lambda m: m.arr(A).abs(), "exact"),
    "sqrt": (lambda m: m.arr(P).sqrt(), "elem"),
    "exp": (lambda m: m.arr(A).exp(), "elem"),
    "log": (lambda m: m.arr(P * 3).log(), "elem"),
    "relu": (lambda m: m.arr(A).relu(), "exact"),
    "sigmoid": (lambda m: m.arr(A).sigmoid(), "elem"),
    "tanh": (lambda m: m.arr(A).tanh(), "elem"),
    "softmax": (lambda m: m.arr(C3).softmax(), "elem"),
    "softmax_axis": (lambda m: m.arr(C3).softmax(axis=0), "elem"),
    # indexing
    "getitem_int": (lambda m: m.arr(C3)[1], "exact"),
    "getitem_neg_int": (lambda m: m.arr(C3)[-1], "exact"),
    "getitem_slice": (lambda m: m.arr(C3)[:, 1:3], "exact"),
    "getitem_step": (lambda m: m.arr(A)[::2, ::-1], "exact"),
    "getitem_tuple_ints": (lambda m: m.arr(C3)[1, 2], "exact"),
    "getitem_list": (lambda m: m.arr(A)[[2, 0]], "exact"),
    "getitem_empty_list": (lambda m: m.arr(A)[[]], "exact"),
    "getitem_tuple_list": (lambda m: m.arr(C3)[1, :, [0, 3]], "exact"),
    "getitem_adjacent_int_list": (lambda m: m.arr(C3)[:, 1, [0, 3]],
                                  "exact"),
    "getitem_list_int": (lambda m: m.arr(C3)[[1, 0], 2], "exact"),
    "getitem_ndarray": (lambda m: m.arr(A)[m.arr(np.array([1, 1, 0]))],
                        "exact"),
    "getitem_ellipsis": (lambda m: m.arr(C3)[..., 0], "exact"),
    "getitem_none": (lambda m: m.arr(A)[None], "exact"),
    "setitem_int": (setitem(1, 5.0), "exact"),
    "setitem_tuple": (setitem((0, 2), 1.5), "exact"),
    "setitem_slice": (setitem(slice(1, 3), B[:2]), "exact"),
    "setitem_full_scalar": (setitem(slice(None), 2.0), "exact"),
    "setitem_full_broadcast": (setitem(slice(None), B[0]), "exact"),
    "setitem_ellipsis": (setitem(Ellipsis, 3.0), "exact"),
    "setitem_list": (setitem([0, 2], -1.0), "exact"),
    "setitem_empty_list": (setitem([], 9.0), "exact"),
    "setitem_tuple_list": (setitem((slice(None), [1, 3]), 0.5), "exact"),
    "setitem_ndarray_value": (setitem(2, B[1]), "exact"),
    "setitem_int_array": (setitem(0, 7.0, whole=I), "exact"),
    "setitem_ndarray_key": (setitem(lambda m: m.arr(np.array([2, 1])), 4.0),
                            "exact"),
    "setitem_negative_step": (setitem((slice(None), slice(None, None, -2)),
                                      B[:, :2]), "exact"),
    "setitem_tuple_int_list": (setitem((1, [0, 2]), -3.0), "exact"),
    # x64 promotion: float64 in the reference's tests, float32 here
    "x64_int_times_float": (lambda m: m.arr(I) * 2.5, "x64"),
    "x64_float_times_np_float64": (lambda m: m.arr(A) * np.float64(2),
                                   "x64"),
}


def host(v):
    """A result as plain Python/numpy: arrays as (dtype name, values)."""
    if isinstance(v, jmx.nd.NDArray):
        return ("array", v.dtype.name, v.asnumpy())
    if isinstance(v, tmx.nd.NDArray):
        return ("array", dtype_name(v.dtype), v.asnumpy())
    if isinstance(v, (list, tuple)):
        return [host(x) for x in v]
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, (jmx.Context, torch.device)):
        return "device"
    return v


def check(ref, got, kind, where="result"):
    if isinstance(ref, list):
        assert isinstance(got, list) and len(got) == len(ref), where
        for i, (r, g) in enumerate(zip(ref, got)):
            check(r, g, kind, f"{where}[{i}]")
        return
    if not (isinstance(ref, tuple) and ref and ref[0] == "array"):
        assert got == ref, where
        return
    (_, rdt, rv), (_, gdt, gv) = ref, got
    assert gv.shape == rv.shape, where
    if kind == "x64":
        assert (rdt, gdt) == ("float64", "float32"), where
        np.testing.assert_allclose(gv, rv, **ELEM)
        return
    assert gdt == rdt, where
    if kind == "exact":
        np.testing.assert_array_equal(gv, rv)
    else:
        np.testing.assert_allclose(gv, rv, **(RED if kind == "red" else ELEM))


@pytest.mark.parametrize("name", sorted(CASES))
def test_case(name):
    fn, kind = CASES[name]
    check(host(fn(REF)), host(fn(PORT)), kind)


def test_results_take_the_first_dense_inputs_class():
    class Sub(tmx.nd.NDArray):
        __slots__ = ()
    a = Sub(torch.tensor(A))
    b = PORT.arr(B)
    assert type(a + b) is Sub and type(b + a) is tmx.nd.NDArray
    assert type(a.sum()) is Sub and type(tmx.nd.stack(b, a)) is tmx.nd.NDArray


def test_no_ctx_means_the_card_or_a_raise():
    if torch.cuda.is_available():
        assert tmx.nd.array(A).context == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tmx.nd.array(A)
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tmx.nd.zeros((2, 2))


def test_writes_rebind_and_leave_the_old_buffer_alone():
    """What a tape node saved is never written: setitem and += rebind."""
    a = PORT.arr(A)
    old = a._data
    a[0] = 9.0
    a += 1.0
    assert a._data is not old
    np.testing.assert_array_equal(old.numpy(), A)


def test_host_copies_do_not_alias():
    src = A.copy()
    a = PORT.arr(src)
    src[0, 0] = 100.0
    out = a.asnumpy()
    out[1, 1] = -100.0
    np.testing.assert_array_equal(a.asnumpy(), A)


def test_bfloat16_asnumpy_is_float32():
    a = PORT.arr(A, dtype="bfloat16")
    assert a.dtype == torch.bfloat16
    got = a.asnumpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(
        got, torch.tensor(A).to(torch.bfloat16).float().numpy())


def test_parts_of_later_slices_raise():
    """Parts that once waited for later slices now give the reference's
    values: sparse storage (a dense array converts on its device, as
    the reference's ``row_sparse_array`` converts it), and ``dot`` and
    ``pad`` from the op registry."""
    a = PORT.arr(A)
    ref = REF.arr(A)
    rsp = a.tostype("row_sparse")
    want = jmx.nd.sparse.row_sparse_array(ref)
    assert rsp.stype == "row_sparse"
    np.testing.assert_array_equal(rsp.indices.asnumpy(),
                                  want.indices.asnumpy())
    np.testing.assert_array_equal(rsp.asnumpy(), want.asnumpy())
    np.testing.assert_allclose(a.dot(a.T).asnumpy(),
                               ref.dot(ref.T).asnumpy(), **ELEM)
    pad = dict(mode="constant", pad_width=(1, 0, 0, 2), constant_value=1.5)
    np.testing.assert_array_equal(a.pad(**pad).asnumpy(),
                                  ref.pad(**pad).asnumpy())


def test_every_reference_op_names_its_slice():
    """Every mx.nd.<op> of the reference's registry resolves in the
    port (no op names a later slice any more), to the port's op of that
    name."""
    from mxtpu.ndarray import ops
    import mxtpu_torch.contrib.quantization  # noqa: F401
    assert len(ops.__all__) > 300
    for n in ops.__all__:
        if n in ("OP_REGISTRY", "register_op"):
            continue
        assert getattr(tmx.nd, n) is tmx.nd.OP_REGISTRY[n], n
    assert callable(tmx.nd.elu) and callable(tmx.nd.linalg_det)


def test_profiler_hook_raises(monkeypatch):
    """The profiler's hook sees every dispatch with its op name and
    host seconds, and an error it raises reaches the caller."""
    from mxtpu_torch.ndarray import ndarray as tnd
    seen = []
    monkeypatch.setattr(tnd, "_profile_hook",
                        lambda name, secs: seen.append((name, secs)))
    PORT.arr(A) + 1.0
    assert [n for n, _ in seen] == ["add"] and seen[0][1] >= 0.0

    def refuse(name, secs):
        raise RuntimeError(f"hook refused {name}")
    monkeypatch.setattr(tnd, "_profile_hook", refuse)
    with pytest.raises(RuntimeError, match="hook refused add"):
        PORT.arr(A) + 1.0


def test_naive_engine_syncs_every_op(monkeypatch):
    from mxtpu_torch.ndarray import ndarray as tnd
    synced = []
    monkeypatch.setattr(tnd, "_NAIVE", True)
    monkeypatch.setattr(tnd, "_sync", synced.append)
    out = PORT.arr(A) * 2.0
    assert len(synced) == 1 and synced[0] is out._data
