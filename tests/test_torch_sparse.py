"""``mxtpu_torch.nd.sparse`` against ``mxtpu.nd.sparse`` on the CPU: the
reference's ``tests/test_sparse.py`` cases (its kvstore cases aside)
through both packages on the same scipy matrices, values compared
within 1e-6 relative (a csr product's sums may be added in another
order: 1e-5 relative plus 1e-6); and the port's own: the sparse paths
(``dot``, ``add``, ``retain``) never build the dense form, csrᵀ·dense
gives row-sparse storage, a dense array converts to either storage
(``tostype``, ``cast_storage``), and arrays made on the CPU stay there.
"""
import numpy as onp
import pytest
import scipy.sparse as sp
import torch

import mxtpu as jmx
from mxtpu.ndarray import sparse as jsp
import mxtpu_torch as tmx
from mxtpu_torch.ndarray import sparse as tsp

torch.set_num_threads(2)   # a CPU share for each xdist worker


def _rand_csr(m, n, density=0.3, seed=0):
    return sp.random(m, n, density=density, random_state=seed,
                     dtype=onp.float32, format="csr")


def _close(got, want, exact=False):
    got, want = onp.asarray(got), onp.asarray(want)
    assert got.shape == want.shape
    if exact:
        onp.testing.assert_array_equal(got, want)
    else:
        onp.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _no_dense(*arrays):
    """None of these sparse arrays built its dense form."""
    for a in arrays:
        assert a._dense_cache is None, type(a).__name__


def test_csr_round_trip():
    mat = _rand_csr(6, 8)
    a = tsp.csr_matrix((mat.data, mat.indices, mat.indptr), shape=mat.shape,
                       ctx="cpu")
    r = jsp.csr_matrix((mat.data, mat.indices, mat.indptr), shape=mat.shape)
    _close(a.asnumpy(), r.asnumpy(), exact=True)
    assert a.stype == "csr" and a.shape == (6, 8)
    assert (a.asscipy() != mat).nnz == 0
    b = tsp.csr_matrix(mat.toarray(), ctx="cpu")
    _close(b.asnumpy(), jsp.csr_matrix(mat.toarray()).asnumpy(), exact=True)
    for name in ("data", "indices", "indptr"):
        _close(getattr(b, name).asnumpy(), getattr(r, name).asnumpy(),
               exact=True)
    assert b.indices.dtype == b.indptr.dtype == torch.int32
    assert a.context == torch.device("cpu")


def test_csr_tostype_and_slice():
    mat = _rand_csr(6, 4)
    a, r = tsp.csr_matrix(mat, ctx="cpu"), jsp.csr_matrix(mat)
    dense = a.tostype("default")
    assert dense.stype == "default" and type(dense) is tmx.nd.NDArray
    _close(dense.asnumpy(), r.tostype("default").asnumpy(), exact=True)
    _close(a[1:4].asnumpy(), r[1:4].asnumpy(), exact=True)
    _close(a[-1].asnumpy(), r[-1].asnumpy(), exact=True)
    rsp = a.tostype("row_sparse")
    assert rsp.stype == "row_sparse"
    _close(rsp.asnumpy(), r.tostype("row_sparse").asnumpy(), exact=True)
    with pytest.raises(IndexError):
        a[10]
    with pytest.raises(IndexError):
        a[-9]


@pytest.mark.parametrize("transpose_b", [False, True])
def test_csr_dot_dense(transpose_b):
    mat = _rand_csr(5, 7)
    rng = onp.random.default_rng(1)
    rhs = rng.standard_normal((3, 7) if transpose_b else (7, 3)).astype(
        onp.float32)
    a = tsp.csr_matrix(mat, ctx="cpu")
    out = tsp.dot(a, tmx.nd.array(rhs, ctx="cpu"), transpose_b=transpose_b)
    ref = jsp.dot(jsp.csr_matrix(mat), jmx.nd.array(rhs),
                  transpose_b=transpose_b)
    assert type(out) is tmx.nd.NDArray
    _close(out.asnumpy(), ref.asnumpy())
    _no_dense(a)


def test_csr_transposed_dot_is_row_sparse():
    mat = _rand_csr(5, 9, density=0.2, seed=3)
    rhs = onp.random.default_rng(2).standard_normal((5, 2)).astype(
        onp.float32)
    a = tsp.csr_matrix(mat, ctx="cpu")
    out = tsp.dot(a, tmx.nd.array(rhs, ctx="cpu"), transpose_a=True)
    ref = jsp.dot(jsp.csr_matrix(mat), jmx.nd.array(rhs), transpose_a=True)
    assert out.stype == "row_sparse" and out.shape == (9, 2)
    _close(out.asnumpy(), ref.asnumpy())
    # the stored rows are the csr's distinct columns, sorted
    assert out.indices.asnumpy().tolist() == sorted(set(mat.indices))
    _no_dense(a)
    # a vector stays dense, as in the reference
    v = onp.random.default_rng(3).standard_normal(5).astype(onp.float32)
    outv = tsp.dot(a, tmx.nd.array(v, ctx="cpu"), transpose_a=True)
    _close(outv.asnumpy(), jsp.dot(jsp.csr_matrix(mat), jmx.nd.array(v),
                                   transpose_a=True).asnumpy())


def test_sparse_dot_vector():
    mat = _rand_csr(5, 7)
    v = onp.random.default_rng(9).standard_normal(7).astype(onp.float32)
    out = tsp.dot(tsp.csr_matrix(mat, ctx="cpu"), tmx.nd.array(v, ctx="cpu"))
    assert out.shape == (5,)
    _close(out.asnumpy(), jsp.dot(jsp.csr_matrix(mat),
                                  jmx.nd.array(v)).asnumpy())


def test_dot_other_storage_goes_through_dense():
    mat = _rand_csr(4, 4, seed=5)
    rs = tsp.row_sparse_array(mat.toarray(), ctx="cpu")
    d = onp.random.default_rng(4).standard_normal((4, 3)).astype(onp.float32)
    out = tsp.dot(rs, tmx.nd.array(d, ctx="cpu"))
    ref = jsp.dot(jsp.row_sparse_array(mat.toarray()), jmx.nd.array(d))
    _close(out.asnumpy(), ref.asnumpy())


def test_row_sparse_basics():
    dense = onp.zeros((6, 3), onp.float32)
    dense[1] = [1, 2, 3]
    dense[4] = [4, 5, 6]
    rs = tsp.row_sparse_array(dense, ctx="cpu")
    assert rs.stype == "row_sparse"
    assert rs.indices.asnumpy().tolist() == [1, 4]
    _close(rs.asnumpy(), dense, exact=True)
    rs2 = tsp.row_sparse_array(([[1.0, 1, 1]], [2]), shape=(5, 3), ctx="cpu")
    ref2 = jsp.row_sparse_array(([[1.0, 1, 1]], [2]), shape=(5, 3))
    _close(rs2.asnumpy(), ref2.asnumpy(), exact=True)
    assert rs2.dtype == torch.float32


def test_row_sparse_add_and_retain():
    def build(spm, mx, ctx):
        kw = {"ctx": ctx} if ctx else {}
        a = spm.row_sparse_array(([[1.0, 1]], [0]), shape=(4, 2), **kw)
        b = spm.row_sparse_array(([[2.0, 2], [3, 3]], [0, 2]), shape=(4, 2),
                                 **kw)
        return a, b
    a, b = build(tsp, tmx, "cpu")
    ra, rb = build(jsp, jmx, None)
    c, rc = tsp.add(a, b), jsp.add(ra, rb)
    assert c.stype == "row_sparse"
    _close(c.asnumpy(), rc.asnumpy(), exact=True)
    assert c.indices.asnumpy().tolist() == [0, 2]
    r, rr = tsp.retain(b, [2]), jsp.retain(rb, [2])
    assert r.indices.asnumpy().tolist() == [2]
    _close(r.asnumpy(), rr.asnumpy(), exact=True)
    r2 = b.retain(tmx.nd.array([0.0, 3.0], ctx="cpu"))
    assert r2.indices.asnumpy().tolist() == [0]
    _no_dense(a, b, c, r, r2)
    # duplicates across the two sides sum once
    z = tsp.add(c, tsp.zeros("row_sparse", (4, 2), ctx="cpu"))
    _close(z.asnumpy(), rc.asnumpy(), exact=True)


def test_sparse_zeros():
    for stype in ("csr", "row_sparse"):
        z = tsp.zeros(stype, (3, 4), ctx="cpu")
        _close(z.asnumpy(), jsp.zeros(stype, (3, 4)).asnumpy(), exact=True)
        assert z.stype == stype
    d = tsp.zeros("default", (2, 2), ctx="cpu")
    assert d.stype == "default"


def test_csr_dense_fallback_ops():
    mat = _rand_csr(4, 4)
    a = tsp.csr_matrix(mat, ctx="cpu")
    out = tsp.add(a, tmx.nd.ones((4, 4), ctx="cpu"))
    ref = jsp.add(jsp.csr_matrix(mat), jmx.nd.ones((4, 4)))
    _close(out.asnumpy(), ref.asnumpy())


def test_sparse_inherited_ops_densify():
    mat = _rand_csr(3, 4)
    a = tsp.csr_matrix(mat, ctx="cpu")
    out = a + tmx.nd.ones((3, 4), ctx="cpu")
    assert type(out) is tmx.nd.NDArray and out.stype == "default"
    _close(out.asnumpy(), mat.toarray() + 1)
    onp.testing.assert_allclose(float(a.sum().asscalar()),
                                mat.toarray().sum(), rtol=1e-5)


def test_sparse_dense_cache_invalidation():
    rs = tsp.row_sparse_array(([[1.0, 1]], [0]), shape=(3, 2), ctx="cpu")
    first = (rs + tmx.nd.zeros((3, 2), ctx="cpu")).asnumpy()
    rs.data[:] = 5.0                     # in-place component mutation
    second = (rs + tmx.nd.zeros((3, 2), ctx="cpu")).asnumpy()
    assert second[0].tolist() == [5, 5]
    assert first[0].tolist() == [1, 1]
    rs.data = tmx.nd.full((1, 2), 7.0, ctx="cpu")      # a rebound component
    assert rs.asnumpy()[0].tolist() == [7, 7]


def test_dense_tostype_and_cast_storage():
    """A dense array converts on its device (the reference's dense
    ``tostype`` raises); back to dense it is the same array."""
    mat = _rand_csr(5, 6, seed=7).toarray()
    x = tmx.nd.array(mat, ctx="cpu")
    csr = x.tostype("csr")
    ref = jsp.csr_matrix(mat)
    for name in ("data", "indices", "indptr"):
        _close(getattr(csr, name).asnumpy(), getattr(ref, name).asnumpy(),
               exact=True)
    rsp = tmx.nd.cast_storage(x, stype="row_sparse")
    _close(rsp.indices.asnumpy(),
           jsp.row_sparse_array(mat).indices.asnumpy(), exact=True)
    _close(tmx.nd.cast_storage(csr, stype="default").asnumpy(), mat,
           exact=True)
    assert tmx.nd.cast_storage(x, stype="default") is x
    with pytest.raises(ValueError):
        x.tostype("coo")


def test_sparse_astype_and_context():
    mat = _rand_csr(4, 5, seed=8)
    a = tsp.csr_matrix(mat, ctx="cpu").astype("float16")
    r = jsp.csr_matrix(mat).astype("float16")
    assert a.dtype == torch.float16
    _close(a.asnumpy(), r.asnumpy(), exact=True)
    assert a.as_in_context("cpu") is a
    assert "CSRNDArray" in repr(a)
    with pytest.raises(tmx.MXNetError):
        a._data = torch.zeros(4, 5)
