"""The port's ``.params`` container (``mxtpu_torch.serde``) against
mxtpu's, on the CPU.

The same arrays saved by both packages give the same file, byte for
byte; a file written by either loads in the other; the round-5
artifact loads with its values and dtypes; bad files raise
``MXNetError``. Both packages' ``load`` make float entries float32
(mxtpu's builds each entry with ``nd.array``), so a file loads to the
same dtypes and bytes in either.
"""
import os

import ml_dtypes
import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu_torch as tmx
from mxtpu_torch.base import MXNetError

torch.set_num_threads(2)   # a CPU share for each xdist worker

HERE = os.path.dirname(os.path.abspath(__file__))
R5 = os.path.join(HERE, "artifacts", "r5", "arrays.bin")

rng = np.random.default_rng(0)
ARRAYS = {
    "f32": rng.standard_normal((3, 4)).astype(np.float32),
    "f64": rng.standard_normal((2, 5)),
    "f16": rng.standard_normal((4,)).astype(np.float16),
    "bf16": rng.standard_normal((2, 3)).astype(ml_dtypes.bfloat16),
    "u8": rng.integers(0, 256, (5,)).astype(np.uint8),
    "i8": rng.integers(-128, 128, (2, 2)).astype(np.int8),
    "i32": rng.integers(-2 ** 31, 2 ** 31, (7,)).astype(np.int32),
    "i64": rng.integers(-2 ** 62, 2 ** 62, (3,)),
    "bool": rng.random((2, 4)) < 0.5,
    "i16": rng.integers(-300, 300, (3,)).astype(np.int16),   # f32 fallback
    "scalar": np.array(2.5, np.float32),
    "empty": np.zeros((0, 3), np.float32),
}


def _ref(a):
    """A reference NDArray with exactly this numpy array's dtype."""
    import jax.numpy as jnp
    return jmx.nd.NDArray(jnp.asarray(a))


def _port(a):
    """A port NDArray on the CPU with exactly this array's dtype."""
    if a.dtype == ml_dtypes.bfloat16:
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return tmx.nd.NDArray(t)


def _bits(x):
    """An array's dtype name and raw bytes (port or reference NDArray)."""
    if isinstance(x, tmx.nd.NDArray):
        t = x._data.contiguous()
        return str(t.dtype).split(".")[1], \
            (t.view(torch.int16) if t.dtype == torch.bfloat16 else t) \
            .numpy().tobytes()
    a = np.asarray(x._data)
    return str(a.dtype), a.tobytes()


def _as_loaded(name):
    """``ARRAYS[name]`` as ``load`` gives it back: float entries, and
    int16 (saved as float32), come back float32."""
    a = ARRAYS[name]
    return a if a.dtype.kind in "iub" and name != "i16" \
        else a.astype(np.float32)


def _files(tmp_path, data_ref, data_port):
    pr, pp = str(tmp_path / "ref.params"), str(tmp_path / "port.params")
    jmx.nd.save(pr, data_ref)
    tmx.nd.save(pp, data_port)
    return pr, pp


@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_same_bytes_for_each_dtype(tmp_path, name):
    a = ARRAYS[name]
    pr, pp = _files(tmp_path, [_ref(a)], [_port(a)])
    assert open(pr, "rb").read() == open(pp, "rb").read()


@pytest.mark.parametrize("container", ["list", "dict", "single"])
def test_same_bytes_for_each_container(tmp_path, container):
    names = sorted(ARRAYS)
    if container == "list":
        ref, port = [_ref(ARRAYS[n]) for n in names], \
            [_port(ARRAYS[n]) for n in names]
    elif container == "dict":
        ref = {n: _ref(ARRAYS[n]) for n in names}
        port = {n: _port(ARRAYS[n]) for n in names}
    else:
        ref, port = _ref(ARRAYS["f32"]), _port(ARRAYS["f32"])
    pr, pp = _files(tmp_path, ref, port)
    assert open(pr, "rb").read() == open(pp, "rb").read()
    # numpy arrays save as the reference saves them too
    pn = str(tmp_path / "np.params")
    tmx.nd.save(pn, {"w": ARRAYS["f64"], "i": ARRAYS["i32"]})
    jmx.nd.save(pr, {"w": ARRAYS["f64"], "i": ARRAYS["i32"]})
    assert open(pr, "rb").read() == open(pn, "rb").read()


def test_reference_file_loads_bit_for_bit(tmp_path):
    names = sorted(ARRAYS)
    path = str(tmp_path / "ref.params")
    jmx.nd.save(path, {n: _ref(ARRAYS[n]) for n in names})
    got, ref = tmx.nd.load(path, ctx="cpu"), jmx.nd.load(path)
    assert sorted(got) == sorted(ref) == names
    for n in names:
        want = _as_loaded(n)
        assert _bits(got[n]) == _bits(ref[n]) == \
            (str(want.dtype), np.ascontiguousarray(want).tobytes()), n
        assert got[n].shape == want.shape
        assert got[n].context == torch.device("cpu")
    jmx.nd.save(path, [_ref(ARRAYS["i64"]), _ref(ARRAYS["bf16"])])
    lst = tmx.nd.load(path, ctx="cpu")
    assert isinstance(lst, list) and len(lst) == 2
    assert [_bits(x) for x in lst] == [_bits(x) for x in jmx.nd.load(path)]
    assert _bits(lst[1]) == _bits(_port(_as_loaded("bf16")))


def test_port_file_loads_in_the_reference(tmp_path):
    """Values bit for bit, float entries as float32, in both packages'
    loads."""
    names = sorted(ARRAYS)
    path = str(tmp_path / "port.params")
    tmx.nd.save(path, {n: _port(ARRAYS[n]) for n in names})
    got, back = jmx.nd.load(path), tmx.nd.load(path, ctx="cpu")
    for n in names:
        want = _as_loaded(n)
        np.testing.assert_array_equal(got[n].asnumpy(), want)
        assert got[n].asnumpy().dtype == want.dtype, n
        assert _bits(back[n]) == _bits(got[n]), n


def test_round_trip_and_r5_artifact(tmp_path):
    path = str(tmp_path / "rt.params")
    data = {n: _port(a) for n, a in ARRAYS.items()}
    tmx.nd.save(path, data)
    back = tmx.nd.load(path, ctx="cpu")
    for n in data:
        assert _bits(back[n]) == _bits(_port(_as_loaded(n))), n
    r5 = tmx.nd.load(R5, ctx="cpu")
    np.testing.assert_array_equal(r5["w"].asnumpy(),
                                  np.arange(12, dtype=np.float32)
                                  .reshape(3, 4))
    assert r5["w"].dtype == torch.float32 and r5["idx"].dtype == torch.int32
    np.testing.assert_array_equal(r5["idx"].asnumpy(),
                                  np.arange(5, dtype=np.int32))


def test_bad_files_raise(tmp_path, monkeypatch):
    bad = str(tmp_path / "bad.params")
    with open(bad, "wb") as f:
        f.write(b"\x13\x01" + b"\x00" * 30)
    with pytest.raises(MXNetError, match="magic"):
        tmx.nd.load(bad, ctx="cpu")
    with open(bad, "wb") as f:
        f.write(b"\x12\x01")
    with pytest.raises(MXNetError, match="invalid"):
        tmx.nd.load(bad, ctx="cpu")
    good = str(tmp_path / "good.params")
    tmx.nd.save(good, [_port(ARRAYS["f32"])])
    with open(good, "rb") as f:
        raw = f.read()
    with open(bad, "wb") as f:
        f.write(raw[:-8])
    with pytest.raises(MXNetError, match="truncated"):
        tmx.nd.load(bad, ctx="cpu")
    # a sparse entry saved by the reference loads as a sparse array; cut
    # short, it raises
    sp = jmx.nd.sparse.row_sparse_array(
        (np.ones((2, 3), np.float32), np.array([0, 2])), shape=(4, 3))
    jmx.nd.save(bad, [sp])
    got = tmx.nd.load(bad, ctx="cpu")[0]
    assert got.stype == "row_sparse"
    np.testing.assert_array_equal(got.asnumpy(), sp.asnumpy())
    with open(bad, "rb") as f:
        sraw = f.read()
    with open(bad, "wb") as f:
        f.write(sraw[:-12])
    with pytest.raises(MXNetError, match="truncated"):
        tmx.nd.load(bad, ctx="cpu")
    # MXNet 1.x's own sparse storage types raise as the reference's do
    with open(bad, "wb") as f:
        f.write(raw[:28] + (1).to_bytes(4, "little") + raw[32:])
    with pytest.raises(MXNetError, match="sparse"):
        tmx.nd.load(bad, ctx="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tmx.nd.load(good)
    with pytest.raises(TypeError, match="cannot save"):
        tmx.nd.save(bad, [object()])


def _sparse_pair(seed):
    """The same CSR and row-sparse arrays in both packages."""
    import scipy.sparse as sps
    mat = sps.random(6, 9, density=0.3, random_state=seed, dtype=np.float32,
                     format="csr")
    rows = np.random.default_rng(seed).standard_normal((3, 2, 2)).astype(
        np.float32)
    idx = np.array([0, 3, 5], np.int32)
    ref = {"csr": jmx.nd.sparse.csr_matrix(mat),
           "rsp": jmx.nd.sparse.row_sparse_array((rows, idx), shape=(7, 2, 2)),
           "dense": _ref(ARRAYS["f32"])}
    port = {"csr": tmx.nd.sparse.csr_matrix(mat, ctx="cpu"),
            "rsp": tmx.nd.sparse.row_sparse_array((rows, idx), shape=(7, 2, 2),
                                                  ctx="cpu"),
            "dense": _port(ARRAYS["f32"])}
    return ref, port


def test_sparse_entries_match_mxtpu_byte_for_byte(tmp_path):
    """Sparse ``.params`` entries (storage types 1001/1002): the port's
    file is the reference's byte for byte, and each package loads the
    other's to the same components."""
    ref, port = _sparse_pair(4)
    fr, fp = str(tmp_path / "ref.params"), str(tmp_path / "port.params")
    jmx.nd.save(fr, ref)
    tmx.nd.save(fp, port)
    with open(fr, "rb") as a, open(fp, "rb") as b:
        assert a.read() == b.read()
    back = tmx.nd.load(fr, ctx="cpu")
    rback = jmx.nd.load(fp)
    for k in ("csr", "rsp"):
        assert back[k].stype == rback[k].stype == port[k].stype
        assert back[k].shape == port[k].shape
        np.testing.assert_array_equal(back[k].asnumpy(), ref[k].asnumpy())
        np.testing.assert_array_equal(rback[k].asnumpy(), ref[k].asnumpy())
        assert back[k].data.asnumpy().tobytes() == \
            np.asarray(ref[k].data.asnumpy()).tobytes()
        assert back[k].indices.dtype == torch.int32
    np.testing.assert_array_equal(back["csr"].indptr.asnumpy(),
                                  np.asarray(ref["csr"].indptr.asnumpy()))
    # a list without names, saved again, is the same file
    tmx.nd.save(fp, [back["csr"], back["rsp"]])
    jmx.nd.save(fr, [ref["csr"], ref["rsp"]])
    with open(fr, "rb") as a, open(fp, "rb") as b:
        assert a.read() == b.read()
