"""``mxtpu_torch.io``'s array iterators on the CPU against ``mxtpu.io``.

The reference's own cases (``tests/test_io.py``, the iterators that
read no image: ``NDArrayIter`` with pad, discard, roll_over and
shuffle, dict inputs, ``CSVIter``, ``LibSVMIter``, ``MNISTIter``,
``PrefetchingIter``, ``ResizeIter``) run through the port, and every
case drains both packages' iterators over the same numpy inputs, after
the same ``np.random.seed`` where they shuffle: each batch's data,
labels, pad and index equal, bit for bit. The image iterators raise,
naming the later sub-item of ROADMAP Queue A item 10.4. Every wait is
bounded (``io.PREFETCH_TIMEOUT_S``).
"""
import gzip
import struct

import numpy as onp
import pytest
import torch

from mxtpu import io as jio
from mxtpu_torch import io as tio

torch.set_num_threads(2)   # a CPU share for each xdist worker

CPU = {"ctx": "cpu"}


def _drain(it, epochs=1):
    """Every batch of ``epochs`` passes as numpy: (data, label, pad,
    index), with a reset between passes."""
    out = []
    for e in range(epochs):
        if e:
            it.reset()
        for b in it:
            out.append(([d.asnumpy() for d in b.data],
                        [lab.asnumpy() for lab in (b.label or [])],
                        b.pad, None if b.index is None
                        else onp.asarray(b.index)))
    return out


def _same(port, ref):
    assert len(port) == len(ref)
    for (pd, pl, pp, pi), (rd, rl, rp, ri) in zip(port, ref):
        for a, b in zip(pd + pl, rd + rl):
            assert a.shape == b.shape and a.dtype == b.dtype
            onp.testing.assert_array_equal(a, b)
        assert pp == rp
        if ri is None:
            assert pi is None
        else:
            onp.testing.assert_array_equal(pi, ri)


def _both(make, epochs=1, seed=None):
    """``make(io, kw)`` built in each package (kw: the port's ctx), both
    drained after the same numpy seed; returns the port's batches."""
    got = []
    for io, kw in ((tio, CPU), (jio, {})):
        if seed is not None:
            onp.random.seed(seed)
        got.append(_drain(make(io, kw), epochs))
    _same(*got)
    return got[0]


def test_ndarrayiter_basic():
    data = onp.arange(20, dtype=onp.float32).reshape(10, 2)
    label = onp.arange(10, dtype=onp.float32)
    batches = _both(lambda io, kw: io.NDArrayIter(
        data, label, batch_size=4, last_batch_handle="pad", **kw), 2)
    assert len(batches) == 6
    assert batches[0][0][0].shape == (4, 2)
    assert batches[2][2] == 2
    # pad wraps to the head
    onp.testing.assert_allclose(batches[2][0][0][2:], data[:2])


def test_ndarrayiter_discard_and_shuffle():
    data = onp.arange(10, dtype=onp.float32).reshape(10, 1)
    batches = _both(lambda io, kw: io.NDArrayIter(
        data, None, batch_size=3, last_batch_handle="discard",
        shuffle=True, **kw), 2, seed=3)
    assert len(batches) == 6
    seen = onp.concatenate([b[0][0].ravel() for b in batches[:3]])
    assert len(set(seen.tolist())) == 9


def test_ndarrayiter_dict_inputs():
    def make(io, kw):
        return io.NDArrayIter({"a": onp.zeros((6, 2)), "b": onp.ones((6, 3))},
                              {"softmax_label": onp.arange(6)},
                              batch_size=2, **kw)
    it = make(tio, CPU)
    assert [d.name for d in it.provide_data] == ["a", "b"]
    assert it.provide_data[0].shape == (2, 2)
    assert [tuple(d) for d in it.provide_data] == \
        [tuple(d) for d in make(jio, {}).provide_data]
    b = next(it)
    assert b.data[1].shape == (2, 3)
    _both(make)


def test_ndarrayiter_roll_over():
    data = onp.arange(10, dtype=onp.float32).reshape(10, 1)
    batches = _both(lambda io, kw: io.NDArrayIter(
        data, None, batch_size=4, last_batch_handle="roll_over", **kw), 2)
    # only whole batches in the first epoch; the tail (8, 9) rolls over
    assert len(batches) == 5 and all(b[2] == 0 for b in batches)
    onp.testing.assert_allclose(batches[2][0][0].ravel(), [8, 9, 0, 1])


def test_roll_over_with_shuffle_serves_heldover_samples():
    data = onp.arange(10, dtype=onp.float32).reshape(10, 1)
    batches = _both(lambda io, kw: io.NDArrayIter(
        data, None, batch_size=4, shuffle=True,
        last_batch_handle="roll_over", **kw), 2, seed=5)
    served = set(onp.concatenate([b[0][0].ravel()
                                  for b in batches[:2]]).tolist())
    heldover = set(range(10)) - served
    assert len(heldover) == 2
    # the rolled batch starts with exactly the held-over samples, and
    # its index is the data served
    rolled = batches[2]
    assert set(rolled[0][0].ravel()[:2].tolist()) == heldover
    onp.testing.assert_array_equal(rolled[0][0].ravel(),
                                   data[rolled[3]].ravel())


def test_csviter(tmp_path):
    data = onp.random.default_rng(0).standard_normal((8, 3)).astype(
        onp.float32)
    labels = onp.arange(8, dtype=onp.float32)
    dpath = str(tmp_path / "d.csv")
    lpath = str(tmp_path / "l.csv")
    onp.savetxt(dpath, data, delimiter=",")
    onp.savetxt(lpath, labels, delimiter=",")
    batches = _both(lambda io, kw: io.CSVIter(
        data_csv=dpath, data_shape=(3,), label_csv=lpath, batch_size=3,
        **kw))
    onp.testing.assert_allclose(batches[0][0][0], data[:3], rtol=1e-5)
    onp.testing.assert_allclose(batches[0][1][0], labels[:3])
    assert batches[-1][2] == 1


def test_libsvmiter(tmp_path):
    p = str(tmp_path / "data.svm")
    with open(p, "w") as f:
        f.write("1 0:1.5 3:2.0\n0 1:1.0\n1 2:3.0\n")
    batches = _both(lambda io, kw: io.LibSVMIter(
        data_libsvm=p, data_shape=(4,), batch_size=3, round_batch=False,
        **kw))
    onp.testing.assert_allclose(
        batches[0][0][0], [[1.5, 0, 0, 2.0], [0, 1.0, 0, 0], [0, 0, 3.0, 0]])
    onp.testing.assert_allclose(batches[0][1][0], [1, 0, 1])


def test_mnistiter(tmp_path):
    rng = onp.random.default_rng(1)
    images = rng.integers(0, 256, (7, 4, 4)).astype(onp.uint8)
    labels = rng.integers(0, 10, 7).astype(onp.uint8)
    ipath, lpath = str(tmp_path / "i.idx.gz"), str(tmp_path / "l.idx")
    with gzip.open(ipath, "wb") as f:
        f.write(struct.pack(">I", 0x0803) + struct.pack(">3I", 7, 4, 4)
                + images.tobytes())
    with open(lpath, "wb") as f:
        f.write(struct.pack(">I", 0x0801) + struct.pack(">I", 7)
                + labels.tobytes())
    for flat in (False, True):
        batches = _both(lambda io, kw: io.MNISTIter(
            image=ipath, label=lpath, batch_size=3, flat=flat,
            shuffle=True, **kw), seed=2)
        assert batches[0][0][0].shape == ((3, 16) if flat else (3, 1, 4, 4))


def test_prefetching_iter():
    data = onp.arange(40, dtype=onp.float32).reshape(20, 2)
    batches = _both(lambda io, kw: io.PrefetchingIter(
        io.NDArrayIter(data, None, batch_size=5, **kw)), 2)
    assert len(batches) == 8


def test_prefetching_iter_repeated_exhaustion():
    data = onp.arange(8, dtype=onp.float32).reshape(8, 1)
    it = tio.PrefetchingIter(tio.NDArrayIter(data, None, batch_size=4,
                                             **CPU))
    assert len(list(it)) == 2
    assert len(list(it)) == 0     # raises StopIteration again, no hang
    it.reset()
    assert len(list(it)) == 2
    it.close()


def test_prefetching_iter_waits_are_bounded(monkeypatch):
    class Stuck(tio.DataIter):
        provide_data = provide_label = []

        def next(self):
            import time
            time.sleep(2.0)
            raise StopIteration
    monkeypatch.setattr(tio, "PREFETCH_TIMEOUT_S", 0.2)
    it = tio.PrefetchingIter(Stuck())
    with pytest.raises(RuntimeError, match="no batch"):
        next(it)
    monkeypatch.setattr(tio, "PREFETCH_TIMEOUT_S", 10.0)
    it.close()


def test_resize_iter():
    data = onp.arange(20, dtype=onp.float32).reshape(10, 2)
    batches = _both(lambda io, kw: io.ResizeIter(
        io.NDArrayIter(data, None, batch_size=5, **kw), 5))
    assert len(batches) == 5


def test_databatch_and_datadesc():
    b = tio.DataBatch(data=tio.NDArrayIter(onp.zeros((2, 3)),
                                           batch_size=2, **CPU).next().data[0],
                      bucket_key=4)
    assert len(b.data) == 1 and b.label is None and b.bucket_key == 4
    assert str(b) == str(jio.DataBatch(data=[onp.zeros((2, 3))]))
    d = tio.DataDesc("data", (2, 3))
    assert d == jio.DataDesc("data", (2, 3)) and d.layout == "NCHW"
    assert tio.DataDesc.get_batch_axis("TNC") == 1


@pytest.mark.parametrize("name", ["ImageRecordIter", "NativeImageRecordIter"])
def test_image_iterators_raise(name):
    with pytest.raises(NotImplementedError, match="item 10.4"):
        getattr(tio, name)(path_imgrec="x.rec", data_shape=(3, 8, 8))
