"""``mxtpu_torch.gluon.data`` against ``mxtpu.gluon.data`` (reference
``tests/test_gluon_data.py``): datasets, samplers and the DataLoader
(one process, threads, and worker processes) give the reference's
batches; the vision datasets the same arrays; every transform the same
images after one ``np.random.seed`` (equal, ``Resize`` within one unit
of a uint8 image and 1e-5 of the largest float); ``DevicePrefetcher``
on the CPU device the source's stream bit for bit. Every wait is
bounded: workers get 120 s, the dead-worker test its own deadline."""
import os

import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu_torch as tmx
from mxtpu_torch.gluon import data as tdata
from mxtpu_torch.gluon.data.vision import transforms as tt

torch.set_num_threads(2)

jdata = jmx.gluon.data
jt = jmx.gluon.data.vision.transforms


def arrays(batch):
    if isinstance(batch, (list, tuple)):
        return [b.asnumpy() for b in batch]
    return [batch.asnumpy()]


def test_datasets_and_samplers_match_mxtpu():
    X = np.random.default_rng(0).standard_normal((10, 3)).astype("float32")
    y = np.arange(10).astype("float32")
    for ds in (tdata.ArrayDataset(tmx.nd.array(X, ctx="cpu"),
                                  tmx.nd.array(y, ctx="cpu")),
               tdata.ArrayDataset(X, y)):
        assert len(ds) == 10
        np.testing.assert_array_equal(np.asarray(
            ds[3][0].asnumpy() if hasattr(ds[3][0], "asnumpy")
            else ds[3][0]), X[3])
        assert float(ds[3][1]) == 3.0
    t = tdata.ArrayDataset(X, y).transform_first(lambda x: x * 2)
    np.testing.assert_array_equal(t[1][0], X[1] * 2)
    assert len(tdata.SimpleDataset(list(range(7))).filter(
        lambda v: v % 2).take(2)) == 2
    assert list(tdata.SequentialSampler(5)) == [0, 1, 2, 3, 4]
    for last in ("keep", "discard", "rollover"):
        mine = tdata.BatchSampler(tdata.SequentialSampler(5), 2, last)
        ref = jdata.BatchSampler(jdata.SequentialSampler(5), 2, last)
        assert [list(mine), list(mine)] == [list(ref), list(ref)]
        assert len(mine) == len(ref)
    np.random.seed(4)
    mine = list(tdata.RandomSampler(9))
    np.random.seed(4)
    assert mine == list(jdata.RandomSampler(9))
    # ported: it opens the file (test_torch_io.py reads records with it)
    with pytest.raises(FileNotFoundError):
        tdata.RecordFileDataset("x.rec")


@pytest.mark.parametrize("kw", [dict(), dict(num_workers=2,
                                             thread_pool=True)])
def test_dataloader_matches_mxtpu(kw):
    X = np.random.default_rng(1).standard_normal((10, 3)).astype("float32")
    y = np.arange(10).astype("float32")
    got, want = [], []
    for data, out, at in ((tdata, got, dict(ctx="cpu")),
                          (jdata, want, {})):
        np.random.seed(2)
        for last in ("keep", "discard"):
            loader = data.DataLoader(data.ArrayDataset(X, y), batch_size=4,
                                     shuffle=True, last_batch=last,
                                     **kw, **at)
            out.extend(arrays(b) for b in loader)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tdata.DataLoader(tdata.ArrayDataset(X, y))


@pytest.mark.parametrize("kw", [dict(), dict(num_workers=2,
                                             thread_pool=True),
                                dict(num_workers=2, timeout=120)])
def test_batches_land_where_mxtpu_puts_them(monkeypatch, kw):
    """The reference's batches land on its default device, and so do
    the port's (the meta device stands in for the card here), in one
    process, from threads and from worker processes; ``ctx="cpu"`` and
    ``pin_memory=True`` (a DevicePrefetcher's input) keep them on the
    host (with worker processes, ``ctx="cpu"`` is
    ``test_worker_processes_match_one_process``'s)."""
    X = np.random.default_rng(1).standard_normal((8, 3)).astype("float32")
    y = np.arange(8).astype("float32")
    ref = next(iter(jdata.DataLoader(jdata.ArrayDataset(X, y),
                                     batch_size=4, **kw)))
    assert all(b.context == jmx.context.current_context() for b in ref)
    monkeypatch.setattr(tmx.context, "default_device",
                        lambda: torch.device("meta"))
    cases = [(dict(), "meta"), (dict(pin_memory=True), "cpu")]
    if "timeout" not in kw:
        cases.append((dict(ctx="cpu"), "cpu"))
    for at, where in cases:
        loader = tdata.DataLoader(tdata.ArrayDataset(X, y), batch_size=4,
                                  **kw, **at)
        got = next(iter(loader))
        assert [b._data.device.type for b in got] == [where] * 2, at
        assert [tuple(b.shape) for b in got] == [(4, 3), (4,)]
        if where == "cpu":
            for a, b in zip(got, ref):
                np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
        loader._restart_pool()


class _PidDataset(tdata.ArrayDataset):
    """Picklable at module level: the worker processes receive it."""

    def __getitem__(self, idx):
        x, y = super().__getitem__(idx)
        return x, np.float32(os.getpid())


class _DeviceDataset(tdata.Dataset):
    """Samples that live off the host (the meta device stands in for
    the card): worker processes must refuse them."""

    def __len__(self):
        return 4

    def __getitem__(self, idx):
        return tmx.nd.NDArray(torch.empty(2, device="meta"))


def test_worker_processes_match_one_process():
    X = np.random.default_rng(0).standard_normal((25, 3)).astype("float32")
    ds = _PidDataset(X, np.arange(25, dtype="float32"))
    single = list(tdata.DataLoader(ds, batch_size=4, ctx="cpu"))
    loader = tdata.DataLoader(ds, batch_size=4, num_workers=2, timeout=120,
                              ctx="cpu")
    multi = list(loader)
    assert len(single) == len(multi) == 7
    pids = set()
    for s, m in zip(single, multi):
        np.testing.assert_array_equal(s[0].asnumpy(), m[0].asnumpy())
        pids.update(m[1].asnumpy().astype(np.int64).tolist())
    assert os.getpid() not in pids and pids
    # a shuffled epoch on the same workers covers every sample once
    loader._batch_sampler = tdata.BatchSampler(tdata.RandomSampler(25), 3)
    seen = []
    for xb, yb in loader:
        assert xb.shape[1:] == (3,)
        seen.extend(xb.asnumpy()[:, 0].tolist())
    assert sorted(seen) == sorted(X[:, 0].tolist())
    loader._restart_pool()
    with pytest.raises(ValueError, match="CUDA tensors"):
        list(tdata.DataLoader(_DeviceDataset(), batch_size=2,
                              num_workers=2))


class _DyingDataset(tdata.Dataset):
    """Every sample kills the worker process that loads it (the
    parent's probe of index 0 loads normally)."""

    def __init__(self):
        self.parent = os.getpid()

    def __len__(self):
        return 4

    def __getitem__(self, idx):
        if os.getpid() != self.parent:
            os._exit(7)
        return np.float32(idx)


def test_dead_worker_is_reported_after_one_restart():
    """The first timeout restarts the pool and resubmits; the second
    raises, naming the dead worker's exit code. The worker has booted
    before the short deadline starts."""
    loader = tdata.DataLoader(_DyingDataset(), batch_size=2, num_workers=1,
                              timeout=120, ctx="cpu")
    assert loader._pool.apply_async(os.getpid).get(120) != os.getpid()
    loader._timeout = 3
    with pytest.raises(RuntimeError, match="-> 7"):
        list(loader)
    loader._restart_pool()


def test_vision_datasets_match_mxtpu():
    from mxtpu_torch.gluon.data.vision import CIFAR100, MNIST
    pairs = ((MNIST(train=True, synthetic=True, synthetic_size=16),
              jdata.vision.MNIST(train=True, synthetic=True,
                                 synthetic_size=16)),
             (CIFAR100(train=False, synthetic=True, synthetic_size=8),
              jdata.vision.CIFAR100(train=False, synthetic=True,
                                    synthetic_size=8)))
    for mine, ref in pairs:
        assert len(mine) == len(ref)
        for i in (0, 5):
            np.testing.assert_array_equal(mine[i][0].asnumpy(),
                                          ref[i][0].asnumpy())
            assert mine[i][1] == ref[i][1]
    img, label = pairs[0][0][0]
    assert img.shape == (28, 28, 1) and str(img.dtype) == "torch.uint8"
    ds = pairs[0][0].transform_first(tt.ToTensor())
    xb, yb = next(iter(tdata.DataLoader(ds, batch_size=8, ctx="cpu")))
    assert xb.shape == (8, 1, 28, 28) and xb.dtype == torch.float32


def test_image_folder_reads_npy(tmp_path):
    from mxtpu_torch.gluon.data.vision import ImageFolderDataset
    for c, cls in enumerate(("cat", "dog")):
        (tmp_path / cls).mkdir()
        np.save(tmp_path / cls / "a.npy", np.full((2, 2, 3), c, np.uint8))
    (tmp_path / "dog" / "b.jpg").write_bytes(b"")
    ds = ImageFolderDataset(str(tmp_path))
    assert ds.synsets == ["cat", "dog"] and len(ds) == 3
    img, label = ds[1]
    assert label == 1 and int(img.asnumpy().max()) == 1
    # decoding is ported (test_torch_io.py reads JPEG and PNG folders):
    # an empty .jpg is no image
    with pytest.raises(ValueError, match="JPEG and PNG"):
        ds[2]


IMG = np.random.default_rng(5).integers(0, 256, (37, 45, 3)).astype("uint8")


@pytest.mark.parametrize("name,kw", [
    ("Resize", dict(size=(20, 16))), ("Resize", dict(size=(64, 80))),
    ("Resize", dict(size=24)), ("CenterCrop", dict(size=20)),
    ("CenterCrop", dict(size=50)), ("RandomCrop", dict(size=16, pad=2)),
    ("RandomResizedCrop", dict(size=16)), ("RandomFlipLeftRight", dict()),
    ("RandomFlipTopBottom", dict()), ("RandomBrightness",
                                      dict(brightness=0.3)),
    ("RandomContrast", dict(contrast=0.3)), ("ToTensor", dict()),
    ("Cast", dict(dtype="float16")),
])
def test_transforms_match_mxtpu(name, kw):
    outs = []
    for mod, mx, ctx in ((jt, jmx, None), (tt, tmx, "cpu")):
        np.random.seed(3)
        t = getattr(mod, name)(**kw)
        for img in (IMG, IMG.astype("float32")):
            x = mx.nd.array(img, dtype=img.dtype) if ctx is None else \
                mx.nd.array(img, dtype=img.dtype, ctx=ctx)
            outs.append([t(x).asnumpy().astype(np.float64)
                         for _ in range(3)])
    for k, (g, w) in enumerate(zip(outs[2:], outs[:2])):
        for a, b in zip(g, w):
            assert a.shape == b.shape, (name, a.shape, b.shape)
            if name in ("Resize", "RandomResizedCrop", "CenterCrop"):
                # uint8 outputs truncate, so a float rounding an ulp
                # away can cost one unit
                tol = 1.0 if k == 0 else 1e-5 * np.abs(b).max()
                np.testing.assert_allclose(a, b, rtol=0, atol=tol)
            else:
                np.testing.assert_array_equal(a, b)


def test_normalize_and_compose_match_mxtpu():
    x = np.random.RandomState(0).rand(3, 8, 8).astype(np.float32)
    mean, std = (0.5, 0.4, 0.3), (0.5, 0.5, 0.5)
    got = tt.Normalize(mean, std)(tmx.nd.array(x, ctx="cpu")).asnumpy()
    want = jt.Normalize(mean, std)(jmx.nd.array(x)).asnumpy()
    np.testing.assert_array_equal(got, want)
    comp = tt.Compose([tt.ToTensor(), tt.Normalize(0.5, 0.5)])
    ref = jt.Compose([jt.ToTensor(), jt.Normalize(0.5, 0.5)])
    np.testing.assert_array_equal(
        comp(tmx.nd.array(IMG, dtype="uint8", ctx="cpu")).asnumpy(),
        ref(jmx.nd.array(IMG, dtype="uint8")).asnumpy())


def test_prefetcher_is_the_source_stream():
    batches = [{"image": np.random.default_rng(i).integers(
                    0, 255, (4, 8, 8, 3)).astype(np.uint8),
                "label": (np.arange(4) + i).astype(np.int32),
                "nd": [tmx.nd.array(np.full(2, i), ctx="cpu")]}
               for i in range(6)]
    with tdata.DevicePrefetcher(iter(list(batches)), device="cpu") as pf:
        got = list(pf)
    assert len(got) == len(batches)
    for ref, dev in zip(batches, got):
        assert isinstance(dev["image"], torch.Tensor)
        np.testing.assert_array_equal(ref["image"], dev["image"].numpy())
        np.testing.assert_array_equal(ref["label"], dev["label"].numpy())
        np.testing.assert_array_equal(ref["nd"][0].asnumpy(),
                                      dev["nd"][0].asnumpy())
    loader = tdata.DataLoader(tdata.ArrayDataset(
        np.arange(10, dtype="float32"), np.arange(10, dtype="float32")),
        batch_size=4, ctx="cpu")
    pf = tdata.DevicePrefetcher(loader, device="cpu")
    for _ in range(2):                          # reset() restarts cleanly
        assert [b[1].asnumpy().tolist() for b in pf] == \
            [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9]]
        pf.reset()
    pf.close()


def test_prefetcher_close_errors_and_reset():
    closed = {"flag": False}

    class Source:
        def __iter__(self):
            return iter([{"x": np.full((2, 2), i, np.float32)}
                         for i in range(100)])

        def close(self):
            closed["flag"] = True

    pf = tdata.DevicePrefetcher(Source(), device="cpu")
    it = iter(pf)
    np.testing.assert_array_equal(next(it)["x"].numpy(), np.zeros((2, 2)))
    pf.close()                                  # mid-epoch
    assert pf._thread is None and closed["flag"]
    with pytest.raises(RuntimeError):
        next(it)
    pf.close()

    def bad():
        yield {"x": np.zeros(2, np.float32)}
        raise ValueError("decode exploded")

    it = iter(tdata.DevicePrefetcher(bad(), device="cpu"))
    next(it)
    with pytest.raises(ValueError, match="decode exploded"):
        next(it)
    pf = tdata.DevicePrefetcher(iter([{"x": np.zeros(2, np.float32)}
                                      for _ in range(50)]), device="cpu")
    next(iter(pf))
    with pytest.raises(RuntimeError, match="reset"):
        pf.reset()
    pf.close()

    # an mx.io source: each DataBatch comes out whole, its arrays moved
    from mxtpu_torch import io as tio
    src = tio.NDArrayIter(np.arange(6, dtype=np.float32).reshape(3, 2),
                          np.arange(3, dtype=np.float32), batch_size=2,
                          ctx="cpu")
    got = list(tdata.DevicePrefetcher(src, device="cpu"))
    assert [b.pad for b in got] == [0, 1]
    assert got[1].data[0].asnumpy().tolist() == [[4, 5], [0, 1]]
    assert got[0].label[0].asnumpy().tolist() == [0, 1]
