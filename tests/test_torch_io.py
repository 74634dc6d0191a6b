"""``mxtpu_torch.io``'s array iterators on the CPU against ``mxtpu.io``.

The reference's own cases (``tests/test_io.py``, the iterators that
read no image: ``NDArrayIter`` with pad, discard, roll_over and
shuffle, dict inputs, ``CSVIter``, ``LibSVMIter``, ``MNISTIter``,
``PrefetchingIter``, ``ResizeIter``) run through the port, and every
case drains both packages' iterators over the same numpy inputs, after
the same ``np.random.seed`` where they shuffle: each batch's data,
labels, pad and index equal, bit for bit. Every wait is bounded
(``io.PREFETCH_TIMEOUT_S``).
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
    """A missing ``.rec`` raises in both packages (the native route
    opens it at once)."""
    with pytest.raises(OSError, match="x.rec"):
        getattr(jio, name)(path_imgrec="x.rec", data_shape=(3, 8, 8))
    with pytest.raises(OSError, match="x.rec"):
        getattr(tio, name)(path_imgrec="x.rec", data_shape=(3, 8, 8),
                           ctx="cpu")


# ---------------------------------------------------------------------------
# the image half: ImageRecordIter's routing, the native iterator in both
# modes, RecordFileDataset, ImageFolderDataset and im2rec
# ---------------------------------------------------------------------------
def _photo(rng, h, w):
    y, x = onp.mgrid[0:h, 0:w].astype(onp.float32)
    img = onp.stack([x / w * 180, y / h * 180, (x + y) / (h + w) * 180], -1)
    return onp.clip(img + rng.normal(0, 10, (h, w, 3)), 0, 255).astype(
        onp.uint8)


@pytest.fixture(scope="module")
def jpeg_rec(tmp_path_factory):
    """An indexed .rec of 11 JPEGs the port encoded, labels i % 4."""
    from mxtpu_torch import recordio as trec
    tmp = tmp_path_factory.mktemp("tio_img")
    rec, idx = str(tmp / "img.rec"), str(tmp / "img.idx")
    rng = onp.random.default_rng(0)
    w = trec.MXIndexedRecordIO(idx, rec, "w")
    for i in range(11):
        w.write_idx(i, trec.pack_img(trec.IRHeader(0, float(i % 4), i, 0),
                                     _photo(rng, 18 + i % 3 * 4, 20 + i % 5),
                                     quality=92))
    w.close()
    return rec


def test_image_record_iter_routing(jpeg_rec):
    kw = dict(path_imgrec=jpeg_rec, data_shape=(3, 16, 16), batch_size=4,
              ctx="cpu")
    for extra in ({}, dict(mean_r=1.0, std_b=2.0, seed=3,
                           data_name="x", device_pipeline=False)):
        it = tio.ImageRecordIter(**kw, **extra)
        assert isinstance(it, tio.NativeImageRecordIter)
        ref = jio.ImageRecordIter(**{k: v for k, v in kw.items()
                                     if k != "ctx"}, **extra)
        assert isinstance(ref, jio.NativeImageRecordIter)
        it.close()
        ref.close()
    for extra in (dict(rand_mirror=True), dict(rand_crop=True),
                  dict(label_width=2), dict(inter_method=1)):
        it = tio.ImageRecordIter(**kw, **extra)
        assert isinstance(it, tio.PrefetchingIter), extra
        it.close()
    gray = tio.ImageRecordIter(**dict(kw, data_shape=(1, 16, 16)))
    assert isinstance(gray, tio.PrefetchingIter)
    gray.close()


def _img_batches(it):
    return [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad) for b in it]


@pytest.mark.parametrize("device_pipeline", [True, False])
@pytest.mark.parametrize("shuffle", [False, True])
def test_native_iter_matches_mxtpu(jpeg_rec, device_pipeline, shuffle):
    kw = dict(path_imgrec=jpeg_rec, data_shape=(3, 14, 16), batch_size=4,
              shuffle=shuffle, seed=5, preprocess_threads=2,
              mean=[120.0, 110.0, 100.0], std=[58.0, 57.0, 56.5],
              device_pipeline=device_pipeline)
    mine = tio.NativeImageRecordIter(ctx="cpu", **kw)
    ref = jio.NativeImageRecordIter(**kw)
    for epoch in range(2):
        got, want = _img_batches(mine), _img_batches(ref)
        assert len(got) == len(want) == 3
        for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
            assert gd.dtype == onp.float32 and gd.shape == (4, 3, 14, 16)
            assert gp == wp
            onp.testing.assert_array_equal(gl, wl)
            if not device_pipeline:
                # the same f32 samples, the same numpy post: bit-equal
                onp.testing.assert_array_equal(gd, wd)
                continue
            # the same uint8 samples; XLA folds the reference's jitted
            # ``/ std`` into a multiply by the reciprocal, the port
            # divides: within one ulp, each equal to its own formula
            u8 = onp.clip(gd.transpose(0, 2, 3, 1) * kw["std"] + kw["mean"],
                          0, 255).round().astype(onp.float32)
            mean = onp.asarray(kw["mean"], onp.float32)
            std = onp.asarray(kw["std"], onp.float32)
            onp.testing.assert_array_equal(
                gd, ((u8 - mean) / std).transpose(0, 3, 1, 2))
            onp.testing.assert_array_equal(
                wd, ((u8 - mean) * (onp.float32(1) / std))
                .transpose(0, 3, 1, 2))
            ulps = onp.abs(gd.view(onp.int32).astype(onp.int64)
                           - wd.view(onp.int32))
            assert ulps.max() <= 1
        mine.reset()
        ref.reset()
    mine.close()
    ref.close()


def test_normalize_u8_is_the_host_post():
    rng = onp.random.default_rng(1)
    x = rng.integers(0, 256, (2, 5, 6, 3), dtype=onp.uint8)
    mean = onp.array([1.5, 2.0, 3.25], onp.float32)
    std = onp.array([2.0, 3.0, 0.7], onp.float32)
    got = tio.normalize_u8(torch.from_numpy(x), torch.from_numpy(mean),
                           torch.from_numpy(std)).numpy()
    want = ((x.astype(onp.float32) - mean) / std).transpose(0, 3, 1, 2)
    onp.testing.assert_array_equal(got, want)
    onp.testing.assert_array_equal(
        tio.normalize_u8(torch.from_numpy(x), None, None).numpy(),
        x.astype(onp.float32).transpose(0, 3, 1, 2))


def test_image_record_iter_python_route_matches(jpeg_rec):
    import random
    kw = dict(path_imgrec=jpeg_rec, data_shape=(3, 12, 12), batch_size=4,
              shuffle=True, rand_crop=True, rand_mirror=True,
              mean_r=120.0, mean_g=110.0, mean_b=100.0)
    outs = []
    for io, extra in ((jio, {}), (tio, CPU)):
        random.seed(2)
        it = io.ImageRecordIter(**kw, **extra)
        outs.append(_img_batches(it))
        it.close()
    for (gd, gl, gp), (wd, wl, wp) in zip(*outs[::-1]):
        assert gp == wp
        onp.testing.assert_array_equal(gl, wl)
        # libjpeg here, TF's libjpeg-turbo there: the JPEG bounds
        diff = onp.abs(gd - wd)
        assert diff.mean() < 2.0 and diff.max() <= 16


def test_record_file_dataset(jpeg_rec):
    from mxtpu import recordio as jrec
    from mxtpu_torch.gluon.data import RecordFileDataset
    ds = RecordFileDataset(jpeg_rec)
    ref = jrec.MXIndexedRecordIO(jpeg_rec[:-4] + ".idx", jpeg_rec, "r")
    assert len(ds) == len(ref.keys) == 11
    for i in (0, 10, 4):
        assert ds[i] == ref.read_idx(ref.keys[i])


def test_image_folder_dataset_decodes_jpeg_and_png(tmp_path):
    from mxtpu.gluon.data.vision import ImageFolderDataset as JFolder
    from mxtpu_torch.gluon.data.vision import ImageFolderDataset as TFolder
    from mxtpu_torch import image as timg
    rng = onp.random.default_rng(2)
    for cls in ("cat", "dog"):
        (tmp_path / cls).mkdir()
        for j in range(2):
            img = _photo(rng, 12, 15)
            (tmp_path / cls / f"{j}.png").write_bytes(
                timg.imencode(img, ".png"))
            (tmp_path / cls / f"{j}.jpg").write_bytes(
                timg.imencode(img, ".jpg", quality=90))
    for flag in (1, 0):
        mine, ref = TFolder(str(tmp_path), flag=flag), \
            JFolder(str(tmp_path), flag=flag)
        assert mine.synsets == ref.synsets and len(mine) == len(ref) == 8
        for i in range(len(mine)):
            (g, gl), (w, wl) = mine[i], ref[i]
            assert gl == wl and g.context == torch.device("cpu")
            g, w = g.asnumpy().astype(int), w.asnumpy().astype(int)
            assert g.shape == w.shape == (12, 15, 3 if flag else 1)
            if mine.items[i][0].endswith(".png"):
                onp.testing.assert_array_equal(g, w)
            else:
                assert onp.abs(g - w).max() <= 16


@pytest.mark.parametrize("codec", ["libjpeg", "nvjpeg"])
def test_image_folder_loader_workers_follow_the_codec(tmp_path, monkeypatch,
                                                      codec):
    """ImageFolderDataset of JPEGs under DataLoader(num_workers=2). With
    the codec on the host the workers are processes. With a codec on
    the card (nvJPEG, which a worker process cannot run: the card is
    hidden there) they are threads of this process; the library's
    report of its codec is stood in for here, the decode stays
    libjpeg's. Either way the batches are bit-equal to the loader's
    without workers."""
    from mxtpu_torch import image as timg, native
    from mxtpu_torch.gluon.data import DataLoader
    from mxtpu_torch.gluon.data.vision import ImageFolderDataset
    rng = onp.random.default_rng(3)
    for cls in ("cat", "dog"):
        (tmp_path / cls).mkdir()
        for j in range(4):
            (tmp_path / cls / f"{j}.jpg").write_bytes(
                timg.imencode(_photo(rng, 12, 15), ".jpg", quality=90))
    assert native.backend() == "libjpeg"
    monkeypatch.setattr(native, "backend", lambda: codec)
    ds = ImageFolderDataset(str(tmp_path))

    def batches(**kw):
        loader = DataLoader(ds, batch_size=3, ctx="cpu", timeout=60, **kw)
        return loader, [(x.asnumpy(), y.asnumpy()) for x, y in loader]
    _, want = batches()
    loader, got = batches(num_workers=2)
    assert loader.worker_kind == \
        {"libjpeg": "processes", "nvjpeg": "threads"}[codec]
    assert [x.shape for x, _ in got] == [(3, 12, 15, 3)] * 2 + \
        [(2, 12, 15, 3)]
    for (gx, gy), (wx, wy) in zip(got, want, strict=True):
        onp.testing.assert_array_equal(gx, wx)
        onp.testing.assert_array_equal(gy, wy)


def test_im2rec_matches_the_reference_tool(tmp_path):
    import os
    import subprocess
    import sys
    from mxtpu_torch import image as timg
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    root = tmp_path / "imgs"
    rng = onp.random.default_rng(3)
    for cls in ("a", "b"):
        (root / cls).mkdir(parents=True)
        for j in range(3):
            (root / cls / f"{j}.jpg").write_bytes(
                timg.imencode(_photo(rng, 10, 12 + j), ".jpg", quality=88))
        (root / cls / "skip.txt").write_text("not an image")
    env = dict(os.environ, PYTHONPATH=repo, JAX_PLATFORMS="cpu")
    out = {}
    for tag, cmd in (("ref", [sys.executable,
                              os.path.join(repo, "tools", "im2rec.py")]),
                     ("port", [sys.executable, "-m",
                               "mxtpu_torch.tools.im2rec"])):
        prefix = str(tmp_path / tag)
        for extra in (["--list", "--recursive"], []):
            res = subprocess.run(cmd + extra + [prefix, str(root)],
                                 capture_output=True, text=True, timeout=120,
                                 env=env, cwd=repo)
            assert res.returncode == 0, res.stderr[-2000:]
        out[tag] = [open(prefix + ext, "rb").read()
                    for ext in (".lst", ".rec", ".idx")]
    assert out["port"] == out["ref"]
    assert out["port"][0].count(b"\n") == 6
