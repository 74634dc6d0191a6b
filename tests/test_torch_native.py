"""``mxtpu_torch.native`` against ``mxtpu.native`` on the CPU.

Both libraries are libjpeg builds of the same C++ (the port's copy in
``mxtpu_torch/csrc/libmxtpu_io.cc``, built into ``build/``), so the
native reader's records are byte-equal, ``jpeg_decode`` is bit-equal,
and ``NativePipeline``'s batches (file order and shuffled, uint8 and
float32, any thread count) are bit-equal. A JPEG the port encodes and
TensorFlow decodes (the reference's ``imdecode``), and the other way
round, agree within the reference's own JPEG bounds (mean |Δ| < 2, max
≤ 16, ``tests/test_native.py``). A library that cannot be built raises
with the compiler's output; nothing falls back.
"""
import struct

import numpy as onp
import pytest
import torch

from mxtpu import native as jnat, recordio as jrec
from mxtpu.image import imdecode as tf_imdecode
from mxtpu_torch import io as tio, native as tnat, recordio as trec
from mxtpu_torch.image import imdecode

torch.set_num_threads(2)   # a CPU share for each xdist worker

N_IMAGES = 14


def photo(rng, h, w, tint):
    """A photographic-like image: gradients, a tint, seeded noise."""
    y, x = onp.mgrid[0:h, 0:w].astype(onp.float32)
    base = onp.stack([x / w * 200, y / h * 200, (x + y) / (h + w) * 200],
                     axis=-1) + onp.asarray(tint, onp.float32)
    return onp.clip(base + rng.normal(0, 8, (h, w, 3)), 0, 255).astype(
        onp.uint8)


@pytest.fixture(scope="module")
def rec_file(tmp_path_factory):
    """Records of JPEGs the port encoded, varied sizes, one multi-label."""
    path = str(tmp_path_factory.mktemp("tnative") / "data.rec")
    rng = onp.random.default_rng(0)
    w = trec.MXRecordIO(path, "w")
    for i in range(N_IMAGES):
        img = photo(rng, 20 + 3 * (i % 4), 24 + 5 * (i % 3),
                    [i * 9 % 50, 20, 40])
        label = float(i % 3) if i != 5 else [4.0, 1.0]
        w.write(trec.pack_img(trec.IRHeader(0, label, i, 0), img,
                              quality=95))
    w.close()
    return path


def test_reference_library_is_there():
    assert jnat.available(), "the reference's libmxtpu did not build"
    assert tnat.available() and tnat.backend() == "libjpeg"


def test_reader_records_byte_equal(rec_file):
    mine, ref = tnat.NativeRecordReader(rec_file), \
        jnat.NativeRecordReader(rec_file)
    assert len(mine) == len(ref) == N_IMAGES
    for i in (3, 0, 13, 7, 7):
        assert mine.read(i) == ref.read(i)
    py = trec.MXRecordIO(rec_file, "r")
    assert [mine.read(i) for i in range(N_IMAGES)] == \
        [py.read() for _ in range(N_IMAGES)]
    with pytest.raises(IndexError):
        mine.read(N_IMAGES)
    mine.close()
    ref.close()
    with pytest.raises(IOError):
        tnat.NativeRecordReader(rec_file + ".missing")


def test_reader_multipart(tmp_path):
    path = str(tmp_path / "mp.rec")
    magic = struct.pack("<I", 0xced7230a)
    w = trec.MXRecordIO(path, "w")
    for p in (b"abcd" + magic + b"efgh", b"tail", magic + magic):
        w.write(p)
    w.close()
    mine, ref = tnat.NativeRecordReader(path), jnat.NativeRecordReader(path)
    assert len(mine) == len(ref) == 3
    assert [mine.read(i) for i in range(3)] == \
        [ref.read(i) for i in range(3)]


@pytest.mark.parametrize("channels", [3, 1])
def test_jpeg_decode_bit_equal(rec_file, channels):
    r = trec.MXRecordIO(rec_file, "r")
    for _ in range(4):
        _, buf = trec.unpack(r.read())
        got = tnat.jpeg_decode(buf, channels)
        want = jnat.jpeg_decode(bytes(buf), channels)
        assert got.dtype == onp.uint8 and got.shape[2] == channels
        onp.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="decode"):
        tnat.jpeg_decode(b"\xff\xd8 not a jpeg")


def _bounds(a, b):
    diff = onp.abs(a.astype(int) - b.astype(int))
    assert a.shape == b.shape
    assert diff.mean() < 2.0, diff.mean()
    assert diff.max() <= 16, diff.max()


def test_codec_against_tensorflow_both_ways():
    rng = onp.random.default_rng(1)
    img = photo(rng, 31, 45, [30, 10, 60])
    ours = tnat.jpeg_encode(img, quality=95)
    theirs = jrec.unpack(jrec.pack_img(jrec.IRHeader(0, 0.0, 0, 0), img,
                                       quality=95))[1]
    # the port's JPEG decoded by TF and by the port, and TF's JPEG
    # decoded by the port and by TF
    for buf in (ours, theirs):
        _bounds(tf_imdecode(buf, as_numpy=True), imdecode(buf, as_numpy=True))
    with pytest.raises(ValueError, match="1 or 3"):
        tnat.jpeg_encode(onp.zeros((4, 4, 2), onp.uint8))


def test_grayscale_codec_against_tensorflow():
    """A one-channel JPEG: TF decodes with libjpeg-turbo's fast integer
    IDCT (its default ``dct_method``), the port with libjpeg's accurate
    one. They differ by a mean of 2.23 on this 16×16 image, more than
    the colour bound, and the port's pixels are the closer of the two
    to the ones encoded."""
    rng = onp.random.default_rng(1)
    img = photo(rng, 16, 16, [30, 10, 60])[..., :1]
    ours = tnat.jpeg_encode(img, quality=95)
    theirs = jrec.unpack(jrec.pack_img(jrec.IRHeader(0, 0.0, 0, 0), img,
                                       quality=95))[1]
    for buf in (ours, theirs):
        tf = tf_imdecode(buf, flag=0, as_numpy=True).astype(int)
        port = imdecode(buf, flag=0, as_numpy=True).astype(int)
        assert tf.shape == port.shape == (16, 16, 1)
        assert onp.abs(tf - port).max() <= 16
        assert onp.abs(port - img).mean() < onp.abs(tf - img).mean()


def _drain(pipe, batch):
    out = []
    while True:
        d, lab = pipe.next_batch(batch)
        if len(d) == 0:
            return out
        out.append((d.copy(), lab.copy()))


@pytest.mark.parametrize("u8", [True, False])
@pytest.mark.parametrize("shuffle,threads", [(False, 1), (False, 3),
                                             (True, 2)])
def test_pipeline_batches_bit_equal(rec_file, u8, shuffle, threads):
    kw = dict(shuffle=shuffle, seed=3, threads=threads, out_u8=u8)
    mine = tnat.NativePipeline(rec_file, 18, 22, 3, **kw)
    ref = jnat.NativePipeline(rec_file, 18, 22, 3, **kw)
    for epoch in range(2):
        got, want = _drain(mine, 5), _drain(ref, 5)
        assert len(got) == len(want) == 3
        for (gd, gl), (wd, wl) in zip(got, want):
            assert gd.dtype == (onp.uint8 if u8 else onp.float32)
            onp.testing.assert_array_equal(gd, wd)
            onp.testing.assert_array_equal(gl, wl)
        mine.reset()
        ref.reset()
    mine.close()
    ref.close()


def test_pipeline_into_a_given_buffer(rec_file):
    pipe = tnat.NativePipeline(rec_file, 8, 8, 3, out_u8=True)
    buf = onp.full((4, 8, 8, 3), 7, onp.uint8)
    data, labels = pipe.next_batch(4, buf)
    assert data.base is buf or onp.shares_memory(data, buf)
    with pytest.raises(ValueError, match="buffer"):
        pipe.next_batch(4, onp.zeros((4, 8, 8, 3), onp.float32))
    pipe.close()
    f32 = tnat.NativePipeline(rec_file, 8, 8, 3, out_u8=False)
    with pytest.raises(ValueError, match="buffer"):
        f32.next_batch(4, onp.zeros((4, 8, 8, 3), onp.uint8))
    f32.close()


@pytest.fixture
def fresh_build(monkeypatch):
    """A clean slate for the library's load (the loaded one comes back
    afterwards)."""
    monkeypatch.setattr(tnat, "_LIB", None)
    monkeypatch.setattr(tnat, "_ERROR", None)
    return monkeypatch


def test_a_failed_build_raises_with_the_compiler_output(tmp_path,
                                                        fresh_build,
                                                        rec_file):
    bad = tmp_path / "libmxtpu_io.cc"
    bad.write_text("this is not C++;\n")
    fresh_build.setattr(tnat, "_SRC", bad)
    fresh_build.setattr(tnat, "_ROOT", tmp_path)
    for call in (lambda: tnat.NativeRecordReader(rec_file),
                 lambda: tnat.jpeg_decode(b"\xff\xd8"),
                 lambda: tnat.jpeg_encode(onp.zeros((2, 2, 3), onp.uint8)),
                 lambda: tnat.NativePipeline(rec_file, 4, 4),
                 lambda: imdecode(b"\xff\xd8\xff", as_numpy=True),
                 # the native route raises; it never takes ImageIter
                 lambda: tio.ImageRecordIter(path_imgrec=rec_file,
                                             data_shape=(3, 8, 8),
                                             ctx="cpu")):
        with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
            call()
    assert not tnat.available()


def test_no_codec_raises(tmp_path, fresh_build):
    fresh_build.setattr(tnat, "_JPEG_PROBE", "#include <no_such_header.h>\n")
    fresh_build.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError,
                       match="(?s)neither is here.*no_such_header"):
        tnat.get_lib()


def test_nvjpeg_without_a_card_names_the_cause(tmp_path, fresh_build,
                                              rec_file):
    """The nvJPEG build in a process that sees no CUDA device, as a
    DataLoader worker process does: built here against a stand-in CUDA
    runtime and nvJPEG (``tests/data/nvjpeg_stub``) that fail as the
    real ones do with ``CUDA_VISIBLE_DEVICES`` empty. Decode, encode,
    ``imdecode`` and the pipeline raise naming the cause; none reports
    it as a JPEG it cannot decode."""
    import os
    import shutil
    import subprocess
    stub = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "data", "nvjpeg_stub")
    cuda = tmp_path / "cuda"
    shutil.copytree(os.path.join(stub, "include"), cuda / "include")
    (cuda / "lib64").mkdir()
    obj = str(tmp_path / "stub.o")
    subprocess.run(["g++", "-c", "-fPIC", "-I", str(cuda / "include"),
                    os.path.join(stub, "stub.cc"), "-o", obj], check=True,
                   timeout=120)
    for name in ("nvjpeg_static", "culibos", "cudart_static"):
        subprocess.run(["ar", "rcs", str(cuda / "lib64" / f"lib{name}.a"),
                        obj], check=True, timeout=60)
    fresh_build.setattr(tnat, "_ROOT", tmp_path)
    fresh_build.setattr(tnat, "_JPEG_PROBE", "#include <no_such_header.h>\n")
    fresh_build.setenv("CUDA_HOME", str(cuda))
    fresh_build.setenv("CUDA_VISIBLE_DEVICES", "")
    assert tnat.backend() == "nvjpeg"
    jpg = open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "data", "jpeg", "square.jpg"), "rb").read()
    pipe = tnat.NativePipeline(rec_file, 8, 8, threads=2, out_u8=True)
    try:
        for call in (lambda: tnat.jpeg_decode(jpg),
                     lambda: tnat.jpeg_decode(jpg, channels=1),
                     lambda: tnat.jpeg_encode(onp.zeros((4, 4, 3), onp.uint8)),
                     lambda: imdecode(jpg, as_numpy=True),
                     lambda: pipe.next_batch(4)):
            with pytest.raises(RuntimeError, match=(
                    "(?s)codec \\(nvjpeg\\) cannot run in this process: "
                    "nvJPEG needs a CUDA device.*no CUDA-capable device.*"
                    "CUDA_VISIBLE_DEVICES=''")):
                call()
    finally:
        pipe.close()


def test_jpeg_fixtures_are_libjpegs_decodes():
    """``tests/data/jpeg`` (``python -m mxtpu_torch.tools.jpeg_fixtures``)
    holds libjpeg's decodes, which a host built with nvJPEG is held
    against: each still equals this build's decode, and the reference's."""
    import glob
    import os
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "data", "jpeg")
    jpgs = sorted(glob.glob(os.path.join(root, "*.jpg")))
    assert len(jpgs) == 3
    for jpg in jpgs:
        name = jpg[:-len(".jpg")]
        with open(jpg, "rb") as f:
            buf = f.read()
        for channels, suffix in ((3, "rgb"), (1, "luma")):
            want = onp.load(f"{name}.{suffix}.npy")
            onp.testing.assert_array_equal(tnat.jpeg_decode(buf, channels),
                                           want)
            onp.testing.assert_array_equal(jnat.jpeg_decode(buf, channels),
                                           want)
        src = onp.load(f"{name}.src.npy")
        assert tnat.jpeg_encode(src, 95) == buf
