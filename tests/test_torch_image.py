"""``mxtpu_torch.image`` against ``mxtpu.image`` on the CPU.

- PNG: the port's stdlib decoder is bit-equal to TensorFlow's (the
  reference's codec) on every colour type and bit depth, palettes,
  Adam7 interlacing, grey and colour outputs and BGR; TensorFlow
  decodes the port's PNGs to the pixels encoded.
- JPEG: ``imdecode``/``imread`` against TensorFlow's within the
  reference's JPEG bounds (mean |Δ| < 2, max ≤ 16).
- ``imresize``: each method (nearest, linear, cubic, lanczos3) against
  ``jax.image.resize``, within one uint8 unit (float images within
  1e-4 of the scale), as ``Resize`` is held in
  ``test_torch_gluon_data.py``.
- Every augmenter, ``CreateAugmenter``'s chains, ``ImageIter`` and
  ``ImageDetIter`` (with every Det* augmenter) after one ``random.seed``
  and ``np.random.seed``, on PNG records so that no codec difference
  enters: equal to the reference's, to float32 rounding, or within one
  uint8 unit (over the std) where a resize is in the chain.
"""
import functools
import io
import random
import zlib

import numpy as onp
import pytest
import torch

import mxtpu as jmx
from mxtpu import image as jimg
from mxtpu_torch import image as timg, recordio as trec
import mxtpu_torch as tmx

torch.set_num_threads(2)   # a CPU share for each xdist worker


def tf_png(arr):
    import tensorflow as tf
    return tf.io.encode_png(arr).numpy()


def pil_png(im, **kw):
    b = io.BytesIO()
    im.save(b, "PNG", **kw)
    return b.getvalue()


def adam7_png(img):
    """An interlaced 8-bit RGB PNG, every row unfiltered."""
    import struct

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)
    h, w, _ = img.shape
    raw = b""
    for x0, y0, dx, dy in ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8),
                           (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
                           (0, 1, 1, 2)):
        sub = img[y0::dy, x0::dx]
        if sub.size:
            for row in sub:
                raw += b"\x00" + row.tobytes()
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 1))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


PNG_CASES = ("rgb", "gray", "rgba", "gray_alpha", "rgb16", "palette8",
             "palette4", "bilevel", "gray16", "adam7", "port_rgb")


@functools.lru_cache(maxsize=1)
def png_cases():
    """Made at the first test that needs them (TF and PIL import slowly,
    and collection imports this file in every worker)."""
    from PIL import Image
    rng = onp.random.default_rng(0)
    rgb = rng.integers(0, 256, (13, 21, 3), dtype=onp.uint8)
    return {
        "rgb": tf_png(rgb), "gray": tf_png(rgb[..., :1]),
        "rgba": tf_png(rng.integers(0, 256, (13, 21, 4), dtype=onp.uint8)),
        "gray_alpha": tf_png(rng.integers(0, 256, (13, 21, 2),
                                          dtype=onp.uint8)),
        "rgb16": tf_png(rng.integers(0, 65536, (9, 7, 3), dtype=onp.uint16)),
        "palette8": pil_png(Image.fromarray(rgb).quantize(50)),
        "palette4": pil_png(Image.fromarray(rgb).quantize(12), bits=4),
        "bilevel": pil_png(Image.fromarray(rgb[..., 0] > 128)),
        "gray16": pil_png(Image.fromarray(
            rng.integers(0, 65536, (5, 9)).astype(onp.uint16))),
        "adam7": adam7_png(rng.integers(0, 256, (11, 14, 3),
                                        dtype=onp.uint8)),
        "port_rgb": timg.imencode(rgb, ".png"),
    }


@pytest.mark.parametrize("case", PNG_CASES)
def test_png_decode_bit_equal_to_tensorflow(case):
    assert set(png_cases()) == set(PNG_CASES)
    buf = png_cases()[case]
    for flag in (1, 0):
        for to_rgb in (True, False):
            want = jimg.imdecode(buf, flag=flag, to_rgb=to_rgb,
                                 as_numpy=True)
            got = timg.imdecode(buf, flag=flag, to_rgb=to_rgb,
                                as_numpy=True)
            assert got.dtype == onp.uint8 and got.shape == want.shape
            onp.testing.assert_array_equal(got, want, err_msg=case)


@pytest.mark.parametrize("shape", [(7, 9, 3), (6, 5, 1), (4, 3, 4),
                                   (5, 4, 2)])
def test_png_encode_decodes_to_its_pixels(shape):
    img = onp.random.default_rng(1).integers(0, 256, shape, dtype=onp.uint8)
    buf = timg.imencode(img, ".png")
    import tensorflow as tf
    # TF decodes 1, 3 or 4 channels: grey+alpha comes back as RGBA
    want = img if shape[2] != 2 else onp.concatenate(
        [onp.repeat(img[..., :1], 3, axis=2), img[..., 1:]], axis=2)
    onp.testing.assert_array_equal(
        tf.io.decode_image(buf, channels=want.shape[2]).numpy(), want)
    if shape[2] in (1, 3):
        onp.testing.assert_array_equal(
            timg.imdecode(buf, flag=0 if shape[2] == 1 else 1,
                          as_numpy=True), img)
    with pytest.raises(ValueError, match="format"):
        timg.imencode(img, ".bmp")


def test_jpeg_imdecode_and_imread_against_tensorflow(tmp_path):
    y, x = onp.mgrid[0:40, 0:56].astype(onp.float32)
    rng = onp.random.default_rng(2)
    img = onp.clip(onp.stack([x * 4, y * 5, x + y], -1)
                   + rng.normal(0, 6, (40, 56, 3)), 0, 255).astype(onp.uint8)
    for buf in (timg.imencode(img, ".jpg", quality=90),
                jimg.imencode(img, ".jpg", quality=90)):
        for to_rgb in (True, False):
            want = jimg.imdecode(buf, to_rgb=to_rgb, as_numpy=True)
            got = timg.imdecode(buf, to_rgb=to_rgb, as_numpy=True)
            diff = onp.abs(got.astype(int) - want.astype(int))
            assert diff.mean() < 2.0 and diff.max() <= 16
        path = tmp_path / "x.jpg"
        path.write_bytes(buf)
        nd_img = timg.imread(str(path), ctx="cpu")
        assert isinstance(nd_img, tmx.nd.NDArray)
        assert nd_img.dtype == torch.uint8 and nd_img.shape == (40, 56, 3)
        onp.testing.assert_array_equal(
            nd_img.asnumpy(), timg.imdecode(buf, as_numpy=True))
    with pytest.raises(ValueError, match="JPEG and PNG"):
        timg.imdecode(b"GIF89a....", as_numpy=True)


@pytest.mark.parametrize("interp", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("size", [(11, 7), (37, 50), (23, 29)])
def test_imresize_matches_jax_resize(interp, size):
    rng = onp.random.default_rng(interp)
    img = rng.integers(0, 256, (29, 23, 3), dtype=onp.uint8)
    w, h = size
    want = jimg.imresize(jmx.nd.array(img, dtype="uint8"), w, h,
                         interp).asnumpy()
    got = timg.imresize(tmx.nd.array(img, ctx="cpu", dtype="uint8"), w, h,
                        interp)
    assert got.dtype == torch.uint8 and got.shape == (h, w, 3)
    assert onp.abs(got.asnumpy().astype(int) - want.astype(int)).max() <= 1
    f = img.astype(onp.float32)
    want_f = jimg.imresize(jmx.nd.array(f), w, h, interp).asnumpy()
    got_f = timg.imresize(f, w, h, interp).asnumpy()     # numpy: host
    onp.testing.assert_allclose(got_f, want_f, rtol=1e-5, atol=1e-3)
    rs_w = jimg.resize_short(jmx.nd.array(img, dtype="uint8"), 13,
                             interp).asnumpy()
    rs_t = timg.resize_short(tmx.nd.array(img, ctx="cpu", dtype="uint8"),
                             13, interp).asnumpy()
    assert rs_t.shape == rs_w.shape
    assert onp.abs(rs_t.astype(int) - rs_w.astype(int)).max() <= 1


def _pair(arr):
    return jmx.nd.array(arr), tmx.nd.array(arr, ctx="cpu")


def _augs(mod):
    eigval = [55.46, 4.794, 1.148]
    eigvec = [[-0.5675, 0.7192, 0.4009], [-0.5808, -0.0045, -0.8140],
              [-0.5836, -0.6948, 0.4203]]
    return {
        "ResizeAug": mod.ResizeAug(20, 1),
        "ForceResizeAug": mod.ForceResizeAug((17, 13), 2),
        "RandomCropAug": mod.RandomCropAug((15, 12), 1),
        "CenterCropAug": mod.CenterCropAug((15, 12), 1),
        "RandomSizedCropAug": mod.RandomSizedCropAug(
            (14, 14), (0.3, 1.0), (0.75, 1.33), 1),
        "HorizontalFlipAug": mod.HorizontalFlipAug(0.5),
        "CastAug": mod.CastAug(),
        "ColorNormalizeAug": mod.ColorNormalizeAug([120.0, 110.0, 100.0],
                                                   [60.0, 55.0, 50.0]),
        "BrightnessJitterAug": mod.BrightnessJitterAug(0.3),
        "ContrastJitterAug": mod.ContrastJitterAug(0.3),
        "SaturationJitterAug": mod.SaturationJitterAug(0.3),
        "ColorJitterAug": mod.ColorJitterAug(0.2, 0.2, 0.2),
        "LightingAug": mod.LightingAug(0.1, eigval, eigvec),
    }


RESIZING = {"ResizeAug", "ForceResizeAug", "RandomSizedCropAug"}
AUGMENTERS = ("BrightnessJitterAug", "CastAug", "CenterCropAug",
              "ColorJitterAug", "ColorNormalizeAug", "ContrastJitterAug",
              "ForceResizeAug", "HorizontalFlipAug", "LightingAug",
              "RandomCropAug", "RandomSizedCropAug", "ResizeAug",
              "SaturationJitterAug")


@pytest.mark.parametrize("name", AUGMENTERS)
def test_augmenter_matches_mxtpu(name):
    rng = onp.random.default_rng(4)
    img = rng.integers(0, 256, (24, 30, 3)).astype(onp.float32)
    assert sorted(_augs(jimg)) == list(AUGMENTERS)
    ja, ta = _augs(jimg)[name], _augs(timg)[name]
    assert ta.dumps() == ja.dumps()
    for seed in range(4):
        outs = []
        for aug, x in zip((ja, ta), _pair(img)):
            random.seed(seed)
            onp.random.seed(seed)
            outs.append(aug(x).asnumpy())
        want, got = outs
        assert got.shape == want.shape, (name, seed)
        atol = 1e-3 if name in RESIZING else 1e-4
        onp.testing.assert_allclose(got, want, rtol=1e-5, atol=atol,
                                    err_msg=f"{name} seed {seed}")


@pytest.mark.parametrize("kw", [
    dict(),
    dict(rand_crop=True, rand_mirror=True, mean=True, std=True),
    dict(resize=20, rand_resize=True, rand_mirror=True,
         brightness=0.2, contrast=0.2, saturation=0.2, pca_noise=0.1,
         mean=True, std=True)])
def test_create_augmenter_chain_matches(kw):
    names_j = [type(a).__name__ for a in jimg.CreateAugmenter((3, 16, 16),
                                                              **kw)]
    names_t = [type(a).__name__ for a in timg.CreateAugmenter((3, 16, 16),
                                                              **kw)]
    assert names_t == names_j
    img = onp.random.default_rng(5).integers(0, 256, (26, 31, 3)) \
        .astype(onp.float32)
    outs = []
    for mod, x in zip((jimg, timg), _pair(img)):
        random.seed(7)
        onp.random.seed(7)
        for aug in mod.CreateAugmenter((3, 16, 16), **kw):
            x = aug(x)
        outs.append(x.asnumpy())
    onp.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=0.02)


def _png_rec(tmp_path, name, n, det=False):
    """An indexed .rec of PNG images (labels ``i % 4``, or packed
    detection labels of 1-3 boxes each)."""
    rng = onp.random.default_rng(6)
    rec, idx = str(tmp_path / f"{name}.rec"), str(tmp_path / f"{name}.idx")
    w = trec.MXIndexedRecordIO(idx, rec, "w")
    for i in range(n):
        img = rng.integers(0, 256, (20 + i % 5, 24 + i % 3, 3),
                           dtype=onp.uint8)
        label = float(i % 4)
        if det:
            boxes = []
            for _ in range(1 + i % 3):
                x1, y1 = rng.uniform(0, 0.6, 2)
                bw, bh = rng.uniform(0.2, 0.4, 2)
                boxes += [float(i % 5), x1, y1, x1 + bw, y1 + bh]
            label = [2.0, 5.0] + boxes
        w.write_idx(i, trec.pack_img(trec.IRHeader(0, label, i, 0), img,
                                     img_fmt=".png"))
    w.close()
    return rec


def _batches(it, n):
    out = []
    for _ in range(n):
        b = it.next()
        out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
    return out


@pytest.mark.parametrize("kw", [
    dict(shuffle=False),
    dict(shuffle=True, rand_crop=True, rand_mirror=True, mean=True,
         std=True, brightness=0.1)])
def test_image_iter_batches_match(tmp_path, kw):
    rec = _png_rec(tmp_path, "cls", 10)
    random.seed(11)
    onp.random.seed(11)
    ref = jimg.ImageIter(4, (3, 16, 16), path_imgrec=rec, **kw)
    want = _batches(ref, 3)
    random.seed(11)
    onp.random.seed(11)
    mine = timg.ImageIter(4, (3, 16, 16), path_imgrec=rec, ctx="cpu", **kw)
    got = _batches(mine, 3)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp and gd.shape == (4, 3, 16, 16)
        onp.testing.assert_array_equal(gl, wl)
        onp.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-4)
    assert got[-1][2] == 2                      # 10 images, batch 4
    with pytest.raises(StopIteration):
        mine.next()


def test_image_iter_sources_and_errors(tmp_path):
    rng = onp.random.default_rng(8)
    files = []
    for i in range(3):
        path = tmp_path / f"im{i}.png"
        path.write_bytes(timg.imencode(rng.integers(
            0, 256, (18, 18, 3), dtype=onp.uint8), ".png"))
        files.append(([float(i), 1.0], path.name))
    lst = tmp_path / "x.lst"
    lst.write_text("".join(f"{i}\t{lab[0]}\t{lab[1]}\t{f}\n"
                           for i, (lab, f) in enumerate(files)))
    for kw in (dict(imglist=files), dict(path_imglist=str(lst))):
        want = _batches(jimg.ImageIter(3, (3, 16, 16), label_width=2,
                                       path_root=str(tmp_path), **kw), 1)
        got = _batches(timg.ImageIter(3, (3, 16, 16), label_width=2,
                                      path_root=str(tmp_path), ctx="cpu",
                                      **kw), 1)
        onp.testing.assert_array_equal(got[0][1], want[0][1])
        onp.testing.assert_allclose(got[0][0], want[0][0], atol=1e-4)
    w = trec.MXRecordIO(str(tmp_path / "noidx.rec"), "w")
    w.write(trec.pack(trec.IRHeader(0, 0.0, 0, 0), b"x"))
    w.close()
    with pytest.raises(tmx.MXNetError, match="shuffle=True"):
        timg.ImageIter(1, (3, 4, 4), path_imgrec=str(tmp_path / "noidx.rec"),
                       shuffle=True, ctx="cpu")
    with pytest.raises(tmx.MXNetError, match="needs"):
        timg.ImageIter(1, (3, 4, 4), ctx="cpu")
    with pytest.raises(ValueError, match="data_shape"):
        timg.ImageIter(1, (2, 4, 4), imglist=files, ctx="cpu")


@pytest.mark.parametrize("kw", [
    dict(),
    dict(rand_crop=1, rand_pad=1, rand_mirror=True, mean=True, std=True),
    dict(rand_crop=1, brightness=0.2, shuffle=True)])
def test_image_det_iter_batches_match(tmp_path, kw):
    rec = _png_rec(tmp_path, "det", 9, det=True)
    outs = []
    for mod, extra in ((jimg, {}), (timg, {"ctx": "cpu"})):
        random.seed(3)
        onp.random.seed(3)
        it = mod.ImageDetIter(4, (3, 16, 16), path_imgrec=rec, **kw,
                              **extra)
        assert it.provide_label[0].shape == (4, 3, 5)
        outs.append(_batches(it, 3))
    for (gd, gl, gp), (wd, wl, wp) in zip(outs[1], outs[0]):
        assert gp == wp
        onp.testing.assert_allclose(gl, wl, rtol=1e-6, atol=1e-6)
        onp.testing.assert_allclose(gd, wd, rtol=1e-5, atol=2e-3)


def test_det_augmenters_match():
    rng = onp.random.default_rng(9)
    img = rng.integers(0, 256, (30, 40, 3)).astype(onp.float32)
    label = onp.array([[1, 0.1, 0.2, 0.5, 0.6], [3, 0.4, 0.1, 0.9, 0.5],
                       [-1, -1, -1, -1, -1]], onp.float32)
    for make in (lambda m: m.DetHorizontalFlipAug(0.5),
                 lambda m: m.DetRandomCropAug(0.3),
                 lambda m: m.DetRandomPadAug(),
                 lambda m: m.DetBorrowAug(m.BrightnessJitterAug(0.3))):
        for seed in range(3):
            outs = []
            for mod in (jimg, timg):
                random.seed(seed)
                onp.random.seed(seed)
                im, lab = make(mod)(img.copy(), label.copy())
                outs.append((onp.asarray(im), lab))
            onp.testing.assert_allclose(outs[1][0], outs[0][0], rtol=1e-6)
            onp.testing.assert_allclose(outs[1][1], outs[0][1], rtol=1e-6)
    names = lambda m: [type(a).__name__ for a in m.CreateDetAugmenter(
        (3, 16, 16), rand_crop=1, rand_pad=1, rand_mirror=True, mean=True)]
    assert names(timg) == names(jimg)


def test_augmenters_stay_on_the_images_device():
    img = tmx.nd.array(onp.full((10, 12, 3), 100.0, onp.float32), ctx="cpu")
    for aug in timg.CreateAugmenter((3, 8, 8), rand_mirror=True, mean=True,
                                    std=True, brightness=0.1, contrast=0.1,
                                    saturation=0.1, pca_noise=0.1):
        img = aug(img)
    assert img.context == torch.device("cpu") and img.shape == (8, 8, 3)
