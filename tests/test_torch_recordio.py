"""``mxtpu_torch.recordio`` against ``mxtpu.recordio`` on the CPU.

Files written by either package read back in the other, byte for byte
(sequential and indexed, ``.rec`` and ``.idx``); ``pack``/``unpack``
give the same bytes and headers, multi-label headers included; payloads
holding the magic at an aligned offset are escaped into the same
multi-part chunks; ``RecordIOSplit`` partitions one file into the same
parts; ``pack_img``/``unpack_img`` on PNG (lossless, so both packages'
pixels are equal).
"""
import struct

import numpy as onp
import pytest
import torch

from mxtpu import recordio as jrec
from mxtpu_torch import recordio as trec

torch.set_num_threads(2)   # a CPU share for each xdist worker

MAGIC = struct.pack("<I", 0xced7230a)


def _payloads(seed=0, n=40):
    rng = onp.random.default_rng(seed)
    out = []
    for i in range(n):
        body = bytes(rng.integers(0, 256, int(rng.integers(0, 120)),
                                  dtype=onp.uint8))
        if i % 7 == 3:
            body = body[:4] + MAGIC + body[4:]        # escaped multi-part
        if i % 11 == 5:
            body = b"ab" + MAGIC + b"cd"              # unaligned: kept
        out.append(body)
    return out


@pytest.mark.parametrize("writer,reader", [(jrec, trec), (trec, jrec)])
def test_sequential_files_cross_read(tmp_path, writer, reader):
    payloads = _payloads()
    paths = []
    for mod, name in ((jrec, "j.rec"), (trec, "t.rec")):
        path = str(tmp_path / name)
        w = mod.MXRecordIO(path, "w")
        for p in payloads:
            w.write(p)
        w.close()
        paths.append(path)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    path = paths[0] if writer is jrec else paths[1]
    r = reader.MXRecordIO(path, "r")
    assert [r.read() for _ in payloads] == payloads
    assert r.read() is None
    r.close()


@pytest.mark.parametrize("writer,reader", [(jrec, trec), (trec, jrec)])
def test_indexed_files_cross_read(tmp_path, writer, reader):
    payloads = _payloads(1, 25)
    files = {}
    for mod, tag in ((jrec, "j"), (trec, "t")):
        rec, idx = str(tmp_path / f"{tag}.rec"), str(tmp_path / f"{tag}.idx")
        w = mod.MXIndexedRecordIO(idx, rec, "w")
        for i, p in enumerate(payloads):
            w.write_idx(i * 3, p)
        w.close()
        files[mod] = (idx, rec)
    for k in (0, 1):
        with open(files[jrec][k], "rb") as a, open(files[trec][k], "rb") as b:
            assert a.read() == b.read()
    idx, rec = files[writer]
    r = reader.MXIndexedRecordIO(idx, rec, "r")
    assert r.keys == [i * 3 for i in range(len(payloads))]
    for i in (7, 0, 24, 3):
        assert r.read_idx(i * 3) == payloads[i]
    r.close()


@pytest.mark.parametrize("label", [3.0, [1.0, 2.0, 3.5], onp.arange(
    7, dtype=onp.float32)])
def test_pack_unpack_bytes_equal(label):
    body = b"payload" + MAGIC + b"tail"
    h = jrec.IRHeader(0, label, 42, 7)
    got = trec.pack(trec.IRHeader(0, label, 42, 7), body)
    want = jrec.pack(h, body)
    assert got == want
    th, tp = trec.unpack(want)
    jh, jp = jrec.unpack(want)
    assert tp == jp == body
    assert (th.flag, th.id, th.id2) == (jh.flag, jh.id, jh.id2)
    onp.testing.assert_array_equal(onp.asarray(th.label),
                                   onp.asarray(jh.label))


def test_aligned_magic_escape_and_multipart(tmp_path):
    payloads = [b"abcd" + MAGIC + b"efgh", MAGIC + b"xy",
                b"abcd" + MAGIC + MAGIC + b"zz", b"ab" + MAGIC + b"cd",
                b"plain", MAGIC]
    raws = []
    for mod, name in ((jrec, "j.rec"), (trec, "t.rec")):
        path = str(tmp_path / name)
        w = mod.MXRecordIO(path, "w")
        for p in payloads:
            w.write(p)
        w.close()
        with open(path, "rb") as f:
            raws.append(f.read())
        r = mod.MXRecordIO(path, "r")
        assert [r.read() for _ in payloads] == payloads
    assert raws[0] == raws[1]


@pytest.mark.parametrize("nparts", [1, 2, 3, 5, 8])
def test_recordio_split_parts_equal(tmp_path, nparts):
    path = str(tmp_path / "split.rec")
    payloads = _payloads(2, 57)
    w = trec.MXRecordIO(path, "w")
    for p in payloads:
        w.write(p)
    w.close()
    got = []
    for part in range(nparts):
        mine, ref = trec.RecordIOSplit(path, part, nparts), \
            jrec.RecordIOSplit(path, part, nparts)
        a, b = list(mine), list(ref)
        assert a == b, (nparts, part)
        got.extend(a)
        mine.close()
        ref.close()
    assert got == payloads
    with pytest.raises(ValueError):
        trec.RecordIOSplit(path, nparts, nparts)


def test_writer_fork_guard_and_pickle(tmp_path):
    import pickle
    path = str(tmp_path / "w.rec")
    w = trec.MXRecordIO(path, "w")
    w.write(b"one")
    w2 = pickle.loads(pickle.dumps(w))      # continues, never truncates
    w.close()
    w2.write(b"two")
    w2.close()
    r = jrec.MXRecordIO(path, "r")
    assert [r.read(), r.read(), r.read()] == [b"one", b"two", None]
    w3 = trec.MXRecordIO(str(tmp_path / "x.rec"), "w")
    w3.pid = -1                              # as if used across a fork
    with pytest.raises(trec.MXNetError, match="fork"):
        w3.write(b"x")
    w3.close()
    with pytest.raises(ValueError):
        trec.MXRecordIO(path, "a")


def test_pack_img_png_both_ways():
    rng = onp.random.default_rng(3)
    img = rng.integers(0, 256, (13, 17, 3), dtype=onp.uint8)
    h = trec.IRHeader(0, 2.0, 5, 0)
    mine = trec.pack_img(h, img, img_fmt=".png")
    theirs = jrec.pack_img(jrec.IRHeader(0, 2.0, 5, 0), img, img_fmt=".png")
    for s in (mine, theirs):
        th, timg = trec.unpack_img(s)
        jh, jimg = jrec.unpack_img(s)
        assert th.label == jh.label == 2.0 and th.id == jh.id == 5
        onp.testing.assert_array_equal(timg, img)
        onp.testing.assert_array_equal(jimg, img)
        _, tgray = trec.unpack_img(s, iscolor=0)
        _, jgray = jrec.unpack_img(s, iscolor=0)
        assert tgray.shape == (13, 17, 1)
        onp.testing.assert_array_equal(tgray, jgray)
