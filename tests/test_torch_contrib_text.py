"""mx.contrib.text and mx.contrib.summary in the port against
``mxtpu``'s.

- text: on a seeded corpus and a seeded embedding table (a GloVe-style
  text file and a token/vector list), the vocabularies are equal
  (tokens, indices, lookups) and the vectors bit-equal, before and after
  ``update_token_vectors``; the reference's own test on the port; the
  same refusals.
- summary: the same calls through both packages' ``SummaryWriter``
  write event records that, parsed back, have equal tags, steps and
  values (wall times left out).
"""
import glob
import os
import struct

import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu_torch as tmx
from mxtpu.base import MXNetError as JError
from mxtpu.contrib import text as jtext
from mxtpu_torch.base import MXNetError as TError
from mxtpu_torch.contrib import text as ttext

torch.set_num_threads(2)

WORDS = ["the", "cat", "sat", "on", "mat", "dog", "ran", "far", "away",
         "The", "Cat", "a", "an", "of", "to"]


def _corpus(seed=0, n=2000):
    rng = np.random.default_rng(seed)
    p = rng.dirichlet(np.ones(len(WORDS)))
    lines = [" ".join(rng.choice(WORDS, size=rng.integers(3, 12), p=p))
             for _ in range(n // 8)]
    return "\n".join(lines)


def _table_file(tmp_path, seed=1, dim=5):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((len(WORDS) - 3, dim)).astype(np.float32)
    lines = [f"{len(WORDS) - 3} {dim}"]          # a fastText header
    lines += [w + " " + " ".join(repr(float(x)) for x in v)
              for w, v in zip(WORDS[:-3], vecs)]
    lines += ["broken line with words", "short 1.0"]  # skipped rows
    path = tmp_path / "emb.txt"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("kw", [
    {}, {"min_freq": 3}, {"most_freq_count": 5},
    {"reserved_tokens": ["<pad>", "<bos>"]},
    {"unknown_token": "<oov>", "min_freq": 2, "reserved_tokens": ["<pad>"]}])
@pytest.mark.parametrize("lower", [False, True])
def test_vocabulary_matches(kw, lower):
    src = _corpus()
    jc = jtext.count_tokens_from_str(src, to_lower=lower)
    tc = ttext.count_tokens_from_str(src, to_lower=lower)
    assert tc == jc
    jv, tv = jtext.Vocabulary(jc, **kw), ttext.Vocabulary(tc, **kw)
    assert tv.idx_to_token == jv.idx_to_token
    assert tv.token_to_idx == jv.token_to_idx
    assert len(tv) == len(jv) and tv.unknown_token == jv.unknown_token
    probe = WORDS + ["zebra", "<pad>"]
    assert tv.to_indices(probe) == jv.to_indices(probe)
    assert tv.to_indices("cat") == jv.to_indices("cat")
    idx = list(range(len(tv)))
    assert tv.to_tokens(idx) == jv.to_tokens(idx)
    assert tv.to_tokens(0) == jv.to_tokens(0)


def test_vocabulary_refusals_alike():
    for kw in ({"min_freq": 0}, {"reserved_tokens": ["<unk>"]},
               {"reserved_tokens": ["a", "a"]}):
        with pytest.raises(JError) as je:
            jtext.Vocabulary(None, **kw)
        with pytest.raises(TError) as te:
            ttext.Vocabulary(None, **kw)
        assert str(te.value) == str(je.value)
    v = ttext.Vocabulary(ttext.count_tokens_from_str("a b"))
    with pytest.raises(TError, match="out of vocabulary"):
        v.to_tokens(99)


def test_embedding_vectors_bit_equal(tmp_path):
    path = _table_file(tmp_path)
    src = _corpus()
    jv = jtext.Vocabulary(jtext.count_tokens_from_str(src),
                          reserved_tokens=["<pad>"])
    tv = ttext.Vocabulary(ttext.count_tokens_from_str(src),
                          reserved_tokens=["<pad>"])
    unk = (lambda d: np.full(d, 0.5, np.float32))
    je = jtext.CustomEmbedding(path, vocabulary=jv, init_unknown_vec=unk)
    te = ttext.CustomEmbedding(path, vocabulary=tv, init_unknown_vec=unk,
                               ctx="cpu")
    assert te.vec_len == je.vec_len == 5
    assert te.idx_to_vec.context == torch.device("cpu")
    np.testing.assert_array_equal(te.idx_to_vec.asnumpy(),
                                  je.idx_to_vec.asnumpy())
    probe = ["cat", "Cat", "zebra", "the"]
    for backup in (False, True):
        np.testing.assert_array_equal(
            te.get_vecs_by_tokens(probe, backup).asnumpy(),
            je.get_vecs_by_tokens(probe, backup).asnumpy())
    np.testing.assert_array_equal(te.get_vecs_by_tokens("far").asnumpy(),
                                  je.get_vecs_by_tokens("far").asnumpy())
    new = np.random.default_rng(2).standard_normal((2, 5)).astype(np.float32)
    je.update_token_vectors(["cat", "<pad>"], jmx.nd.array(new))
    te.update_token_vectors(["cat", "<pad>"], tmx.nd.array(new, ctx="cpu"))
    np.testing.assert_array_equal(te.idx_to_vec.asnumpy(),
                                  je.idx_to_vec.asnumpy())
    for e, err in ((je, JError), (te, TError)):
        with pytest.raises(err, match="neither"):
            e.update_token_vectors("zebra", np.zeros(5, np.float32))
        with pytest.raises(err, match="vec_len"):
            e.update_token_vectors("cat", np.zeros(4, np.float32))


def test_embedding_from_tokens_and_vectors():
    rng = np.random.default_rng(3)
    vecs = rng.standard_normal((4, 3)).astype(np.float32)
    toks = ["a", "b", "c", "d"]
    jv = jtext.Vocabulary(jtext.count_tokens_from_str("a b b c e"))
    tv = ttext.Vocabulary(ttext.count_tokens_from_str("a b b c e"))
    je = jtext.CustomEmbedding(vocabulary=jv, tokens=toks,
                               vectors=jmx.nd.array(vecs))
    te = ttext.CustomEmbedding(vocabulary=tv, tokens=toks,
                               vectors=tmx.nd.array(vecs, ctx="cpu"),
                               ctx="cpu")
    np.testing.assert_array_equal(te.idx_to_vec.asnumpy(),
                                  je.idx_to_vec.asnumpy())
    with pytest.raises(TError, match="no embedding source"):
        ttext.CustomEmbedding(vocabulary=tv)
    with pytest.raises(TError, match="no Vocabulary"):
        ttext.CustomEmbedding(tokens=toks, vectors=vecs).idx_to_vec


def test_reference_text_test_on_the_port(tmp_path):
    """The reference's ``test_contrib_text_vocab_embedding`` through the
    port, with its arrays on the CPU."""
    from mxtpu_torch.gluon import nn
    counter = ttext.count_tokens_from_str("the cat sat on the mat the cat",
                                          to_lower=True)
    vocab = ttext.Vocabulary(counter, min_freq=2, reserved_tokens=["<pad>"])
    assert vocab.idx_to_token[:4] == ["<unk>", "<pad>", "the", "cat"]
    assert vocab.to_indices(["the", "dog"]) == [2, 0]
    assert vocab.to_tokens(3) == "cat"
    fp = tmp_path / "emb.txt"
    fp.write_text("the 1.0 0.0\ncat 0.0 1.0\nmat 0.5 0.5\n")
    with tmx.cpu():
        emb = ttext.CustomEmbedding(str(fp), vocabulary=vocab)
        mat = emb.idx_to_vec.asnumpy()
        assert mat.shape == (len(vocab), 2)
        np.testing.assert_allclose(mat[2], [1.0, 0.0])
        np.testing.assert_allclose(mat[0], [0.0, 0.0])
        v = emb.get_vecs_by_tokens(["cat", "unknown"]).asnumpy()
        np.testing.assert_allclose(v, [[0.0, 1.0], [0.0, 0.0]])
        emb.update_token_vectors("cat", tmx.nd.array([[9.0, 9.0]]))
        np.testing.assert_allclose(emb.idx_to_vec.asnumpy()[3], [9.0, 9.0])
        layer = nn.Embedding(len(vocab), 2)
        layer.initialize(ctx="cpu")
        layer.weight.set_data(emb.idx_to_vec)
        out = layer(tmx.nd.array(np.array([2.0, 3.0])))
    np.testing.assert_allclose(out.asnumpy(), [[1, 0], [9, 9]], rtol=1e-6)


# ---------------------------------------------------------------------------
# summary: the event records, parsed back
# ---------------------------------------------------------------------------
def _events(logdir):
    """Every Event record of the tfevents files under ``logdir`` (the
    TFRecord framing: u64 length, u32 crc, data, u32 crc)."""
    from tensorboardX.proto import event_pb2
    out = []
    for path in sorted(glob.glob(os.path.join(logdir, "events.out.*"))):
        data = open(path, "rb").read()
        pos = 0
        while pos < len(data):
            (n,) = struct.unpack("<Q", data[pos:pos + 8])
            ev = event_pb2.Event()
            ev.ParseFromString(data[pos + 12:pos + 12 + n])
            out.append(ev)
            pos += 12 + n + 4
    return out


def _records(logdir):
    recs = []
    for ev in _events(logdir):
        if not ev.HasField("summary"):
            continue
        for v in ev.summary.value:
            v2 = type(v)()
            v2.CopyFrom(v)
            recs.append((ev.step, v2.SerializeToString()))
    return recs


def _write(mx, writer_cls, logdir, ctx):
    rng = np.random.default_rng(4)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    img = rng.uniform(0, 1, (3, 8, 8)).astype(np.float32)
    arr = (lambda v: mx.nd.array(v, ctx=ctx)) if ctx else mx.nd.array
    with writer_cls(logdir=logdir) as sw:
        sw.add_scalar("loss", arr(np.array([0.5], np.float32)), 1)
        sw.add_scalar("loss", 0.25, 2)
        sw.add_histogram("w", arr(w), 1)
        sw.add_histogram("w_bins", arr(w), 2, bins=16)
        sw.add_image("img", arr(img), 1)
        sw.add_text("note", "hello", 1)
        with pytest.raises(ValueError, match="add_histogram"):
            sw.add_scalar("bad", arr(w), 3)


def test_summary_records_match(tmp_path):
    from mxtpu.contrib.summary import SummaryWriter as JWriter
    from mxtpu_torch.contrib.summary import SummaryWriter as TWriter
    _write(jmx, JWriter, str(tmp_path / "ref"), None)
    _write(tmx, TWriter, str(tmp_path / "port"), "cpu")
    want, got = _records(str(tmp_path / "ref")), _records(
        str(tmp_path / "port"))
    assert len(got) == len(want) == 6
    assert got == want


def test_tensorboard_is_the_summary_module():
    assert tmx.contrib.tensorboard is tmx.contrib.summary
    assert tmx.contrib.summary.SummaryWriter.__module__ == \
        "mxtpu_torch.contrib.summary"
