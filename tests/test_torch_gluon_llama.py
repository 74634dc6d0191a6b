"""The port's ``GluonLlama`` (``mxtpu_torch.gluon.model_zoo``) against
``mxtpu.gluon.model_zoo.GluonLlama`` on the CPU, on ``llama.CONFIGS
["tiny"]`` in float32 with dense attention and no remat, both blocks
holding the reference's ``init_params`` tree (the port's through
``load_pytree`` of its numpy copy, by ``params_from_numpy``).

- Logits of ``net(tokens)``, eager and hybridized, within ``rtol=1e-5``
  and ``atol=1e-5`` (for the logits near 0; the logits are of order 1,
  and ``test_torch_llama.py`` holds the functional forward at 1e-4).
- 3 steps of the classic path (hybridized, ``record()``, ``net(tok,
  tok)``, ``backward()``, ``Trainer.step``) with sgd and with adamw:
  every loss and every final weight within the same bounds.
- ``as_pytree`` hands out the parameters' own tensors, ``generate``
  equals ``llama.generate`` on them, ``serve`` builds an engine whose
  stream equals it, and the shapes come from the ``meta`` device.
"""
from dataclasses import fields, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxtpu as jmx
from mxtpu.gluon.model_zoo import GluonLlama as JGluonLlama
from mxtpu.models import llama as jl
import mxtpu_torch as tmx
from mxtpu_torch.gluon.model_zoo import GluonLlama
from mxtpu_torch.models import llama as tl

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def ref():
    jcfg = replace(jl.CONFIGS["tiny"], dtype=jnp.float32, attn_impl="dense",
                   remat=False)
    vals = {f.name: getattr(jcfg, f.name) for f in fields(tl.LlamaConfig)
            if f.name not in ("dtype", "param_dtype")}
    tcfg = tl.LlamaConfig(**vals, dtype=torch.float32,
                          param_dtype=torch.float32)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    return jcfg, tcfg, jparams, jax.tree.map(np.asarray, jparams), tokens


def nets(ref):
    jcfg, tcfg, jparams, tree, _ = ref
    jnet = JGluonLlama(jcfg)
    jnet.load_pytree(jparams)
    tnet = GluonLlama(tcfg)
    tnet.load_pytree(tree, ctx="cpu")
    return jnet, tnet


def test_parameters_and_tree_bridge(ref):
    jnet, tnet = nets(ref)
    jp, tp = jnet.collect_params(), tnet.collect_params()
    assert list(tp.keys()) == list(jp.keys())
    for name in jp.keys():
        assert tp[name].shape == jp[name].shape, name
        np.testing.assert_array_equal(tp[name].data().asnumpy(),
                                      jp[name].data().asnumpy())
    tree = tnet.as_pytree()
    assert tree["layers"]["wq"] is tp["layers/wq"].data()._data
    fresh = GluonLlama(ref[1])
    assert fresh.collect_params()["lm_head"].shape == (64, 256)
    assert fresh.collect_params()["layers/wq"]._data is None


@pytest.mark.parametrize("hybrid", [False, True], ids=["eager", "hybrid"])
def test_logits_match_mxtpu(ref, hybrid):
    tokens = ref[4]
    jnet, tnet = nets(ref)
    if hybrid:
        jnet.hybridize()
        tnet.hybridize()
    want = jnet(jmx.nd.array(tokens, dtype="int32")).asnumpy()
    for _ in range(2):          # the cached call after the first one too
        got = tnet(tmx.nd.array(tokens, ctx="cpu", dtype="int32"))
        np.testing.assert_allclose(got.asnumpy(), want, **TOL)
    assert got.shape == (2, 16, 256)
    np.testing.assert_array_equal(
        got.asnumpy(), tl.forward(ref[1], tnet.as_pytree(),
                                  torch.tensor(tokens)).numpy())


def train(mx, net, tokens, opt, kw, ctx):
    net.hybridize()
    trainer = mx.gluon.Trainer(net.collect_params(), opt, kw)
    tok = mx.nd.array(tokens, ctx=ctx, dtype="int32")
    losses = []
    for _ in range(3):
        with mx.autograd.record():
            loss = net(tok, tok)
        loss.backward()
        trainer.step(1)
        losses.append(float(loss.asscalar()))
    return losses


@pytest.mark.parametrize("opt,kw", [
    ("sgd", dict(learning_rate=0.1)),
    ("adamw", dict(learning_rate=1e-3, wd=0.01)),
])
def test_trainer_trajectory_matches_mxtpu(ref, opt, kw):
    jnet, tnet = nets(ref)
    want = train(jmx, jnet, ref[4], opt, kw, jmx.cpu())
    got = train(tmx, tnet, ref[4], opt, kw, "cpu")
    np.testing.assert_allclose(got, want, **TOL)
    assert got[-1] < got[0]
    jp = jnet.collect_params()
    for name, p in tnet.collect_params().items():
        np.testing.assert_allclose(p.data().asnumpy(),
                                   jp[name].data().asnumpy(), err_msg=name,
                                   **TOL)


def test_generate_and_serve_use_the_live_weights(ref):
    from mxtpu_torch.serve import Request
    _, tnet = nets(ref)
    prompt = torch.tensor(ref[4][:1, :6])
    out = tnet.generate(tmx.nd.array(prompt, ctx="cpu", dtype="int64"), 5)
    want = tl.generate(ref[1], tnet.as_pytree(), prompt, 5)
    np.testing.assert_array_equal(out.asnumpy(), want.numpy())
    engine = tnet.serve(max_slots=2, max_len=32, min_bucket=4, device="cpu")
    rid = engine.submit(Request(prompt=ref[4][0, :6], max_new_tokens=5))
    got = engine.run()[rid]
    np.testing.assert_array_equal(np.asarray(got), want.numpy()[0, 6:])
