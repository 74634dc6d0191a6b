"""Parity of mxtpu_torch.models.llama with mxtpu.models.llama on the CPU.

The port is held on the reference's weights: ``llama.init_params``
draws a tree with jax, the tree crosses as numpy, and both packages
run the same tokens in float32 (``CONFIGS["tiny"]`` at
``dtype=float32``). Greedy token streams come from ``llama_refs``'
memoized ``generate`` oracle so no new reference programs compile.

Tolerance ``atol=rtol=1e-4`` on logits: both sides compute in f32,
and differ in summation order inside matmuls and in the ulps of
``pow``/``cos``/``sin`` in the RoPE tables, over two layers.
"""
import ast
import os
import subprocess
import sys
from dataclasses import fields, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llama_refs
from mxtpu.models import llama as jl
from mxtpu_torch import context
from mxtpu_torch.models import llama as tl

torch.set_num_threads(2)   # a CPU share for each xdist worker

TOL = dict(atol=1e-4, rtol=1e-4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_cfg(cfg):
    """The port's config with the fields of mxtpu's, in float32."""
    vals = {f.name: getattr(cfg, f.name) for f in fields(tl.LlamaConfig)
            if f.name not in ("dtype", "param_dtype")}
    return tl.LlamaConfig(**vals, dtype=torch.float32,
                          param_dtype=torch.float32)


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, jax params, port cfg, port params) on one weight tree."""
    jcfg = replace(jl.CONFIGS["tiny"], dtype=jnp.float32)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, _port_cfg(jcfg), tl.params_from_numpy(
        tree, device="cpu")


def _tokens(seed, b, s):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(b, s)).astype(np.int32)


def test_numpy_round_trip_is_bit_exact():
    tree = jax.tree.map(np.asarray, jl.init_params(jl.CONFIGS["tiny"]))
    back = tl.params_to_numpy(tl.params_from_numpy(tree, device="cpu"))
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    # dtype= casts every floating leaf; bf16 comes back as exact float32
    bf = tl.params_from_numpy(tree, device="cpu", dtype=torch.bfloat16)
    assert bf["layers"]["wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tl.params_to_numpy(bf)["lm_head"],
        torch.tensor(tree["lm_head"]).to(torch.bfloat16).float().numpy())


def test_module_carries_the_tree(pair):
    jcfg, jparams, tcfg, tparams = pair
    model = tl.Llama(tcfg, device="cpu")
    names = {n for n, _ in model.named_parameters()}
    assert names == {"tok_embed", "final_norm", "lm_head"} | {
        f"layers.{k}" for k in jparams["layers"]}
    model.load_numpy_tree(jax.tree.map(np.asarray, jparams))
    toks = torch.from_numpy(_tokens(5, 1, 7))
    # the module's parameters require grad (it trains), so its output
    # carries a graph: detach before reading it
    np.testing.assert_array_equal(model(toks).detach().numpy(),
                                  tl.forward(tcfg, tparams, toks).numpy())
    with pytest.raises(ValueError, match="does not match"):
        model.load_numpy_tree({"final_norm": np.ones(3, np.float32),
                               "layers": {}})


@pytest.mark.parametrize("attn_impl", ["flash", "dense"])
def test_forward_matches_mxtpu(pair, attn_impl):
    jcfg, jparams, tcfg, tparams = pair
    jcfg, tcfg = (replace(c, attn_impl=attn_impl) for c in (jcfg, tcfg))
    toks = _tokens(1, 2, 24)
    want = np.asarray(jl.forward(jcfg, jparams, jnp.asarray(toks)))
    got = tl.forward(tcfg, tparams, torch.from_numpy(toks)).numpy()
    assert got.dtype == np.float32 and got.shape == (2, 24, 256)
    np.testing.assert_allclose(got, want, **TOL)


def test_prefill_and_decode_match_mxtpu(pair):
    jcfg, jparams, tcfg, tparams = pair
    toks = _tokens(2, 2, 12)
    steps = _tokens(3, 3, 2)                     # three (b, 1) tokens
    jcache = jl.init_cache(jcfg, 2, 16)
    tcache = tl.init_cache(tcfg, 2, 16, device="cpu")
    want, jcache = jl.prefill(jcfg, jparams, jnp.asarray(toks), jcache)
    got, tcache = tl.prefill(tcfg, tparams, torch.from_numpy(toks), tcache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for t in steps:
        want, jcache = jl.decode_step(jcfg, jparams,
                                      jnp.asarray(t)[:, None], jcache)
        got, tcache = tl.decode_step(tcfg, tparams,
                                     torch.from_numpy(t)[:, None], tcache)
        assert got.shape == (2, 256)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert tcache["pos"] == 15 == int(jcache["pos"])
    with pytest.raises(ValueError, match="cache overflow"):
        tl.prefill(tcfg, tparams, torch.from_numpy(toks), tcache)


@pytest.mark.parametrize("prompt", [[1, 2, 3, 4, 5], [7, 200, 31],
                                    [9, 9, 8, 7, 120, 64, 3]])
def test_greedy_generate_matches_reference(prompt):
    cfg, params = llama_refs.serve_config(), llama_refs.serve_weights(0)
    want = llama_refs.reference(cfg, params, prompt, 6)
    tparams = tl.params_from_numpy(jax.tree.map(np.asarray, params),
                                   device="cpu")
    out = tl.generate(_port_cfg(cfg), tparams,
                      torch.tensor([prompt], dtype=torch.int32), 6)
    assert out.dtype == torch.int32 and out.shape == (1, len(prompt) + 6)
    assert out[0, :len(prompt)].tolist() == prompt
    assert out[0, len(prompt):].tolist() == want


def test_generate_refuses_what_this_slice_lacks(pair):
    _, _, tcfg, tparams = pair
    prompt = torch.tensor([[1, 2, 3]])
    with pytest.raises(ValueError, match="max_new_tokens"):
        tl.generate(tcfg, tparams, prompt, 0)
    with pytest.raises(ValueError, match="top_p"):
        tl.generate(tcfg, tparams, prompt, 2, top_p=1.5)
    with pytest.raises(ValueError, match="top_k"):
        tl.generate(tcfg, tparams, prompt, 2, top_k=0)
    with pytest.raises(NotImplementedError, match="mesh"):
        tl.generate(tcfg, tparams, prompt, 2, mesh=object())
    with pytest.raises(NotImplementedError, match="later slice"):
        tl.forward(replace(tcfg, attn_impl="ring"), tparams, prompt)


def test_default_device_never_falls_back_to_cpu():
    if torch.cuda.is_available():
        assert context.default_device() == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            context.default_device()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tl.init_cache(tl.CONFIGS["tiny"], 1, 4)
    assert context.cpu() == torch.device("cpu")
    assert context.gpu(1) == torch.device("cuda", 1)


def test_port_imports_no_jax():
    """Importing the port leaves jax and mxtpu out of sys.modules (run in
    a fresh interpreter: this test process has both loaded)."""
    code = ("import sys, mxtpu_torch, mxtpu_torch.models.llama, "
            "mxtpu_torch.ops.attention, mxtpu_torch.parallel.step, "
            "mxtpu_torch.parallel.optim, mxtpu_torch.models.resnet, "
            "mxtpu_torch.ops.conv, "
            "mxtpu_torch.tools.resnet_shape_experiment, "
            "mxtpu_torch.ndarray, mxtpu_torch.autograd, mxtpu_torch.rtc, "
            "mxtpu_torch.ops._build, mxtpu_torch.tools.rtc_kernels, "
            "mxtpu_torch.prng, mxtpu_torch.serve, mxtpu_torch.serve.engine, "
            "mxtpu_torch.telemetry, mxtpu_torch.telemetry.perfscope, "
            "mxtpu_torch.telemetry.watcher, mxtpu_torch.cuda_graphs, "
            "mxtpu_torch.tools.module_tolerance, mxtpu_torch.rpc, "
            "mxtpu_torch.ndarray.random, mxtpu_torch.serde, "
            "mxtpu_torch.xla_math, mxtpu_torch.parallel.moe, "
            "mxtpu_torch.models.bert, mxtpu_torch.serve.gateway, "
            "mxtpu_torch.serve.gateway.replica, "
            "mxtpu_torch.serve.gateway.gateway, "
            "mxtpu_torch.serve.gateway.frontdoor, "
            "mxtpu_torch.serve.gateway.autoscale, "
            "mxtpu_torch.serve.gateway.disagg, mxtpu_torch.contrib, "
            "mxtpu_torch.contrib.chaos, mxtpu_torch.checkpoint, "
            "mxtpu_torch.serve.fleet, mxtpu_torch.serve.fleet.fleet, "
            "mxtpu_torch.serve.fleet.arbiter, "
            "mxtpu_torch.serve.fleet.flywheel, mxtpu_torch.ndarray.ops, "
            "mxtpu_torch.ndarray.ops_extended, mxtpu_torch.model, "
            "mxtpu_torch.lr_scheduler, mxtpu_torch.optimizer, "
            "mxtpu_torch.initializer, mxtpu_torch.gluon, "
            "mxtpu_torch.gluon.block, mxtpu_torch.gluon.parameter, "
            "mxtpu_torch.gluon.nn, mxtpu_torch.gluon.loss, "
            "mxtpu_torch.gluon.trainer, mxtpu_torch.gluon.utils, "
            "mxtpu_torch.gluon.model_zoo, "
            "mxtpu_torch.gluon.model_zoo.llama, "
            "mxtpu_torch.gluon.model_zoo.vision, mxtpu_torch.amp, "
            "mxtpu_torch.amp.loss_scaler, mxtpu_torch.parallel.mesh, "
            "mxtpu_torch.parallel.sharding, mxtpu_torch.gluon.fused, "
            "mxtpu_torch.gluon.rnn, mxtpu_torch.gluon.rnn.rnn_cell, "
            "mxtpu_torch.gluon.rnn.rnn_layer, mxtpu_torch.gluon.contrib, "
            "mxtpu_torch.gluon.contrib.nn, mxtpu_torch.gluon.data, "
            "mxtpu_torch.gluon.data.dataset, "
            "mxtpu_torch.gluon.data.sampler, "
            "mxtpu_torch.gluon.data.dataloader, "
            "mxtpu_torch.gluon.data.prefetcher, "
            "mxtpu_torch.gluon.data.vision, "
            "mxtpu_torch.gluon.data.vision.datasets, "
            "mxtpu_torch.gluon.data.vision.transforms, "
            "mxtpu_torch.symbol, mxtpu_torch.symbol.symbol, "
            "mxtpu_torch.module, mxtpu_torch.module.module, "
            "mxtpu_torch.module.base_module, "
            "mxtpu_torch.module.bucketing_module, mxtpu_torch.io, "
            "mxtpu_torch.metric, mxtpu_torch.callback, "
            "mxtpu_torch.monitor, mxtpu_torch.visualization, "
            "mxtpu_torch.gluon.model_zoo.vision.alexnet, "
            "mxtpu_torch.gluon.model_zoo.vision.vgg, "
            "mxtpu_torch.gluon.model_zoo.vision.squeezenet, "
            "mxtpu_torch.gluon.model_zoo.vision.mobilenet, "
            "mxtpu_torch.gluon.model_zoo.vision.densenet, "
            "mxtpu_torch.gluon.model_zoo.vision.inception, "
            "mxtpu_torch.recordio, mxtpu_torch.native, mxtpu_torch.image, "
            "mxtpu_torch.image.image, mxtpu_torch.image.detection, "
            "mxtpu_torch.image._png, mxtpu_torch.ndarray.contrib, "
            "mxtpu_torch.ndarray.contrib_ops, mxtpu_torch.tools.im2rec, "
            "mxtpu_torch.tools.synth_images, mxtpu_torch.tools.input_ab, "
            "mxtpu_torch.tools.decode_contention, mxtpu_torch.operator, "
            "mxtpu_torch.ndarray.sparse, "
            "mxtpu_torch.contrib.quantization, mxtpu_torch.contrib.text, "
            "mxtpu_torch.contrib.summary, mxtpu_torch.contrib.deploy, "
            "mxtpu_torch.contrib.onnx, mxtpu_torch.contrib.onnx._export, "
            "mxtpu_torch.contrib.onnx._import, "
            "mxtpu_torch.contrib.analysis, "
            "mxtpu_torch.contrib.analysis.rules, "
            "mxtpu_torch.contrib.analysis.deep, "
            "mxtpu_torch.contrib.analysis.graph, "
            "mxtpu_torch.contrib.analysis.lockcheck, "
            "mxtpu_torch.tools.mxlint, mxtpu_torch.tools.op_host_ab\n"
            "assert mxtpu_torch.gluon is mxtpu_torch.gluon and "
            "mxtpu_torch.init is mxtpu_torch.initializer\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'mxtpu' or "
            "m.startswith('mxtpu.')]\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_port_sources_import_no_jax():
    root = os.path.join(REPO, "mxtpu_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(root)
             for f in fs if f.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) >= 6 and os.path.join(root, "prng.py") in files
    for path in files:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "mxtpu"), (path, n)
