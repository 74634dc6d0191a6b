"""``HybridBlock.export_stablehlo`` and ``mx.contrib.deploy`` in the port
against ``mxtpu``'s (the reference's ``test_stablehlo_export_deploy_round
_trip``): the port writes a ``torch.export`` archive (``.pt2``), the
reference a StableHLO file.

- The reference test's net (two Dense layers with deferred shapes) and
  a 2-layer, 64-wide GluonLlama (f32, the reference's ``tiny`` config)
  are exported by both packages from the same weights; each deployed
  artifact's outputs agree with the other's within 1e-5.
- The port's archive runs in a fresh interpreter that imports
  ``mxtpu_torch.contrib.deploy`` only: no model class is imported.
- Export traces the eager forward, never a hybridized block's captured
  graph (a stand-in capture that raises is never reached).
- On fake CUDA tensors (the CPU build of torch can trace them), each
  flash forward and conv3x3 call of a traced function is one
  ``mxtpu_torch::`` operator node; the fake implementations give the
  output shapes. A whole GluonLlama cannot be traced so here (its token
  lookup needs a CUDA build), so the one-node-per-layer count is held
  on the card by ``chip_smoke.py``'s ``contrib`` phase.
"""
import subprocess
import sys
from dataclasses import fields, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu_torch as tmx
from mxtpu.contrib import deploy as jdeploy
from mxtpu.gluon.model_zoo import GluonLlama as JGluonLlama
from mxtpu.models import llama as jl
from mxtpu_torch.contrib import deploy as tdeploy
from mxtpu_torch.gluon import block as tblock
from mxtpu_torch.gluon.model_zoo import GluonLlama
from mxtpu_torch.models import llama as tl

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


def _dense_nets():
    """The reference test's net in both packages, on one set of seeded
    weights (the port's shapes resolved by a first call)."""
    x = np.random.default_rng(0).standard_normal((2, 4)).astype(np.float32)
    nets = []
    for mx in (jmx, tmx):
        net = mx.gluon.nn.HybridSequential(prefix="deploy_")
        with net.name_scope():
            net.add(mx.gluon.nn.Dense(8, activation="relu"),
                    mx.gluon.nn.Dense(3))
        nets.append(net)
    jnet, tnet = nets
    tnet.initialize(ctx="cpu")
    tnet(tmx.nd.array(x, ctx="cpu"))
    rng = np.random.default_rng(1)
    w = {k: rng.standard_normal(p.shape).astype(np.float32)
         for k, p in tnet.collect_params().items()}
    for k, p in tnet.collect_params().items():
        p._load_init(tmx.nd.array(w[k], ctx="cpu"), "cpu")
    for k, p in jnet.collect_params().items():
        p._load_init(jmx.nd.array(w[k]), jmx.cpu())
    return jnet, tnet, x


def test_reference_net_round_trip_matches(tmp_path):
    jnet, tnet, x = _dense_nets()
    want = jnet(jmx.nd.array(x)).asnumpy()
    jpath = jnet.export_stablehlo(str(tmp_path / "ref"), jmx.nd.array(x))
    tx = tmx.nd.array(x, ctx="cpu")
    eager = tnet(tx).asnumpy()
    path = tnet.export_stablehlo(str(tmp_path / "net"), tx)
    assert path == str(tmp_path / "net.pt2") and jpath.endswith(".stablehlo")
    assert (tmp_path / "net.pt2").stat().st_size > 500
    pred = tdeploy.load(path, ctx="cpu")
    assert pred.device == torch.device("cpu")
    got = pred(tx)
    assert isinstance(got, tmx.nd.NDArray)
    np.testing.assert_array_equal(got.asnumpy(), eager)
    np.testing.assert_allclose(got.asnumpy(), want, **TOL)
    np.testing.assert_allclose(
        jdeploy.load(jpath)(jmx.nd.array(x)).asnumpy(), got.asnumpy(), **TOL)
    # a path that already names the archive is kept as it is
    assert tnet.export_stablehlo(str(tmp_path / "again.pt2"), x) == \
        str(tmp_path / "again.pt2")


def test_deferred_shapes_resolve_at_export(tmp_path):
    net = tmx.gluon.nn.HybridSequential(prefix="deferred_")
    with net.name_scope():
        net.add(tmx.gluon.nn.Dense(8, activation="relu"),
                tmx.gluon.nn.Dense(3))
    net.initialize(ctx="cpu")
    x = tmx.nd.array(np.ones((2, 4), np.float32), ctx="cpu")
    path = net.export_stablehlo(str(tmp_path / "deferred"), x)
    np.testing.assert_array_equal(
        tdeploy.load(path, ctx="cpu")(x).asnumpy(), net(x).asnumpy())


def test_export_traces_the_eager_forward_not_a_capture(tmp_path,
                                                       monkeypatch):
    """A hybridized block is exported through its eager forward: the
    CUDA-graph branch (forced on here, with a capture that raises) is
    never taken, and the archive's output equals the eager call's."""
    _, tnet, x = _dense_nets()
    tx = tmx.nd.array(x, ctx="cpu")
    want = tnet(tx).asnumpy()
    tnet.hybridize()

    def no_capture(*a, **k):
        raise AssertionError("export reached a CUDA graph capture")
    monkeypatch.setattr(tblock, "graphs_on", lambda device: True)
    monkeypatch.setattr(tblock.HybridBlock, "_capture", no_capture)
    path = tnet.export_stablehlo(str(tmp_path / "hybrid"), tx)
    monkeypatch.undo()
    np.testing.assert_array_equal(
        tdeploy.load(path, ctx="cpu")(tx).asnumpy(), want)


@pytest.fixture(scope="module")
def llama():
    jcfg = replace(jl.CONFIGS["tiny"], dtype=jnp.float32, attn_impl="dense",
                   remat=False)
    vals = {f.name: getattr(jcfg, f.name) for f in fields(tl.LlamaConfig)
            if f.name not in ("dtype", "param_dtype")}
    tcfg = tl.LlamaConfig(**vals, dtype=torch.float32,
                          param_dtype=torch.float32)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    jnet = JGluonLlama(jcfg)
    jnet.load_pytree(jparams)
    tnet = GluonLlama(tcfg)
    tnet.load_pytree(jax.tree.map(np.asarray, jparams), ctx="cpu")
    return jnet, tnet, tokens


def test_gluon_llama_artifacts_match(llama, tmp_path):
    jnet, tnet, tokens = llama
    assert tnet.cfg.n_layers == 2 and tnet.cfg.dim == 64
    jtok = jmx.nd.array(tokens, dtype="int32")
    ttok = tmx.nd.array(tokens, ctx="cpu", dtype="int32")
    jpath = jnet.export_stablehlo(str(tmp_path / "jllama"), jtok)
    path = tnet.export_stablehlo(str(tmp_path / "llama"), ttok)
    got = tdeploy.load(path, ctx="cpu")(ttok).asnumpy()
    want = jdeploy.load(jpath)(jtok).asnumpy()
    assert got.shape == (2, 16, 256)
    np.testing.assert_allclose(got, want, **TOL)
    with tmx.autograd.pause(train_mode=False):
        np.testing.assert_array_equal(got, tnet(ttok).asnumpy())


def test_archive_runs_without_the_model_class(llama, tmp_path):
    _, tnet, tokens = llama
    ttok = tmx.nd.array(tokens, ctx="cpu", dtype="int32")
    path = tnet.export_stablehlo(str(tmp_path / "fresh"), ttok)
    np.save(tmp_path / "tok.npy", tokens)
    want = tnet(ttok).asnumpy()
    np.save(tmp_path / "want.npy", want)
    code = f"""
import sys
import numpy as np
import mxtpu_torch as mx
from mxtpu_torch.contrib import deploy
pred = deploy.load({str(path)!r}, ctx="cpu")
tok = mx.nd.array(np.load({str(tmp_path / 'tok.npy')!r}), ctx="cpu",
                  dtype="int32")
out = pred(tok).asnumpy()
assert np.array_equal(out, np.load({str(tmp_path / 'want.npy')!r}))
loaded = [m for m in ("mxtpu_torch.models.llama",
                      "mxtpu_torch.gluon.model_zoo",
                      "mxtpu_torch.gluon", "jax", "mxtpu")
          if m in sys.modules]
assert not loaded, loaded
print("ok")
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", \
        res.stdout + res.stderr


class _Kernels(torch.nn.Module):
    """Two flash forwards (causal, then not) and a conv3x3."""

    def forward(self, q, k, v, x, w):
        from mxtpu_torch.ops import attention, conv
        o = attention.flash_attention(q, k, v, causal=True)
        return (attention.flash_attention(o, k, v),
                conv.conv3x3(x, w))


def test_kernels_trace_to_one_operator_node_each():
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        def bf16(*shape):
            return torch.empty(shape, dtype=torch.bfloat16, device="cuda")
        args = (bf16(1, 4, 128, 64), bf16(1, 2, 128, 64),
                bf16(1, 2, 128, 64), bf16(2, 8, 8, 16), bf16(3, 3, 16, 32))
        program = torch.export.export(_Kernels(), args)
    calls = [n for n in program.graph.nodes if n.op == "call_function"]
    targets = [n.target for n in calls]
    assert targets == [torch.ops.mxtpu_torch.flash_attn_fwd.default,
                       torch.ops.mxtpu_torch.flash_attn_fwd.default,
                       torch.ops.mxtpu_torch.conv3x3.default]
    assert [n.args[3:] for n in calls[:2]] == [(True, 0.125),
                                               (False, 0.125)]
    outs = [n.meta["val"] for n in calls]
    assert [tuple(o.shape) for o in outs] == [(1, 4, 128, 64),
                                              (1, 4, 128, 64),
                                              (2, 8, 8, 32)]
    assert all(o.dtype == torch.bfloat16 and o.device.type == "cuda"
               for o in outs)


def test_lse_operator_fake_shapes():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from mxtpu_torch.ops import attention
    with FakeTensorMode():
        q = torch.empty((2, 4, 33, 128), dtype=torch.bfloat16, device="cuda")
        k = torch.empty((2, 2, 40, 128), dtype=torch.bfloat16, device="cuda")
        o, lse = attention.flash_attention_fwd(q, k, k, causal=True,
                                               return_lse=True)
    assert tuple(o.shape) == (2, 4, 33, 128) and o.dtype == torch.bfloat16
    assert tuple(lse.shape) == (2, 4, 33) and lse.dtype == torch.float32


def test_operators_refuse_cpu_tensors():
    """The operators have a CUDA implementation only; the wrappers never
    hand them a CPU tensor (a CPU call runs the plain version)."""
    q = torch.zeros((1, 2, 4, 64), dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        torch.ops.mxtpu_torch.flash_attn_fwd(q, q, q, True, 0.125)
    from mxtpu_torch.ops import attention
    with pytest.raises(ValueError, match="plain path"):
        attention.flash_attention_fwd(q, q, q)
