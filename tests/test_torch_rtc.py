"""mxtpu_torch.rtc on the CPU: ``torch_kernel`` against the reference's
``jax_kernel``, ``CudaModule``'s lookups, signature check and refusals,
the plain versions of the two CUDA user kernels against the reference's
Pallas kernels of the same bodies (run in interpret mode), and the
slice as a whole: llama's SwiGLU FFN through both packages' ``mx.nd``
and autograd.

The CUDA kernels themselves need ``nvcc`` and a card: ``chip_smoke.py``
builds them and holds them against these plain versions there. Here a
launch must raise before any ``nvcc`` call.

Tolerances: float32 results and grads within 1e-6 (``mish``, one
elementwise function) or 1e-5 relative (the FFN: two products and a
reduction over 64 or 176 terms, summed in another order); ``scale_add``
exactly (``x·2`` is exact, so both round once); ``swiglu`` within one
bfloat16 ulp (both round ``silu(g)·u`` from float32 once, and the two
libraries' ``exp`` may differ by an ulp of float32, which can move a
value across a bfloat16 rounding boundary).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import mxtpu as jmx
import mxtpu_torch as tmx
from mxtpu_torch import rtc
from mxtpu_torch.ops import _build
from mxtpu_torch.tools import rtc_kernels as rk

torch.set_num_threads(2)

rng = np.random.default_rng(2)


def test_torch_kernel_matches_jax_kernel():
    xs = np.linspace(-2, 2, 7).astype(np.float32)
    jmish = jmx.rtc.jax_kernel(
        lambda x: x * jnp.tanh(jnp.log1p(jnp.exp(x))), name="mish")
    tmish = rtc.torch_kernel(
        lambda x: x * torch.tanh(torch.log1p(torch.exp(x))), name="mish")
    assert tmish.__name__ == "mish"
    out = []
    for mx, mish, ctx in ((jmx, jmish, None), (tmx, tmish, "cpu")):
        x = mx.nd.array(xs, ctx=ctx)
        x.attach_grad()
        with mx.autograd.record():
            y = mish(x).sum()
        y.backward()
        out.append((mish(x).asnumpy(), x.grad.asnumpy()))
    (ry, rg), (ty, tg) = out
    np.testing.assert_allclose(ty, ry, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tg, rg, rtol=1e-6, atol=1e-6)
    assert float(np.abs(tg).sum()) > 0


def test_torch_kernel_passes_keywords():
    x = tmx.nd.array(np.arange(6.0).reshape(2, 3), ctx="cpu")
    soft = rtc.torch_kernel(torch.softmax, name="softmax")
    got = soft(x, dim=0).asnumpy()
    np.testing.assert_allclose(got.sum(axis=0), np.ones(3), rtol=1e-6)


def test_module_lookups():
    mod = rk.module()
    assert mod.kernel_names == ["scale_add", "swiglu"]
    kern = mod.get_kernel("scale_add")
    assert kern.name == "scale_add" and kern.module is mod
    with pytest.raises(tmx.MXNetError, match="not found"):
        mod.get_kernel("nope")
    only = rtc.CudaModule(rk.SOURCE, exports=["swiglu"])
    with pytest.raises(tmx.MXNetError, match="not found"):
        only.get_kernel("scale_add")
    with pytest.raises(tmx.MXNetError, match="not __global__"):
        rtc.CudaModule(rk.SOURCE, exports=["scale_add", "missing"])


def test_parse_kernels():
    src = r'''
    // __global__ void commented_out(float* x, long long n) {}
    /* __global__ void also_out(float* x) {} */
    template <typename T> __global__ void templ(T* x, long long n) {}
    __global__ void __launch_bounds__(256) plain(const float* __restrict__ a,
        float *b, int k, double s, long long n) {}
    extern "C" __global__ void empty() {}
    '''
    ks = rtc.parse_kernels(src)
    assert list(ks) == ["plain", "empty"]
    assert [p.describe() for p in ks["plain"]] == [
        "const float* a", "float* b", "int k", "double s", "long long n"]
    assert ks["empty"] == []
    with pytest.raises(tmx.MXNetError, match="unsupported"):
        rtc.parse_params("float** x")


def test_signature_argument():
    mod = rk.module()
    mod.get_kernel("swiglu", "const __nv_bfloat16* g, const __nv_bfloat16 *u,"
                             " __nv_bfloat16* o, long long n")
    with pytest.raises(tmx.MXNetError, match="in the source"):
        mod.get_kernel("swiglu", "const float* g, const float* u, float* o, "
                                 "long long n")
    bad = rtc.CudaModule("__global__ void k(float2* v, long long n) {}")
    with pytest.raises(tmx.MXNetError, match="cannot pass"):
        bad.get_kernel("k")


def test_default_output_shape_and_dtype():
    kern = rk.module().get_kernel("scale_add")
    x = tmx.nd.array(rng.standard_normal((2, 128)), ctx="cpu")
    y = tmx.nd.array(rng.standard_normal((2, 128)), ctx="cpu")
    assert kern._plan((x, y)) == ((2, 128), torch.float32)
    assert kern._plan((x, y), out_shape=(256,)) == ((256,), torch.float32)
    with pytest.raises(tmx.MXNetError, match="output parameter"):
        kern._plan((x, y), out_dtype="float64")
    with pytest.raises(tmx.MXNetError, match="at least one input array"):
        kern.launch()


def test_signature_check_refuses_mismatches():
    mod = rk.module()
    kern = mod.get_kernel("scale_add")
    x = tmx.nd.array(rng.standard_normal((4, 8)), ctx="cpu")
    cases = {
        "parameters": (x,),                             # too few
        "takes float32": (x, x.astype("float64")),      # wrong dtype
        "is a pointer": (x, 2.0),                       # scalar for array
    }
    for match, args in cases.items():
        with pytest.raises(tmx.MXNetError, match=match):
            kern.launch(*args)
    with pytest.raises(tmx.MXNetError, match="parameters"):
        kern.launch(x, x, x)                            # too many
    sw = mod.get_kernel("swiglu")
    with pytest.raises(tmx.MXNetError, match="takes bfloat16"):
        sw.launch(x, x)
    scaled = rtc.CudaModule(
        "__global__ void axpy(const float* x, float a, int k, float* o, "
        "long long n) {}").get_kernel("axpy")
    with pytest.raises(tmx.MXNetError, match="is an integer"):
        scaled.launch(x, 2.0, 1.5)
    with pytest.raises(tmx.MXNetError, match="is a scalar"):
        scaled.launch(x, x, 1)
    with pytest.raises(tmx.MXNetError, match="must be an integer"):
        rtc.CudaModule("__global__ void f(const float* x, float* o, "
                       "float n) {}").get_kernel("f").launch(x)


def test_cpu_launch_raises_before_nvcc(monkeypatch):
    def no_nvcc(*a, **k):
        raise AssertionError("nvcc was reached")
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "load_rtc", no_nvcc)
    mod = rk.module()
    kern = mod.get_kernel("scale_add")
    x = tmx.nd.array(rng.standard_normal((2, 128)), ctx="cpu")
    before = dict(rtc.launches)
    with pytest.raises(tmx.MXNetError, match="CUDA device"):
        kern.launch(x, x)
    assert dict(rtc.launches) == before and mod._lib is None


def scale_add_pallas(x_ref, y_ref, o_ref):
    o_ref[...] = x_ref[...] * 2.0 + y_ref[...]


def swiglu_pallas(g_ref, u_ref, o_ref):
    g = g_ref[...].astype(jnp.float32)
    u = u_ref[...].astype(jnp.float32)
    o_ref[...] = (jax.nn.silu(g) * u).astype(o_ref.dtype)


def test_recorded_launch_raises_in_both_packages(monkeypatch):
    monkeypatch.setattr(_build, "load_rtc", None)     # never reached
    xs = rng.standard_normal((2, 128)).astype(np.float32)
    ref_kern = jmx.rtc.PallasModule(interpret=True).compile(
        "scale_add", scale_add_pallas)
    x = jmx.nd.array(xs)
    x.attach_grad()
    with jmx.autograd.record(), pytest.raises(ValueError,
                                              match="Linearization"):
        ref_kern.launch(x, x)
    kern = rk.module().get_kernel("scale_add")
    t = tmx.nd.array(xs, ctx="cpu")
    t.attach_grad()
    with tmx.autograd.record(), pytest.raises(tmx.MXNetError,
                                              match="no gradient"):
        kern.launch(t, t)
    # off the tape (paused, or an input nobody differentiates) the same
    # launch goes on to the device check
    with tmx.autograd.record(), tmx.autograd.pause():
        with pytest.raises(tmx.MXNetError, match="CUDA device"):
            kern.launch(t, t)
    with tmx.autograd.record():
        with pytest.raises(tmx.MXNetError, match="CUDA device"):
            kern.launch(tmx.nd.array(xs, ctx="cpu"), t.detach())


def test_plain_versions_match_the_reference_pallas_kernels():
    mod = jmx.rtc.PallasModule(interpret=True)
    sa, sw = (mod.compile("scale_add", scale_add_pallas),
              mod.compile("swiglu", swiglu_pallas))
    x, y = (rng.standard_normal((2, 128)).astype(np.float32)
            for _ in range(2))
    ref = sa.launch(jmx.nd.array(x), jmx.nd.array(y)).asnumpy()
    got = rk.scale_add_plain(torch.tensor(x), torch.tensor(y)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        rk.scale_add_library(torch.tensor(x), torch.tensor(y)).numpy(), ref)

    g, u = ((rng.standard_normal((16, 128)) * 3).astype(ml_dtypes.bfloat16)
            for _ in range(2))
    ref = sw.launch(jmx.nd.array(g, dtype="bfloat16"),
                    jmx.nd.array(u, dtype="bfloat16")).asnumpy()
    assert ref.dtype == ml_dtypes.bfloat16
    ref = ref.astype(np.float32)
    tg, tu = (torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
              for a in (g, u))
    got = rk.swiglu_plain(tg, tu)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2 ** -7,
                               atol=0)


# ---------------------------------------------------------------------------
# the slice as a whole: llama's SwiGLU FFN through mx.nd and autograd
# ---------------------------------------------------------------------------
DIM, HIDDEN, TOKENS = 64, 176, 12


def ffn_inputs():
    r = np.random.default_rng(3)
    return {"x": r.standard_normal((TOKENS, DIM)).astype(np.float32),
            "w_gate": (r.standard_normal((DIM, HIDDEN)) / 8).astype(
                np.float32),
            "w_up": (r.standard_normal((DIM, HIDDEN)) / 8).astype(
                np.float32),
            "w_down": (r.standard_normal((HIDDEN, DIM)) / 13).astype(
                np.float32),
            "head": r.standard_normal((TOKENS, DIM)).astype(np.float32)}


def ffn(mx, silu, ctx):
    """(a) the forward, not recorded; (b) the same under record() with
    y.backward(head): (y_a, y_b, grads of x, w_gate, w_up, w_down)."""
    v = {k: mx.nd.array(a, ctx=ctx) for k, a in ffn_inputs().items()}
    x, wg, wu, wd = v["x"], v["w_gate"], v["w_up"], v["w_down"]
    y_a = (silu(x @ wg) * (x @ wu)) @ wd
    for a in (x, wg, wu, wd):
        a.attach_grad()
    with mx.autograd.record():
        y_b = (silu(x @ wg) * (x @ wu)) @ wd
    y_b.backward(v["head"])
    return [a.asnumpy() for a in (y_a, y_b, x.grad, wg.grad, wu.grad,
                                  wd.grad)]


def test_ffn_slice_matches_the_reference():
    ref = ffn(jmx, jmx.rtc.jax_kernel(jax.nn.silu, name="silu"), None)
    got = ffn(tmx, rtc.torch_kernel(F.silu, name="silu"), "cpu")
    for name, r, g in zip(("y_a", "y_b", "x", "w_gate", "w_up", "w_down"),
                          ref, got):
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    assert np.abs(got[2]).sum() > 0


def test_ffn_slice_matches_torch_autograd():
    """The port's tape against torch.autograd on the same function."""
    inp = {k: torch.tensor(a) for k, a in ffn_inputs().items()}
    leaves = [inp[k].requires_grad_() for k in ("x", "w_gate", "w_up",
                                                "w_down")]
    x, wg, wu, wd = leaves
    y = (F.silu(x @ wg) * (x @ wu)) @ wd
    want = torch.autograd.grad(y, leaves, inp["head"])
    got = ffn(tmx, rtc.torch_kernel(F.silu, name="silu"), "cpu")
    np.testing.assert_allclose(got[1], y.detach().numpy(), rtol=1e-6,
                               atol=1e-7)
    for g, w in zip(got[2:], want):
        np.testing.assert_allclose(g, w.numpy(), rtol=1e-6, atol=1e-7)


def test_grid_gives_one_thread_a_vector():
    assert rk.grid("scale_add", 8192 * 4096) == 8192 * 4096 // 1024
    assert rk.grid("swiglu", 2048 * 14336) == 2048 * 14336 // 512
    assert rk.grid("swiglu", 3) == 1 and rk.grid("scale_add", 0) == 1
