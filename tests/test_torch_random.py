"""Parity of mxtpu_torch's ``mx.random`` / ``mx.nd.random`` with mxtpu's
on the CPU.

Both packages are seeded alike (``mx.random.seed(s)``) and draw the
same calls; the reference runs on its default (CPU) context under the
suite's 64-bit jax (``tests/conftest.py``), the port with
``ctx="cpu"``. Tolerances:

- bit for bit: the stateful key after the draws, ``uniform``,
  ``randint`` (int32 and int64; spans 1, 7, 2^31 and past the dtype's
  largest value), ``bernoulli``, ``shuffle`` (n = 10, 5,000, which
  takes two sort rounds, and an (n, 3) array), ``multinomial``'s draws
  and ``get_prob``;
- ``normal`` within 2 float32 ulps (its float32 ``erf_inv`` and
  ``log1p`` are XLA's, op for op; the share bit-equal is printed);
- ``exponential`` within 1 float32 ulp (float64 inside, then cast);
- ``gamma`` within 2 float32 ulps and ``poisson`` counts equal, except
  at an element whose accept decisions part at a near-tie: the port's
  smallest margin there (both sides of the test, in float64 ulps for
  gamma, float32 ulps for poisson) must be within 4 ulps, and is
  printed.
"""
import threading

import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu_torch as tmx
from mxtpu_torch import prng

torch.set_num_threads(2)   # a CPU share for each xdist worker

SEEDS = (0, 1, 42)


def _ulps(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    it = {np.float32: np.int32, np.float64: np.int64}[want.dtype.type]
    return np.abs(got.view(it).astype(np.int64)
                  - want.view(it).astype(np.int64))


def _both(seed, draw_ref, draw_port):
    jmx.random.seed(seed)
    tmx.random.seed(seed)
    return (draw_ref(jmx.nd.random).asnumpy(),
            draw_port(tmx.nd.random).asnumpy())


def _first_key(seed):
    """The key the first draw after ``seed(seed)`` uses."""
    return prng.split(prng.PRNGKey(seed, device="cpu"))[1]


def test_key_chain_after_draws_matches():
    for seed in SEEDS:
        jmx.random.seed(seed)
        tmx.random.seed(seed)
        for mx, kw in ((jmx, {}), (tmx, {"ctx": "cpu"})):
            mx.nd.random.uniform(shape=(3,), **kw)
            mx.nd.random.normal(shape=(2, 2), **kw)
            mx.nd.random.randint(0, 10, shape=(4,), **kw)
            mx.random.uniform(shape=(1,), **kw)
        np.testing.assert_array_equal(
            prng.key_to_numpy(tmx.random.current_key()),
            np.asarray(jmx.random.current_key()))
    assert tmx.random is tmx.nd.random


@pytest.mark.parametrize("low,high,dtype", [(0.0, 1.0, None),
                                            (-3.3, 7.1, "float32"),
                                            (-2.0, 5.0, "float64"),
                                            (0.0, 1.0, "float16")])
def test_uniform_bit_for_bit(low, high, dtype):
    for seed in SEEDS:
        want, got = _both(
            seed,
            lambda r: r.uniform(low, high, shape=(5, 300), dtype=dtype),
            lambda r: r.uniform(low, high, shape=(5, 300), dtype=dtype,
                                ctx="cpu"))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("loc,scale", [(0.0, 1.0), (2.5, 0.3)])
def test_normal_within_two_ulps(loc, scale):
    for seed in SEEDS:
        want, got = _both(
            seed, lambda r: r.normal(loc, scale, shape=(4096,)),
            lambda r: r.normal(loc, scale, shape=(4096,), ctx="cpu"))
        ulps = _ulps(got, want)
        print("normal", loc, scale, "seed", seed, "bit-equal share",
              (ulps == 0).mean(), "max ulps", ulps.max())
        assert ulps.max() <= 2
    want, got = _both(0, lambda r: r.randn(3, 4),
                      lambda r: r.randn(3, 4, ctx="cpu"))
    assert got.shape == (3, 4) and _ulps(got, want).max() <= 2


SPANS = [(0, 1), (0, 7), (5, 5 + 2 ** 31), (-4, 3)]


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_randint_bit_for_bit(dtype):
    info = np.iinfo(dtype)
    spans = SPANS + [(info.min, info.max), (-10, int(info.max) + 1)] \
        if dtype == "int32" else SPANS + [(info.min, info.max),
                                          (1, int(info.max))]
    for seed in SEEDS:
        for lo, hi in spans:
            want, got = _both(
                seed,
                lambda r: r.randint(lo, hi, shape=(2, 500), dtype=dtype),
                lambda r: r.randint(lo, hi, shape=(2, 500), dtype=dtype,
                                    ctx="cpu"))
            assert got.dtype == want.dtype == np.dtype(dtype)
            np.testing.assert_array_equal(got, want)
    # randint(high) draws from [0, high)
    want, got = _both(3, lambda r: r.randint(9, shape=(50,)),
                      lambda r: r.randint(9, shape=(50,), ctx="cpu"))
    np.testing.assert_array_equal(got, want)


def test_exponential_within_one_ulp():
    for seed in SEEDS:
        for scale in (1.0, 2.5):
            want, got = _both(
                seed, lambda r: r.exponential(scale, shape=(4096,)),
                lambda r: r.exponential(scale, shape=(4096,), ctx="cpu"))
            assert got.dtype == want.dtype == np.float32
            assert _ulps(got, want).max() <= 1


@pytest.mark.parametrize("alpha", [0.3, 1.0, 5.0])
def test_gamma_within_two_ulps_but_near_ties(alpha):
    for seed in SEEDS:
        want, got = _both(
            seed, lambda r: r.gamma(alpha, 2.0, shape=(2048,)),
            lambda r: r.gamma(alpha, 2.0, shape=(2048,), ctx="cpu"))
        ulps = _ulps(got, want)
        _, margin = prng.gamma(_first_key(seed), alpha, (2048,),
                               margins=True)
        margin = margin.numpy()
        far = ulps > 2
        print("gamma", alpha, "seed", seed, "bit-equal share",
              (ulps == 0).mean(), "elements past 2 ulps", int(far.sum()),
              "their margins", margin[far], "smallest margin",
              margin.min())
        assert (margin[far] <= 4).all()


@pytest.mark.parametrize("lam", [0.0, 0.5, 4.0, 9.99, 10.0, 40.0, 1000.0])
def test_poisson_counts_equal_but_near_ties(lam):
    for seed in SEEDS:
        want, got = _both(
            seed, lambda r: r.poisson(lam, shape=(4096,)),
            lambda r: r.poisson(lam, shape=(4096,), ctx="cpu"))
        assert got.dtype == want.dtype == np.float32
        _, margin = prng.poisson(_first_key(seed), lam, (4096,),
                                 margins=True)
        margin = margin.numpy()
        differ = got != want
        print("poisson", lam, "seed", seed, "differing", int(differ.sum()),
              "their margins", margin[differ], "smallest margin",
              margin.min())
        assert (margin[differ] <= 4).all()


def test_bernoulli_bit_for_bit():
    """A Python p: the reference draws a float64 uniform against it."""
    for seed in SEEDS:
        for p, dtype in ((0.3, None), (0.9, "int32")):
            want, got = _both(
                seed, lambda r: r.bernoulli(p, shape=(6, 77), dtype=dtype),
                lambda r: r.bernoulli(p, shape=(6, 77), dtype=dtype,
                                      ctx="cpu"))
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("batch", [(), (3,), (2, 3)])
def test_multinomial_layout_and_probs(batch):
    """MXNet's (batch..., n) layout for 0, 1 and 2 batch dims, with and
    without ``shape``, and ``get_prob``'s log-probabilities."""
    rs = np.random.default_rng(len(batch))
    probs = rs.random(batch + (7,)).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    for seed in SEEDS[:2]:
        for shape in (None, (2, 4)):
            jmx.random.seed(seed)
            tmx.random.seed(seed)
            ws, wp = jmx.nd.random.multinomial(jmx.nd.array(probs),
                                               shape=shape, get_prob=True)
            gs, gp = tmx.nd.random.multinomial(tmx.nd.array(probs, ctx="cpu"),
                                               shape=shape, get_prob=True)
            n = () if shape is None else \
                ((shape,) if isinstance(shape, int) else shape)
            assert gs.shape == batch + n == ws.shape
            assert gs.dtype == torch.int32
            np.testing.assert_array_equal(gs.asnumpy(), ws.asnumpy())
            np.testing.assert_array_equal(gp.asnumpy(), wp.asnumpy())


@pytest.mark.parametrize("n", [10, 5000])
def test_shuffle_bit_for_bit(n):
    for seed in SEEDS:
        want, got = _both(
            seed, lambda r: r.shuffle(jmx.nd.array(np.arange(n),
                                                   dtype="int32")),
            lambda r: r.shuffle(tmx.nd.array(np.arange(n), ctx="cpu",
                                             dtype="int32")))
        np.testing.assert_array_equal(got, want)
        assert sorted(got.tolist()) == list(range(n))
    x = np.arange(3 * n, dtype=np.float32).reshape(n, 3)
    want, got = _both(7, lambda r: r.shuffle(jmx.nd.array(x)),
                      lambda r: r.shuffle(tmx.nd.array(x, ctx="cpu")))
    np.testing.assert_array_equal(got, want)


def test_dtype_out_and_ctx():
    tmx.random.seed(0)
    out = tmx.nd.zeros((2, 3), ctx="cpu")
    old = out._data
    res = tmx.nd.random.uniform(-1.0, 1.0, shape=(2, 3), out=out)
    assert res is out and out._data is not old
    assert out.context == torch.device("cpu")
    res = tmx.nd.random.normal(shape=(2, 3), out=out)
    assert res is out and out.dtype == torch.float32
    for fn, kw, dt in ((tmx.nd.random.uniform, {}, torch.float64),
                       (tmx.nd.random.normal, {}, torch.bfloat16),
                       (tmx.nd.random.gamma, {}, torch.float64),
                       (tmx.nd.random.exponential, {}, torch.float16),
                       (tmx.nd.random.poisson, {}, torch.int32),
                       (tmx.nd.random.bernoulli, {}, torch.bool),
                       (tmx.nd.random.randint, {"low": 0, "high": 5},
                        torch.int64)):
        a = fn(shape=(4,), dtype=dt, ctx="cpu", **kw)
        assert a.dtype == dt and a.shape == (4,)
        assert a.context == torch.device("cpu")


def test_ctx_none_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tmx.nd.random.uniform(shape=(2,)),
                 lambda: tmx.nd.random.normal(shape=(2,)),
                 lambda: tmx.nd.random.randint(0, 3, shape=(2,)),
                 lambda: tmx.nd.random.shuffle(np.arange(4))):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()


def test_seed_repeats_a_stream():
    tmx.random.seed(123)
    a = tmx.nd.random.uniform(shape=(64,), ctx="cpu").asnumpy()
    b = tmx.nd.random.uniform(shape=(64,), ctx="cpu").asnumpy()
    tmx.random.seed(123)
    np.testing.assert_array_equal(
        tmx.nd.random.uniform(shape=(64,), ctx="cpu").asnumpy(), a)
    assert not np.array_equal(a, b)


def test_threads_hold_separate_streams():
    """Each thread has its own key: a thread seeded 7 draws the stream of
    seed 7 whatever the others draw meanwhile."""
    tmx.random.seed(7)
    want = tmx.nd.random.uniform(shape=(32,), ctx="cpu").asnumpy()
    got, start = {}, threading.Barrier(3)

    def worker(i, s):
        tmx.random.seed(s)
        start.wait()
        for _ in range(5):
            got.setdefault(i, []).append(
                tmx.nd.random.uniform(shape=(32,), ctx="cpu").asnumpy())

    threads = [threading.Thread(target=worker, args=(i, s))
               for i, s in enumerate((7, 8, 7))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    np.testing.assert_array_equal(got[0][0], want)
    np.testing.assert_array_equal(got[2][0], want)
    for a, b in zip(got[0], got[2]):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(got[1][0], want)


def test_trace_keys_split_functionally():
    tmx.random.seed(0)
    before = tmx.random.current_key().clone()
    key = prng.PRNGKey(99, device="cpu")
    tmx.random.push_trace_key(key)
    a = tmx.nd.random.uniform(shape=(8,), ctx="cpu").asnumpy()
    popped = tmx.random.pop_trace_key()
    np.testing.assert_array_equal(prng.key_to_numpy(popped),
                                  prng.key_to_numpy(prng.split(key)[0]))
    np.testing.assert_array_equal(
        a, prng.uniform(prng.split(key)[1], (8,)).numpy())
    assert torch.equal(tmx.random.current_key(), before)
