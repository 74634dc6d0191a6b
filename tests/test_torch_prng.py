"""Parity of mxtpu_torch.prng with jax.random on the CPU.

The port reproduces jax's Threefry-2x32 chain in its default mode
(``jax_threefry_partitionable``, impl ``threefry2x32``): keys, splits,
``fold_in``, 8-, 16-, 32- and 64-bit bits and bf16, f16, f32 and f64
uniforms are held bit for bit.
``gumbel`` is ``-log(-log(u))`` on the same bit-exact u; XLA's ``log``
and torch's each round within one ulp of their result but not always
the same way, so the noise is held within 2 ulp of ``max(|g|, 1)``:
the inner log's ulp carries into the outer one as an absolute error of
one ulp of 1. In bf16 the noise is bit-equal (each op rounds to bf16,
as XLA's CPU rounds it); in f16 XLA's CPU ``log`` strays up to 6 ulps
from the exact value, so the port's f16 noise is held within the same
2 ulps of the exact ``-log(-log(u))`` on the same u instead. This file
runs under the suite's 64-bit jax (``tests/conftest.py``), so a Python
``p`` draws in float64 there, and the port is held against the dtype
jax really used.

The rest of ``jax.random``: float32 ``normal`` and ``exponential`` bit
for bit (``mxtpu_torch.xla_math`` writes out XLA's CPU float32 ``log``,
``log1p``, ``erf_inv`` and ``lgamma``, also held alone), float64
``normal`` within 4 ulps and ``exponential`` within 1 (torch's float64
``log`` against the glibc one XLA calls), ``randint``, ``permutation``
and ``categorical(shape=)`` bit for bit, ``gamma`` within 2 float32
ulps and ``poisson`` equal, except where the port's smallest accept-test
margin is within 4 ulps (printed; none on these seeds).
"""
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxtpu_torch import prng

torch.set_num_threads(2)   # a CPU share for each xdist worker

SEEDS = [0, 1, 42, 7919, 2 ** 31 - 1, 2 ** 40 + 3, -1, -7, -2 ** 63]
SHAPES = [(), (7,), (3, 5, 11), (4, 1000)]


def _np(key):
    return prng.key_to_numpy(key)


def _bits_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.reshape(-1).view(np.uint8),
                                  want.reshape(-1).view(np.uint8))


def test_jax_is_in_the_ported_mode():
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_high_dynamic_range_gumbel is False


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_splits_and_fold_in_match_jax(seed):
    key, jkey = prng.PRNGKey(seed, device="cpu"), jax.random.PRNGKey(seed)
    assert key.dtype == torch.int64 and key.shape == (2,)
    np.testing.assert_array_equal(_np(key), np.asarray(jkey))
    for num in (2, 3, 5, (2, 3)):
        np.testing.assert_array_equal(_np(prng.split(key, num)),
                                      np.asarray(jax.random.split(jkey, num)))
    for data in (0, 1, 7, 2 ** 32 - 1):
        np.testing.assert_array_equal(
            _np(prng.fold_in(key, data)),
            np.asarray(jax.random.fold_in(jkey, data)))
    # a 0-d tensor folds in modulo 2**32, as jax's astype(uint32) does
    np.testing.assert_array_equal(
        _np(prng.fold_in(key, torch.tensor(-3, dtype=torch.int32))),
        np.asarray(jax.random.fold_in(jkey, jnp.int32(-3))))
    # a chain of splits and folds, as generate and the train step walk it
    for i in range(6):
        key, sub = prng.split(key)
        jkey, jsub = jax.random.split(jkey)
        key = prng.fold_in(key, i)
        jkey = jax.random.fold_in(jkey, i)
    np.testing.assert_array_equal(_np(key), np.asarray(jkey))
    np.testing.assert_array_equal(_np(sub), np.asarray(jsub))


@pytest.mark.parametrize("bit_width", [8, 16, 32, 64])
def test_random_bits_match_jax(bit_width):
    jdtype = {8: jnp.uint8, 16: jnp.uint16, 32: jnp.uint32,
              64: jnp.uint64}[bit_width]
    for seed in SEEDS[:5]:
        key, jkey = prng.PRNGKey(seed, device="cpu"), \
            jax.random.PRNGKey(seed)
        for shape in SHAPES:
            got = prng.random_bits(key, bit_width, shape)
            assert got.dtype == torch.int64 and tuple(got.shape) == shape
            want = np.asarray(jax.random.bits(jkey, shape, jdtype))
            got = got.numpy()
            got = got.view(np.uint64) if bit_width == 64 \
                else got.astype(want.dtype)
            assert (got.astype(np.uint64) >> bit_width == 0).all()
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16",
                                   "float16"])
def test_uniform_matches_jax_bit_for_bit(dtype):
    """Bounds other than [0, 1) hold the fused multiply-add: XLA rounds
    ``floats * (maxval - minval) + minval`` once (in bf16, the product
    and the sum each). bf16 draws 8 bits, f16 16."""
    tdtype = getattr(torch, dtype)
    for seed in SEEDS[:5]:
        key, jkey = prng.PRNGKey(seed, device="cpu"), \
            jax.random.PRNGKey(seed)
        for shape in SHAPES:
            for lo, hi in ((0.0, 1.0), (-3.3, 7.1), (1e-3, 2.5),
                           (-1e5, 3.0)):
                got = prng.uniform(key, shape, tdtype, lo, hi)
                assert got.dtype == tdtype
                want = jax.random.uniform(jkey, shape, jnp.dtype(dtype), lo,
                                          hi)
                if tdtype.itemsize == 2:
                    got = got.view(torch.int16)
                    want = np.asarray(want).view(np.int16)
                _bits_equal(got.numpy(), want)


def _gumbel_ulps(got, want):
    """|got - want| in ulps of max(|want|, 1) (see the module docstring)."""
    scale = np.spacing(np.maximum(np.abs(want), 1).astype(want.dtype))
    return np.abs(got.astype(np.float64) - want) / scale


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_gumbel_within_two_ulp_of_jax(dtype):
    for seed in SEEDS[:4]:
        key, jkey = prng.PRNGKey(seed, device="cpu"), \
            jax.random.PRNGKey(seed)
        got = prng.gumbel(key, (4, 1000), getattr(torch, dtype)).numpy()
        want = np.asarray(jax.random.gumbel(jkey, (4, 1000),
                                            jnp.dtype(dtype)))
        assert got.dtype == want.dtype
        ulps = _gumbel_ulps(got, want)
        assert ulps.max() <= 2, (seed, ulps.max())
    with pytest.raises(NotImplementedError, match="high"):
        prng.gumbel(key, (3,), mode="high")


def test_16_bit_gumbel_and_categorical_match_jax():
    """bf16 gumbel bit-equal to jax's (within 2 ulps of max(|g|, 1) is
    the bound), f16 within 2 ulps of max(|g|, 1) of the exact
    ``-log(-log(u))`` on the same u (the f32 test's bound, against the
    exact value: XLA's f16 ``log`` strays from it), and ``categorical``
    on bf16 and f16 logits draws jax's tokens."""
    rng = np.random.default_rng(11)
    lg = rng.standard_normal((6, 97)) * 2
    for seed in SEEDS[:4]:
        key, jkey = prng.PRNGKey(seed, device="cpu"), \
            jax.random.PRNGKey(seed)
        got = prng.gumbel(key, (4, 1000), torch.bfloat16).float().numpy()
        want = np.asarray(jax.random.gumbel(jkey, (4, 1000), jnp.bfloat16)
                          .astype(jnp.float32))
        ulp = 2.0 ** -7 * 2.0 ** np.floor(np.log2(np.maximum(np.abs(want),
                                                             1)))
        assert (np.abs(got - want) / ulp).max() <= 2, seed
        tiny = float(torch.finfo(torch.float16).tiny)
        u = prng.uniform(key, (4, 1000), torch.float16, tiny, 1.0)
        g = prng.gumbel(key, (4, 1000), torch.float16).double().numpy()
        exact = -np.log(-np.log(u.double().numpy()))
        spacing = np.spacing(np.maximum(np.abs(exact), 1).astype(
            np.float16)).astype(np.float64)
        assert (np.abs(g - exact) / spacing).max() <= 2, seed
        for tdtype, jdtype in ((torch.bfloat16, jnp.bfloat16),
                               (torch.float16, jnp.float16)):
            lt = torch.tensor(lg).to(tdtype)
            lj = jnp.asarray(lt.float().numpy()).astype(jdtype)
            np.testing.assert_array_equal(
                prng.categorical(key, lt).numpy(),
                np.asarray(jax.random.categorical(jkey, lj)))


def test_categorical_and_bernoulli_match_jax():
    rng = np.random.default_rng(3)
    lg32 = (rng.standard_normal((6, 97)) * 2).astype(np.float32)
    lg64 = rng.standard_normal((5, 40))
    for seed in SEEDS[:6]:
        key, jkey = prng.PRNGKey(seed, device="cpu"), \
            jax.random.PRNGKey(seed)
        for lg in (lg32, lg64):
            got = prng.categorical(key, torch.from_numpy(lg))
            want = jax.random.categorical(jkey, jnp.asarray(lg))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            prng.categorical(key, torch.from_numpy(lg32), axis=0).numpy(),
            np.asarray(jax.random.categorical(jkey, jnp.asarray(lg32),
                                              axis=0)))
        # a Python p: jax's 64-bit mode draws it in float64, so the port
        # is given a float64 p; outside that mode both draw in float32
        jb = jax.random.bernoulli(jkey, 0.9, (4, 33))
        assert jnp.asarray(0.9).dtype == jnp.float64
        p64 = torch.tensor(0.9, dtype=torch.float64)
        np.testing.assert_array_equal(
            prng.bernoulli(key, p64, (4, 33)).numpy(), np.asarray(jb))
        np.testing.assert_array_equal(
            prng.bernoulli(key, 0.9, (4, 33)).numpy(),
            np.asarray(jax.random.bernoulli(jkey, jnp.float32(0.9),
                                            (4, 33))))
        # an f32 p of its own shape draws in float32
        p = rng.random((3, 8)).astype(np.float32)
        np.testing.assert_array_equal(
            prng.bernoulli(key, torch.from_numpy(p)).numpy(),
            np.asarray(jax.random.bernoulli(jkey, jnp.asarray(p))))


def test_keys_cross_as_numpy_and_bad_keys_raise():
    jkey = jax.random.split(jax.random.PRNGKey(9))[1]
    key = prng.key_from_numpy(np.asarray(jkey), device="cpu")
    np.testing.assert_array_equal(prng.key_to_numpy(key), np.asarray(jkey))
    np.testing.assert_array_equal(
        _np(prng.split(key)), np.asarray(jax.random.split(jkey)))
    with pytest.raises(TypeError, match="uint32"):
        prng.key_from_numpy(np.zeros(2, np.int64))
    meta = torch.zeros(2, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="meta"):
        prng.split(meta)
    # (2, 2) is a batch of two keys now (jax.vmap's semantics); a batch
    # of batches is refused
    for bad in (torch.zeros(3, dtype=torch.int64),
                torch.zeros((2, 2, 2), dtype=torch.int64),
                torch.zeros(2, dtype=torch.int32), np.zeros(2, np.uint32)):
        with pytest.raises(TypeError, match="shape \\(2,\\)"):
            prng.uniform(bad, (3,))
    key = prng.PRNGKey(0, device="cpu")
    with pytest.raises(OverflowError):
        prng.PRNGKey(2 ** 63)
    with pytest.raises(OverflowError):
        prng.fold_in(key, -1)
    with pytest.raises(TypeError, match="float32 or float64"):
        prng.uniform(key, (3,), torch.int32)
    with pytest.raises(ValueError, match="bit_width"):
        prng.random_bits(key, 12, (3,))
    with pytest.raises(ValueError, match="meta"):
        prng.categorical(key, torch.zeros(2, 5, device="meta"))


# --- the rest of jax.random: normal, exponential, randint, permutation,
# categorical(shape=), gamma, poisson. Float32 normals and exponentials
# use the port's copy of XLA's CPU math (mxtpu_torch.xla_math); float64
# ones call torch's log, within an ulp of the glibc log XLA calls.

def _ulps(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    it = {np.float32: np.int32, np.float64: np.int64}[want.dtype.type]
    return np.abs(got.view(it).astype(np.int64)
                  - want.view(it).astype(np.int64))


@pytest.mark.parametrize("dtype,max_ulps", [("float32", 0), ("float64", 4)])
def test_normal_matches_jax(dtype, max_ulps):
    for seed in SEEDS[:4]:
        key, jkey = prng.PRNGKey(seed, device="cpu"), \
            jax.random.PRNGKey(seed)
        for shape in SHAPES[1:]:
            got = prng.normal(key, shape, getattr(torch, dtype)).numpy()
            want = np.asarray(jax.random.normal(jkey, shape,
                                                jnp.dtype(dtype)))
            assert _ulps(got, want).max() <= max_ulps, seed
    # a batch of keys draws row i from key i (jax.vmap)
    keys = prng.split(prng.PRNGKey(5, device="cpu"), 3)
    jkeys = jax.random.split(jax.random.PRNGKey(5), 3)
    got = prng.normal(keys, (4,), getattr(torch, dtype)).numpy()
    want = np.asarray(jax.vmap(lambda k: jax.random.normal(
        k, (4,), jnp.dtype(dtype)))(jkeys))
    assert _ulps(got, want).max() <= max_ulps


def test_xla_math_matches_xla_cpu_float32():
    """log, log1p, erf_inv and lgamma (x >= 0.5) bit for bit with XLA's
    CPU code on 2^16 inputs each, special values included (NaN where
    XLA gives NaN)."""
    from mxtpu_torch import xla_math as xm
    rng = np.random.default_rng(11)
    pos = np.concatenate([np.exp(rng.uniform(-80, 80, 1 << 16)),
                          [0, -0.0, -1, np.inf, np.nan, 1e-40, 1]]
                         ).astype(np.float32)
    x1 = np.concatenate([rng.uniform(-1, 3, 1 << 15),
                         rng.uniform(-0.5, 0.5, 1 << 15),
                         [-1, 0, np.inf]]).astype(np.float32)
    u = np.nextafter(rng.uniform(-1, 1, 1 << 16).astype(np.float32),
                     np.float32(0))
    u = np.concatenate([u, [-1, 1, 0]]).astype(np.float32)
    k = np.concatenate([np.arange(1, 2 ** 14), rng.uniform(0.5, 2e3, 2 ** 14)]
                       ).astype(np.float32)
    for fn, jfn, x in ((xm.log, jnp.log, pos), (xm.log1p, jnp.log1p, x1),
                       (xm.erf_inv, jax.lax.erf_inv, u),
                       (xm.lgamma, jax.lax.lgamma, k)):
        got = fn(torch.from_numpy(x)).numpy()
        want = np.asarray(jax.jit(jfn)(x))
        nan = np.isnan(want)             # XLA's NaN is all ones, torch's not
        np.testing.assert_array_equal(np.isnan(got), nan)
        np.testing.assert_array_equal(got[~nan].view(np.int32),
                                      want[~nan].view(np.int32))


def _round_exact(fr, np_dtype):
    """The Fraction ``fr`` rounded once to ``np_dtype``, ties to even."""
    x = np_dtype(float(fr))              # within an ulp (float32: maybe
    cands = [np.nextafter(x, np_dtype(-np.inf)), x,   # rounded twice)
             np.nextafter(x, np_dtype(np.inf))]
    itype = np.int32 if np_dtype == np.float32 else np.int64
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - fr),
                                     int(np.array(c).view(itype)) & 1))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_fma_rounds_once(dtype):
    """``xla_math.fma`` is ``a * b + c`` rounded once, against exact
    rational arithmetic: random triples, cancellations, and float32
    cases where ``a * b + c`` rounded to float64 first lands on a
    float32 midpoint (rounded twice, it goes the wrong way)."""
    from mxtpu_torch import xla_math as xm
    np_dtype = getattr(np, dtype)
    rng = np.random.default_rng(3)
    a, b, c = (rng.standard_normal(600) * np.exp2(rng.integers(-20, 20, 600))
               for _ in range(3))
    a, b = a.astype(np_dtype), b.astype(np_dtype)
    c = np.concatenate([c[:300], -(a[300:].astype(np.float64)
                                   * b[300:])]).astype(np_dtype)
    eps = np.finfo(np_dtype).eps
    e = rng.integers(-30, 30, 200).astype(np.float64)
    k = 2 * rng.integers(1, 2 ** 20, 200) + 1          # odd mantissas
    sign = rng.choice([-1.0, 1.0], 200)
    a = np.concatenate([a, sign * np.exp2(e) * (1 + eps)]).astype(np_dtype)
    b = np.concatenate([b, np.full(200, 1 - eps)]).astype(np_dtype)
    c = np.concatenate([c, sign * np.exp2(e + 24) * (1 + k * eps)]
                       ).astype(np_dtype)
    got = xm.fma(torch.from_numpy(a), torch.from_numpy(b),
                 torch.from_numpy(c)).numpy()
    want = np.array([_round_exact(Fraction(float(x)) * Fraction(float(y))
                                  + Fraction(float(z)), np_dtype)
                     for x, y, z in zip(a, b, c)], np_dtype)
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
    # Python floats for b and c take the same path
    np.testing.assert_array_equal(
        xm.fma(torch.from_numpy(a[:5]), float(b[0]), float(c[0])).numpy(),
        [_round_exact(Fraction(float(x)) * Fraction(float(b[0]))
                      + Fraction(float(c[0])), np_dtype) for x in a[:5]])
    if dtype == "float32":               # the double rounding is real
        last = slice(-200, None)
        twice = ((a[last].astype(np.float64) * b[last] + c[last])
                 .astype(np.float32))
        assert (twice != want[last]).any()


def test_exponential_matches_jax():
    for seed in SEEDS[:4]:
        key, jkey = prng.PRNGKey(seed, device="cpu"), \
            jax.random.PRNGKey(seed)
        got = prng.exponential(key, (3, 1000), torch.float32).numpy()
        _bits_equal(got, jax.random.exponential(jkey, (3, 1000),
                                                jnp.float32))
        got = prng.exponential(key, (3, 1000), torch.float64).numpy()
        want = np.asarray(jax.random.exponential(jkey, (3, 1000)))
        assert _ulps(got, want).max() <= 1
        assert _ulps(got.astype(np.float32),
                     want.astype(np.float32)).max() <= 1


RANDINT_BOUNDS = [(0, 1), (0, 7), (-3, 4), (0, 2 ** 31), (-2 ** 31, 2 ** 31),
                  (5, 5), (7, 3), (-100, 2 ** 40), (0, 256),
                  (-2 ** 63, 2 ** 63 - 1), (1, 2 ** 63 - 1), (-2 ** 62, 3)]


@pytest.mark.parametrize("dtype", ["int32", "int64", "int8", "uint8"])
def test_randint_matches_jax(dtype):
    """Spans of 1, 7, 2^31 and past the dtype's largest value, empty and
    reversed ranges: XLA's unsigned arithmetic, bit for bit."""
    for seed in SEEDS[:3]:
        key, jkey = prng.PRNGKey(seed, device="cpu"), \
            jax.random.PRNGKey(seed)
        for lo, hi in RANDINT_BOUNDS:
            got = prng.randint(key, (2, 500), lo, hi, getattr(torch, dtype))
            want = np.asarray(jax.random.randint(jkey, (2, 500), lo, hi,
                                                 jnp.dtype(dtype)))
            np.testing.assert_array_equal(got.numpy(), want)
            assert str(got.dtype) == "torch." + str(want.dtype)


def test_permutation_matches_jax():
    """1 round up to n = 1625, 2 past it; an (n, 3) array is indexed by a
    shuffled arange."""
    for seed in SEEDS[:3]:
        key, jkey = prng.PRNGKey(seed, device="cpu"), \
            jax.random.PRNGKey(seed)
        for n in (1, 10, 1625, 1626, 5000):
            np.testing.assert_array_equal(
                prng.permutation(key, n).numpy(),
                np.asarray(jax.random.permutation(jkey, n)))
        x = np.arange(36).reshape(12, 3)
        for axis in (0, 1):
            np.testing.assert_array_equal(
                prng.permutation(key, torch.from_numpy(x), axis).numpy(),
                np.asarray(jax.random.permutation(jkey, x, axis)))


def test_categorical_with_shape_matches_jax():
    lg = np.random.default_rng(4).standard_normal((3, 4, 10)) \
        .astype(np.float32)
    # jitted, as eager jax costs seconds a call here; the jit adds no
    # multiply to fuse (noise + logits, then argmax)
    cat = jax.jit(jax.random.categorical, static_argnums=(2, 3))
    for seed in SEEDS[:3]:
        key, jkey = prng.PRNGKey(seed, device="cpu"), \
            jax.random.PRNGKey(seed)
        for shape, axis in ((None, -1), ((5, 3, 4), -1), ((6, 2, 3, 4), 2)):
            np.testing.assert_array_equal(
                prng.categorical(key, torch.from_numpy(lg), axis, shape)
                .numpy(), np.asarray(cat(jkey, lg, axis, shape)))
    with pytest.raises(ValueError, match="batch shape"):
        prng.categorical(key, torch.from_numpy(lg), shape=(3, 5))


def _decisions_agree(got, want, margin, ulps, bound):
    """Elements that differ are allowed only at a near-tie: the port's
    smallest accept-test margin there is within ``bound`` ulps."""
    differ = ulps > 0
    if differ.any():
        print("differing elements", int(differ.sum()), "margins",
              margin[differ])
    assert (margin[differ] <= bound).all(), margin[differ]


@pytest.mark.parametrize("alpha", [0.3, 1.0, 5.0])
def test_gamma_matches_jax(alpha):
    """Per-element key chains and accept loops as jax vmaps them:
    float32 results within 2 ulps wherever the accept decisions agree
    (the float64 inside differs from XLA's by an ulp of log)."""
    for seed in SEEDS[:3]:
        key, jkey = prng.PRNGKey(seed, device="cpu"), \
            jax.random.PRNGKey(seed)
        got, margin = prng.gamma(key, alpha, (2048,), margins=True)
        want = np.asarray(jax.random.gamma(jkey, alpha, (2048,)))
        assert got.dtype == torch.float64
        ulps = _ulps(got.numpy().astype(np.float32), want.astype(np.float32))
        print("alpha", alpha, "seed", seed, "f32 bit-equal share",
              (ulps == 0).mean(), "min margin (f64 ulps)", margin.min())
        _decisions_agree(got, want, margin.numpy(),
                         np.where(ulps > 2, ulps, 0), 4)
    # float32 draws and an array of alphas take the same path
    a = np.array([[0.5, 2.0, 9.0]])
    got = prng.gamma(key, torch.from_numpy(a), (4, 3), torch.float32)
    want = np.asarray(jax.random.gamma(jkey, a, (4, 3), jnp.float32))
    assert _ulps(got.numpy(), want).max() <= 2


@pytest.mark.parametrize("lam", [0.0, 0.5, 4.0, 9.99, 10.0, 40.0, 1000.0])
def test_poisson_matches_jax(lam):
    """Knuth below 10, Hormann from 10, on one key: counts equal but at
    a decision within 4 float32 ulps (none on these seeds)."""
    for seed in SEEDS[:3]:
        key, jkey = prng.PRNGKey(seed, device="cpu"), \
            jax.random.PRNGKey(seed)
        got, margin = prng.poisson(key, lam, (4096,), margins=True)
        want = np.asarray(jax.random.poisson(jkey, lam, (4096,)))
        assert got.dtype == torch.int64 and want.dtype == np.int64
        print("lam", lam, "seed", seed, "min margin (f32 ulps)",
              margin.min())
        _decisions_agree(got, want, margin.numpy(),
                         (got.numpy() != want).astype(np.int64), 4)
    lams = np.array([0.0, 3.0, 12.0, np.nan], np.float32)
    np.testing.assert_array_equal(
        prng.poisson(key, torch.from_numpy(lams), (5, 4), torch.int32),
        np.asarray(jax.random.poisson(jkey, lams, (5, 4), jnp.int32)))


@pytest.mark.parametrize("dist,param", [
    ("poisson", 4.0), ("poisson", 10.0), ("poisson", 40.0),
    ("poisson", 1000.0), ("gamma", 0.3), ("gamma", 5.0)])
def test_near_tie_margins_are_finite(dist, param):
    """A margin counts only the comparisons that decided its element and
    leaves out a distance from an infinite or NaN side (Hormann's
    rejected k < 0, whose lgamma is NaN; a log of 0): every element's
    margin is a number. Asking for margins leaves the draw as it is."""
    draw = getattr(prng, dist)
    key = prng.PRNGKey(5, device="cpu")
    got, margin = draw(key, param, (4096,), margins=True)
    assert margin.dtype == torch.float64
    assert torch.isfinite(margin).all(), margin[~torch.isfinite(margin)]
    assert torch.equal(got, draw(key, param, (4096,)))
