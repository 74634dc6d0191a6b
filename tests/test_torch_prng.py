"""Parity of mxtpu_torch.prng with jax.random on the CPU.

The port reproduces jax's Threefry-2x32 chain in its default mode
(``jax_threefry_partitionable``, impl ``threefry2x32``): keys, splits,
``fold_in``, 32- and 64-bit bits and uniforms are held bit for bit.
``gumbel`` is ``-log(-log(u))`` on the same bit-exact u; XLA's ``log``
and torch's each round within one ulp of their result but not always
the same way, so the noise is held within 2 ulp of ``max(|g|, 1)``:
the inner log's ulp carries into the outer one as an absolute error of
one ulp of 1. This file runs under the suite's 64-bit jax
(``tests/conftest.py``), so a Python ``p`` draws in float64 there, and
the port is held against the dtype jax really used.
"""
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


@pytest.mark.parametrize("bit_width", [32, 64])
def test_random_bits_match_jax(bit_width):
    jdtype = {32: jnp.uint32, 64: jnp.uint64}[bit_width]
    for seed in SEEDS[:5]:
        key, jkey = prng.PRNGKey(seed, device="cpu"), \
            jax.random.PRNGKey(seed)
        for shape in SHAPES:
            got = prng.random_bits(key, bit_width, shape)
            assert got.dtype == torch.int64 and tuple(got.shape) == shape
            want = np.asarray(jax.random.bits(jkey, shape, jdtype))
            got = got.numpy()
            got = got.astype(np.uint32) if bit_width == 32 \
                else got.view(np.uint64)
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_uniform_matches_jax_bit_for_bit(dtype):
    """Bounds other than [0, 1) hold the fused multiply-add: XLA rounds
    ``floats * (maxval - minval) + minval`` once."""
    tdtype = getattr(torch, dtype)
    for seed in SEEDS[:5]:
        key, jkey = prng.PRNGKey(seed, device="cpu"), \
            jax.random.PRNGKey(seed)
        for shape in SHAPES:
            for lo, hi in ((0.0, 1.0), (-3.3, 7.1), (1e-3, 2.5),
                           (-1e5, 3.0)):
                got = prng.uniform(key, shape, tdtype, lo, hi)
                assert got.dtype == tdtype
                _bits_equal(got.numpy(), jax.random.uniform(
                    jkey, shape, jnp.dtype(dtype), lo, hi))


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
        prng.uniform(key, (3,), torch.bfloat16)
    with pytest.raises(ValueError, match="bit_width"):
        prng.random_bits(key, 16, (3,))
    with pytest.raises(ValueError, match="meta"):
        prng.categorical(key, torch.zeros(2, 5, device="meta"))
