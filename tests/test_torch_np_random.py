"""``mx.np.random`` of the port against the reference's on the CPU:
after one seed, every function draws what the reference draws (bit for
bit; normal within 2 float32 ulps, exponential within 1, gamma within 2
but at an accept test's near-tie, beta, a float32 ratio of two float64
gammas, within 1), and consumes the same keys: the next draw after each
is equal too.
"""
import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu_torch as tmx
from mxtpu_torch import prng

torch.set_num_threads(2)

SEEDS = (0, 7)


def _ulps(got, want):
    it = {np.float32: np.int32, np.float64: np.int64}[want.dtype.type]
    return np.abs(got.view(it).astype(np.int64)
                  - want.view(it).astype(np.int64))


P3 = np.array([0.2, 0.3, 0.5])
P10 = np.exp(np.random.default_rng(3).standard_normal(10))
P10 = (P10 / P10.sum()).astype(np.float32)

DRAWS = {
    "uniform": (lambda r, np_: r.uniform(-1.0, 2.0, size=(257,)), 0),
    "normal": (lambda r, np_: r.normal(2.0, 0.5, size=(500,)), 2),
    "randint": (lambda r, np_: r.randint(0, 10, size=(300,)), 0),
    "rand": (lambda r, np_: r.rand(2, 3), 0),
    "randn": (lambda r, np_: r.randn(4), 2),
    "gamma": (lambda r, np_: r.gamma(2.0, 1.5, size=(100,)), 2),
    "exponential": (lambda r, np_: r.exponential(1.5, size=(100,)), 1),
    "beta": (lambda r, np_: r.beta(2.0, 5.0, size=(300,)), 1),
    "multinomial": (lambda r, np_: r.multinomial(20, P3, size=(5,)), 0),
    "multinomial_p_array": (
        lambda r, np_: r.multinomial(50, np_.array(P10)), 0),
    "choice": (lambda r, np_: r.choice(10, size=(20,)), 0),
    "choice_no_replace": (
        lambda r, np_: r.choice(10, size=(4,), replace=False), 0),
    "choice_p": (lambda r, np_: r.choice(10, size=(64,),
                                         p=np_.array(P10)), 0),
    "choice_p_no_replace": (
        lambda r, np_: r.choice(10, size=(5,), replace=False,
                                p=np_.array(P10)), 0),
    "choice_array": (
        lambda r, np_: r.choice(np_.array(np.arange(5.0) * 3,
                                          dtype="float64"), size=(2, 3)),
        0),
}


def _draw(mx, seed, fn):
    mx.np.random.seed(seed)
    first = fn(mx.np.random, mx.np)
    after = mx.np.random.uniform(size=(16,))
    return first, after


@pytest.mark.parametrize("name", sorted(DRAWS))
def test_draw_matches_reference(name):
    fn, ulps = DRAWS[name]
    for seed in SEEDS:
        ref, ref_after = _draw(jmx, seed, fn)
        with tmx.cpu():
            got, got_after = _draw(tmx, seed, fn)
        assert isinstance(got, tmx.np.ndarray)
        r, g = ref.asnumpy(), got.asnumpy()
        assert g.shape == r.shape and g.dtype == r.dtype, \
            (name, g.dtype, r.dtype)
        if ulps and r.dtype.kind == "f":
            far = _ulps(g, r)
            if name == "gamma":
                key = prng.split(prng.PRNGKey(seed, device="cpu"))[1]
                _, margin = prng.gamma(key, 2.0, (100,), margins=True)
                assert (margin.numpy()[far > ulps] <= 4).all(), name
            else:
                assert far.max() <= ulps, (name, far.max())
        else:
            np.testing.assert_array_equal(g, r, err_msg=name)
        # the same keys consumed: the next draw is the same
        np.testing.assert_array_equal(got_after.asnumpy(),
                                      ref_after.asnumpy())


def test_shuffle_rebinds_in_place():
    x = np.arange(24.0).reshape(6, 4)
    for seed in SEEDS:
        jmx.np.random.seed(seed)
        a = jmx.np.array(x, dtype="float64")
        jmx.np.random.shuffle(a)
        with tmx.cpu():
            tmx.np.random.seed(seed)
            b = tmx.np.array(x, dtype="float64")
            assert tmx.np.random.shuffle(b) is None
        np.testing.assert_array_equal(b.asnumpy(), a.asnumpy())
    with pytest.raises(TypeError):
        tmx.np.random.shuffle(x)


def test_choice_refusals_and_moments():
    with tmx.cpu():
        with pytest.raises(ValueError, match="larger sample"):
            tmx.np.random.choice(3, size=(4,), replace=False)
        with pytest.raises(ValueError, match="1D vector"):
            tmx.np.random.choice(3, size=(2,), p=tmx.np.ones(4) / 4)
        tmx.np.random.seed(5)
        draws = tmx.np.random.choice(10, size=(20000,),
                                     p=tmx.np.array(P10)).asnumpy()
    freq = np.bincount(draws, minlength=10) / draws.size
    se = np.sqrt(P10 * (1 - P10) / draws.size)
    assert (np.abs(freq - P10) < 6 * se).all()
