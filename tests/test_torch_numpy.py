"""``mx.np``'s function table against the reference's on the CPU: one
case per callable ``jax.numpy`` serves (``torch_np_cases.CASES``), the
reference's ``mxtpu.numpy`` and the port's ``mxtpu_torch.numpy`` on the
same numpy inputs, shapes, dtypes and values compared at the case's
bound, or the same exception type where the reference raises; and an
enumeration of ``dir(jax.numpy)``, ``jax.numpy.linalg`` and
``jax.numpy.fft`` that fails on any name the port does not resolve.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu_torch as tmx
from mxtpu_torch.base import dtype_name

import torch_np_cases as nc

torch.set_num_threads(2)


def _callables(mod):
    return sorted(n for n in dir(mod) if not n.startswith("_")
                  and callable(getattr(mod, n)))


JNP = _callables(jnp)
LINALG = _callables(jnp.linalg)
FFT = _callables(jnp.fft)


@pytest.mark.parametrize("name", nc.FIRST_HALF)
def test_np_function_matches_reference(name, tmp_path):
    nc.check_case(name, tmp_path)


def test_every_jax_numpy_name_resolves():
    """Every callable of ``jax.numpy`` and its ``linalg`` and ``fft``
    has a case here and resolves in the port."""
    other = set(nc.NO_TORCH_TYPE) | set(nc.ABSTRACT) | set(nc.JAX_ORACLE) \
        | set(nc.REFUSED) | {"ndarray", "take"}
    missing = [n for n in JNP if n not in nc.CASES and n not in other]
    missing += [f"linalg_{n}" for n in LINALG
                if f"linalg_{n}" not in nc.CASES]
    missing += [f"fft_{n}" for n in FFT if f"fft_{n}" not in nc.CASES]
    assert not missing, missing
    unresolved = []
    for n in JNP:
        try:
            getattr(tmx.np, n)
        except AttributeError:
            unresolved.append(n)
    for sub, names in (("linalg", LINALG), ("fft", FFT)):
        for n in names:
            try:
                getattr(getattr(tmx.np, sub), n)
            except AttributeError:
                unresolved.append(f"{sub}.{n}")
    assert not unresolved, unresolved
    for n in ("pi", "e", "inf", "nan", "newaxis", "euler_gamma"):
        ref = getattr(jnp, n)
        got = getattr(tmx.np, n)
        assert (got is None and ref is None) or \
            np.isnan(got) and np.isnan(ref) or got == ref, n


@pytest.mark.parametrize("name", nc.NO_TORCH_TYPE)
def test_types_torch_lacks_raise(name):
    with tmx.cpu():
        with pytest.raises(TypeError, match="torch has no such dtype"):
            getattr(tmx.np, name)(1)


def test_abstract_types_and_refusals():
    for n in nc.ABSTRACT:
        assert getattr(tmx.np, n) is getattr(np, n)
    assert tmx.np.issubdtype(tmx.np.float32, tmx.np.floating)
    assert not tmx.np.issubdtype(torch.int32, tmx.np.floating)
    for n in nc.REFUSED:
        with pytest.raises(TypeError):
            getattr(jmx.np, n)(lambda x: x, 1, 1)
        with pytest.raises(TypeError):
            getattr(tmx.np, n)(lambda x: x, 1, 1)


def test_host_names_match_jax_numpy():
    """The names whose result is no array: the reference's wrapper
    raises on them, the port returns what ``jax.numpy`` returns."""
    with pytest.raises(TypeError):
        jmx.np.finfo(np.float32)
    for dt in ("float16", "bfloat16", "float32", "float64"):
        ref, got = jnp.finfo(dt), tmx.np.finfo(dt)
        assert (got.bits, float(got.eps), float(got.max),
                float(got.tiny)) == (ref.bits, float(ref.eps),
                                     float(ref.max),
                                     float(ref.smallest_normal)), dt
    for dt in ("int8", "uint8", "int32", "int64"):
        ref, got = jnp.iinfo(dt), tmx.np.iinfo(dt)
        assert (got.bits, got.min, got.max) == (ref.bits, ref.min, ref.max)
    assert tmx.np.dtype("float32") == torch.float32
    assert tmx.np.dtype(tmx.np.bfloat16) == torch.bfloat16
    for a, b in (("int32", "float32"), ("uint8", "int8"),
                 ("bfloat16", "float16"), ("uint32", "int32")):
        assert dtype_name(tmx.np.promote_types(a, b)) == \
            np.dtype(jnp.promote_types(a, b)).name
    assert tmx.np.get_printoptions() == jnp.get_printoptions()
    with tmx.np.printoptions(precision=3):
        assert np.get_printoptions()["precision"] == 3
    assert isinstance(tmx.np.ComplexWarning("x"), jnp.ComplexWarning)
    x = nc.A34
    with tmx.cpu():
        f = tmx.np.vectorize(lambda v: v * 2 + 1)
        got = f(tmx.np.array(x, dtype="float64"))
    np.testing.assert_allclose(got.asnumpy(),
                               np.asarray(jnp.vectorize(
                                   lambda v: v * 2 + 1)(x)), rtol=1e-15)


def test_out_is_written():
    """``out=`` writes the result into the array given (jax.numpy
    refuses it)."""
    with tmx.cpu():
        a = tmx.np.array(nc.A34, dtype="float64")
        out = tmx.np.zeros((3, 4), dtype="float64")
        r = tmx.np.add(a, 1.0, out=out)
    assert r is out
    np.testing.assert_array_equal(out.asnumpy(), nc.A34 + 1.0)


def test_linalg_and_fft_dir():
    assert set(dir(tmx.np.linalg)) == set(LINALG)
    assert set(dir(tmx.np.fft)) == set(FFT)


def test_index_tricks_match_jax_numpy():
    """``mgrid``, ``ogrid``, ``r_``, ``c_``, ``s_`` and ``index_exp``
    (objects, not functions) give ``jax.numpy``'s values."""
    a = np.arange(3.0)
    with tmx.cpu():
        got = [tmx.np.mgrid[0:3, 0:4], *tmx.np.ogrid[0:2, 1:4],
               tmx.np.mgrid[0:1:5j], tmx.np.r_[tmx.np.array(a), 7.0, 0:3],
               tmx.np.c_[tmx.np.array(a), tmx.np.array(a * 2)]]
    want = [jnp.mgrid[0:3, 0:4], *jnp.ogrid[0:2, 1:4], jnp.mgrid[0:1:5j],
            jnp.r_[a, 7.0, 0:3], jnp.c_[a, a * 2]]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.asnumpy(), np.asarray(w), rtol=1e-7)
    assert tmx.np.s_[1:2] == jnp.s_[1:2]
    assert tmx.np.index_exp[1] == jnp.index_exp[1]
