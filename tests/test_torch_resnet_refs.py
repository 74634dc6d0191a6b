"""Shared scaffolding of the ResNet parity tests (``test_torch_resnet.py``,
``test_torch_resnet50.py``); it holds no tests itself.

Both packages get the same weights: a numpy tree with the reference's
keys and shapes (``jax.eval_shape`` of its ``init_params`` and
``init_state``), drawn from a seeded numpy generator at He scale, with
BN scales and biases away from 1 and 0 and running statistics away from
0 and 1, so every term of the normalisation counts. The tree crosses
bit for bit, and both packages run the same images.

Configurations: ``tiny`` (depth 18, width 8) and a bottleneck one,
``r50w8`` (``resnet50`` at width 8, 10 classes). At 36×36 the later
stages reach odd sizes (18, 9, 5, 3, 2), where XLA's SAME padding is
symmetric again; at 32×32 every stride-2 window pads (0, 1) and the
last stage is 1×1.

:func:`run` memoizes each (side, config, size, dtype) forward, eval and
train. The reference runs jitted, as its train step runs it, compiled
with ``xla_allow_excess_precision`` off: by default XLA may drop a
bf16 rounding between fused ops (a convert to bf16 and back), so its
bf16 result would sit between a bf16 and an f32 computation. With the
flag off every ``astype`` of the reference rounds, as every ``.to`` of
the port does, and the two compute the same values up to summation
order.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mxtpu.models import resnet as jr
from mxtpu_torch.models import resnet as tr

torch.set_num_threads(2)   # a CPU share for each xdist worker

_WEIGHTS = {}
_RUNS = {}
_STRICT = {"xla_allow_excess_precision": False}


def ref_cfg(name):
    if name == "tiny":
        return jr.CONFIGS["tiny"]
    return replace(jr.CONFIGS["resnet50"], width=8, num_classes=10)


def port_cfg(jcfg, dtype):
    return tr.ResNetConfig(depth=jcfg.depth, num_classes=jcfg.num_classes,
                           width=jcfg.width, dtype=dtype, stem=jcfg.stem)


def images(seed, hw, n=4):
    return np.random.default_rng(seed).standard_normal(
        (n, hw, hw, 3)).astype(np.float32)


def rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def leaves(tree):
    return [np.asarray(a, np.float32) for a in jax.tree.leaves(tree)]


def _numpy_tree(shapes, rng):
    """Seeded f32 leaves for a tree of ShapeDtypeStructs, by leaf name."""
    def leaf(path, s):
        key = path[-1].key
        z = rng.standard_normal(s.shape)
        if key.startswith(("stem_conv", "conv", "down_conv")):
            z *= np.sqrt(2.0 / np.prod(s.shape[:-1]))      # He scale
        elif key == "fc_w":
            z /= np.sqrt(s.shape[0])
        elif key in ("scale", "var"):
            z = 1.0 + 0.2 * np.abs(z)
        else:                                 # bias, fc_b, mean
            z *= 0.1
        return z.astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def weights(name):
    """(params, running state) as numpy trees with the reference's
    structure, one pair per config and session."""
    if name not in _WEIGHTS:
        cfg = ref_cfg(name)
        rng = np.random.default_rng(len(name))
        params = jax.eval_shape(lambda: jr.init_params(
            cfg, jax.random.PRNGKey(0)))
        state = jax.eval_shape(lambda: jr.init_state(cfg))
        _WEIGHTS[name] = (_numpy_tree(params, rng), _numpy_tree(state, rng))
    return _WEIGHTS[name]


def run(side, name, hw, dtype):
    """(eval logits, train logits, new-state leaves) as numpy for
    ``side`` "ref" or "port", memoized."""
    key = (side, name, hw, dtype)
    if key in _RUNS:
        return _RUNS[key]
    ptree, stree = weights(name)
    jcfg = replace(ref_cfg(name), dtype=getattr(jnp, dtype))
    x = images(hw, hw)
    if side == "ref":
        jp, js = (jax.tree.map(jnp.asarray, t) for t in (ptree, stree))
        xj = jnp.asarray(x)
        fwd = jax.jit(jr.forward, static_argnums=(0, 4))
        ev, (tl, st) = (fwd.lower(jcfg, jp, xj, js, train).compile(
            compiler_options=_STRICT)(jp, xj, js) for train in (False, True))
        out = (np.asarray(ev), np.asarray(tl), leaves(st))
    else:
        tcfg = port_cfg(jcfg, getattr(torch, dtype))
        tp = tr.params_from_numpy(ptree, device="cpu")
        ts = tr.params_from_numpy(stree, device="cpu")
        xt = torch.from_numpy(x)
        ev = tr.forward(tcfg, tp, xt, ts)
        tl, st = tr.forward(tcfg, tp, xt, ts, train=True)
        for got in (ev, tl):
            assert got.dtype == torch.float32 and got.shape == (4, 10)
        # the state passed in is left as it was
        for a, b in zip(leaves(tr.params_to_numpy(ts)), leaves(stree)):
            np.testing.assert_array_equal(a, b)
        out = (ev.numpy(), tl.detach().numpy(),
               leaves(tr.params_to_numpy(st)))
    _RUNS[key] = out
    return out


def check_f32(name, hw, tol, train_tol):
    """Port vs reference in f32: eval logits within ``tol``, train
    logits and every new-state leaf within ``train_tol``."""
    want = run("ref", name, hw, "float32")
    got = run("port", name, hw, "float32")
    np.testing.assert_allclose(got[0], want[0], **tol)
    np.testing.assert_allclose(got[1], want[1], **train_tol)
    assert len(got[2]) == len(want[2])
    for a, b in zip(got[2], want[2]):
        np.testing.assert_allclose(a, b, **train_tol)


def check_bf16(name, hw, tol, train_tol, state_tol):
    """Port vs reference in bf16, as relative distances: eval logits
    within ``tol``, train logits within ``train_tol``, every new-state
    leaf within ``state_tol``."""
    want = run("ref", name, hw, "bfloat16")
    got = run("port", name, hw, "bfloat16")
    assert rel(got[0], want[0]) <= tol, rel(got[0], want[0])
    assert rel(got[1], want[1]) <= train_tol, rel(got[1], want[1])
    assert len(got[2]) == len(want[2])
    for a, b in zip(got[2], want[2]):
        assert rel(a, b) <= state_tol, rel(a, b)
