"""``mx.sym`` over the rest of the op set (``ops_extended``, ``Custom``,
the int8 ops) against ``mxtpu.sym`` on the CPU: every new op composes
and infers its output shapes on meta tensors as the reference's does,
and a few bound through the Executor give the reference's outputs
(1e-6 relative or 2 ulps of the largest magnitude; eigenvectors at 4).
``unique``'s shape depends on its data, so it cannot be inferred, in
either package.
"""
import numpy as np
import pytest
import torch

import mxtpu as jmx
import mxtpu.contrib.quantization  # noqa: F401  (registers its ops)
import mxtpu.operator  # noqa: F401  (registers Custom)
import mxtpu_torch as tmx
import mxtpu_torch.contrib.quantization  # noqa: F401  (registers its ops)

import torch_op_cases as oc

torch.set_num_threads(2)   # a CPU share for each xdist worker

oc.register_custom(jmx)
oc.register_custom(tmx)
_ORDER = list(oc.CASES)


@pytest.fixture(autouse=True)
def _keep_reference_key():
    """The reference's shape inference traces its random ops under
    ``jit``, which stores a tracer as its thread's key; put the key
    back so later tests in this process draw from a real one."""
    from mxtpu.ndarray import random as jrandom
    key = jrandom._key_state().key
    yield
    jrandom._key_state().key = key

# mx.sym over the rest of the op set: (op, input shapes, attrs); the
# graph's inferred shapes and the Executor's outputs against mxtpu's
SYM_CASES = [
    ("GroupNorm", [(2, 4, 3, 3), (4,), (4,)], {"num_groups": 2}),
    ("Correlation", [(2, 3, 6, 6), (2, 3, 6, 6)],
     {"max_displacement": 2, "pad_size": 2}),
    ("DeformableConvolution", [(2, 3, 6, 6), (2, 18, 6, 6), (4, 3, 3, 3)],
     {"kernel": (3, 3), "pad": (1, 1), "num_filter": 4, "no_bias": True}),
    ("BilinearSampler", [(2, 3, 6, 6), (2, 2, 5, 4)], {}),
    ("linalg_syevd", [(4, 4)], {}),
    ("UpSampling", [(2, 3, 4, 4)], {"scale": 2}),
    ("im2col", [(2, 3, 6, 6)], {"kernel": (3, 3), "pad": (1, 1)}),
    ("masked_softmax", [(3, 4)], {}),
]


@pytest.mark.parametrize("op,shapes,attrs", SYM_CASES,
                         ids=[c[0] for c in SYM_CASES])
def test_sym_infers_and_runs_new_ops(op, shapes, attrs):
    rng = np.random.default_rng(2)
    vals = [rng.uniform(-0.9, 0.9, s).astype(np.float32) for s in shapes]
    if op == "linalg_syevd":
        vals = [oc.SPD]

    def run(mx, ctx):
        names = [f"in{i}" for i in range(len(shapes))]
        out = getattr(mx.sym, op)(*[mx.sym.var(n) for n in names],
                                  name="op0", **attrs)
        _, out_shapes, _ = out.infer_shape(**dict(zip(names, shapes)))
        ex = out.bind(ctx, {n: mx.nd.array(v, ctx=ctx)
                            for n, v in zip(names, vals)}, grad_req="null")
        return [tuple(s) for s in out_shapes], \
            [o.asnumpy() for o in ex.forward()]
    (tsh, tout), (jsh, jout) = run(tmx, "cpu"), run(jmx, jmx.cpu())
    assert tsh == jsh
    for g, w in zip(tout, jout):
        oc.assert_close(g, w, False, op, scale=4.0 if op == "linalg_syevd"
                        else 0.0)


def test_sym_unique_cannot_infer():
    out = tmx.sym.unique(tmx.sym.var("x"))
    with pytest.raises(tmx.MXNetError, match="unique"):
        out.infer_shape(x=(5,))


_ORDER_EXT = _ORDER[_ORDER.index(oc.EXT_FROM):]
SYM_INFER = [n for n in _ORDER_EXT
             if oc.CASES[n][0].args and n != "unique" and
             all(isinstance(a, np.ndarray) for a in oc.CASES[n][0].args)]


@pytest.mark.parametrize("op", SYM_INFER)
def test_sym_infer_shape_matches_mxtpu(op):
    """Each new op composes in ``mx.sym`` and infers its output shapes
    on meta tensors as the reference's ``jax.eval_shape`` does (the
    reference's int8 conv does not infer; the port's does)."""
    case = oc.CASES[op][0]
    shapes = {f"x{i}": a.shape for i, a in enumerate(case.args)}

    def infer(mx):
        s = getattr(mx.sym, op)(*[mx.sym.var(n) for n in shapes],
                                name="n0", **case.kw)
        return [tuple(o) for o in s.infer_shape(**shapes)[1]]
    got = infer(tmx)
    if op == "_contrib_quantized_conv":
        with pytest.raises(jmx.base.MXNetError):
            infer(jmx)
        assert got == [(2, 4, 3, 3)]
        return
    assert got == infer(jmx)
