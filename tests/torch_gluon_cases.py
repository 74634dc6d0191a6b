"""How ``test_torch_gluon*.py`` run one Gluon block through both packages.

A case builds the same block in ``mxtpu.gluon`` and ``mxtpu_torch.gluon``
(explicit prefixes, so the name managers' process-wide counters cannot
make the parameter names differ), initializes it after
``mx.random.seed(0)`` with the default initializer (so the reference's
draws give both the same weights, which the run checks), and calls it
three times: twice under ``autograd.record()`` with ``backward`` from a
seeded head gradient (the first call resolves deferred shapes eagerly;
hybridized, the second goes through the cached program), then once in
predict mode. Outputs, input gradients, parameters (BatchNorm's
running statistics included) and parameter gradients are compared after
each call, within 1e-6 relative or 2 float32 ulps of the array's
largest magnitude, scaled up by ``scale`` for sums whose terms cancel.
"""
import numpy as np

import mxtpu as jmx
import mxtpu_torch as tmx

REF_CTX, PORT_CTX = jmx.cpu(), "cpu"


def close(got, want, what, scale=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    finite = np.abs(want[np.isfinite(want)])
    top = max(float(finite.max()) if finite.size else 0.0, scale)
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=2 * float(np.spacing(np.float32(top))),
                               err_msg=what)


def _outs(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def run(mx, ctx, make, xs, diff, hybrid):
    """The three calls; returns one record per call: outputs, input
    grads, and {name: (value, grad or None)} of the parameters."""
    mx.random.seed(0)
    net = make(mx)
    net.initialize(ctx=ctx)
    if hybrid:
        net.hybridize()
    arrays = [mx.nd.array(x, ctx=ctx) for x in xs]
    records = []
    for call in range(3):
        for i in diff:
            arrays[i].attach_grad()
        if call < 2:
            with mx.autograd.record():
                out = net(*arrays)
            outs = _outs(out)
            head = np.random.default_rng(call + 1).standard_normal(
                outs[0].shape).astype(np.float32)
            outs[0].backward(mx.nd.array(head, ctx=ctx))
        else:
            outs = _outs(net(*arrays))
        params = {}
        for name, p in net.collect_params().items():
            g = p.grad().asnumpy() if call < 2 and p.grad_req != "null" \
                else None
            params[name] = (p.data().asnumpy(), g)
        records.append(([o.asnumpy() for o in outs],
                        [arrays[i].grad.asnumpy() for i in diff]
                        if call < 2 else [], params))
    return net, records


def check(make, xs, diff=(0,), hybrid=False, scale=0.0):
    _, want = run(jmx, REF_CTX, make, xs, diff, hybrid)
    net, got = run(tmx, PORT_CTX, make, xs, diff, hybrid)
    for call, ((go, gg, gp), (wo, wg, wp)) in enumerate(zip(got, want)):
        tag = f"call {call} {'hybrid' if hybrid else 'eager'}"
        assert len(go) == len(wo), tag
        for k, (g, w) in enumerate(zip(go, wo)):
            close(g, w, f"{tag} output {k}", scale)
        for k, (g, w) in enumerate(zip(gg, wg)):
            close(g, w, f"{tag} input grad {k}", scale)
        assert sorted(gp) == sorted(wp), tag
        for name in wp:
            close(gp[name][0], wp[name][0], f"{tag} {name}", scale)
            assert (gp[name][1] is None) == (wp[name][1] is None), name
            if wp[name][1] is not None:
                close(gp[name][1], wp[name][1], f"{tag} grad {name}", scale)
    return net
