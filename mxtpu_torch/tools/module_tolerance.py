"""Support for the bounds that ``chip_smoke.py``'s ``symbol_module`` phase
puts on the Module's first step against the classic Trainer's.

    python -m mxtpu_torch.tools.module_tolerance [--batch 16] [--size 64]
        [--ctx cpu|gpu] [--seed 0]

The zoo's ResNet-50 v1 (``get_model("resnet50_v1")``, Xavier weights
after ``mx.random.seed``), exported and read back by ``load_checkpoint``
under a ``SoftmaxOutput`` head, as the phase builds it, over a batch of
seeded images and labels, with TF32 off as the phase runs it. One sgd
step (lr 0.1, momentum 0.9) from the same weights, and for each case
one JSON line of the distances the phase bounds (relative L2: the whole
update, each parameter's update, each BatchNorm statistic's change; the
loss):

- ``module_vs_trainer``: the Module's step against the classic
  Trainer's;
- ``trainer_repeat``: the classic Trainer's step run again on the same
  images (nonzero where the library's kernels are not deterministic);
- ``trainer_perturbed``: the classic Trainer's step on the images
  scaled by 1 + 2^-23 (one float32 ulp) against its step on the images
  as they are: how far rounding alone carries on the same function;
- ``lr_off`` and ``normalization_dropped``, planted faults in the
  Module's step: lr 10 % high, and SoftmaxOutput's batch normalization
  left out (the gradient ``batch`` times too large).

The phase's bounds sit between the first two and the faults. Momentum
plays no part in a first step (its buffer starts at zero); the CPU test
``tests/test_torch_module.py::test_module_fit_trajectory_matches_mxtpu``
holds it over three epochs against ``mxtpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch

LR, MOMENTUM = 0.1, 0.9


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def pre_bn_biases(symbol) -> set:
    """The bias variables of convolutions whose output feeds a
    BatchNorm: their gradient is 0 in exact arithmetic, so what their
    update holds is rounding."""
    nodes = json.loads(symbol.tojson())["nodes"]
    out = set()
    for n in nodes:
        if n["op"] == "BatchNorm":
            src = nodes[n["inputs"][0][0]]
            if src["op"] == "Convolution" and len(src["inputs"]) == 3:
                out.add(nodes[src["inputs"][2][0]]["name"])
    return out


def classic_step(mx, net, x, y, lr=LR, momentum=MOMENTUM):
    """The classic Gluon Trainer's first sgd step on ``net`` over (x, y):
    (the mean loss, {name: the change of each parameter and BatchNorm
    statistic}). The net's values are put back after."""
    params = net.collect_params()
    before = {k: p.data()._data.clone() for k, p in params.items()}
    trainer = mx.gluon.Trainer(params, "sgd", {
        "learning_rate": lr, "momentum": momentum})
    with mx.autograd.record():
        loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()(net(x), y)
    loss.backward()
    trainer.step(x.shape[0])
    delta = {k: p.data()._data - before[k] for k, p in params.items()}
    for k, p in params.items():
        p.set_data(mx.nd.NDArray(before[k]))
    return float(loss.mean().asscalar()), delta


def module_step(mx, head, args, auxs, x, y, ctx, lr=LR, momentum=MOMENTUM):
    """The Module's first sgd step over (x, y) from ``args``/``auxs``:
    (the mean loss, {name: the change of each argument and aux
    state})."""
    start = {k: v._data.clone() for k, v in {**args, **auxs}.items()}
    mod = mx.mod.Module(head, context=ctx)
    mod.bind(data_shapes=[("data", x.shape)],
             label_shapes=[("softmax_label", y.shape)])
    mod.init_params(arg_params=args, aux_params=auxs)
    mod.init_optimizer(optimizer="sgd", optimizer_params=(
        ("learning_rate", lr), ("momentum", momentum)))
    mod.forward(mx.io.DataBatch(data=[x], label=[y]), is_train=True)
    mod.backward()
    mod.update()
    prob = mod.get_outputs()[0]._data
    loss = float(-prob.gather(1, y._data.long()[:, None]).log().mean())
    arg_now, aux_now = mod.get_params()
    return loss, {k: v._data - start[k]
                  for k, v in {**arg_now, **aux_now}.items()}


def compare(delta, want, symbol) -> dict:
    """The distances of the step ``delta`` from the step ``want``, as
    the phase bounds them: the whole update (every parameter, BatchNorm
    statistics apart), each parameter's update and each statistic's
    change, leaving out ``pre_bn_biases``."""
    noise = pre_bn_biases(symbol)
    param_rel, bn_rel, mine, theirs = [], [], [], []
    for k, v in want.items():
        if k in noise:
            continue
        d = delta[k]
        if "running" in k:
            bn_rel.append(rel_l2(d, v))
            continue
        param_rel.append(rel_l2(d, v))
        mine.append(d.reshape(-1))
        theirs.append(v.reshape(-1))
    return {"update_rel": rel_l2(torch.cat(mine), torch.cat(theirs)),
            "param_rel_max": max(param_rel),
            "param_rel_median": float(np.median(param_rel)),
            "bn_change_rel_max": max(bn_rel),
            "parameters": len(param_rel), "bn_statistics": len(bn_rel),
            "left_out_pre_bn_biases": len(noise)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--ctx", choices=("cpu", "gpu"), default="cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import mxtpu_torch as mx
    # full f32 products, as chip_smoke.py runs the phase
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = mx.cpu() if args.ctx == "cpu" else mx.gpu()
    rng = np.random.default_rng(args.seed)
    n = args.batch
    data = rng.standard_normal((n, 3, args.size, args.size)) \
        .astype(np.float32)
    labels = rng.integers(0, 1000, n).astype(np.float32)
    x, y = mx.nd.array(data, ctx=ctx), mx.nd.array(labels, ctx=ctx)
    moved = mx.nd.array(data * np.float32(1 + 2.0 ** -23), ctx=ctx)
    mx.random.seed(args.seed)
    net = mx.gluon.model_zoo.vision.get_model("resnet50_v1")
    net.initialize(mx.initializer.Xavier(magnitude=2), ctx=ctx)
    net(x)                                  # resolves the shapes
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "resnet50_v1")
        net.export(prefix, epoch=0)
        sym, arg_params, aux_params = mx.model.load_checkpoint(
            prefix, 0, ctx=ctx)
    gluon_loss, want = classic_step(mx, net, x, y)
    _, again = classic_step(mx, net, x, y)
    _, moved_delta = classic_step(mx, net, moved, y)
    heads = {"batch": mx.sym.SoftmaxOutput(sym, name="softmax",
                                           normalization="batch"),
             "null": mx.sym.SoftmaxOutput(sym, name="softmax",
                                          normalization="null")}
    cases = [("module_vs_trainer", "batch", LR),
             ("lr_off", "batch", LR * 1.1),
             ("normalization_dropped", "null", LR)]
    head = {"batch": args.batch, "size": args.size, "ctx": args.ctx}
    for case, delta in (("trainer_repeat", again),
                        ("trainer_perturbed", moved_delta)):
        print(json.dumps({"case": case, **head,
                          **compare(delta, want, sym)}), flush=True)
    for case, norm, lr in cases:
        loss, delta = module_step(mx, heads[norm], arg_params, aux_params,
                                  x, y, ctx, lr=lr)
        print(json.dumps({"case": case, **head,
                          "loss_rel": abs(loss - gluon_loss) / gluon_loss,
                          **compare(delta, want, sym)}), flush=True)


if __name__ == "__main__":
    main()
