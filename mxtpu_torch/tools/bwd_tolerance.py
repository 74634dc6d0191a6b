"""Support for the tolerance that ``chip_smoke.py`` holds the flash
backward kernels to, measured on the CPU.

    python -m mxtpu_torch.tools.bwd_tolerance [--seq 1024] [--heads 8]
    python -m mxtpu_torch.tools.bwd_tolerance --train

The backward kernels of ``ops/csrc/flash_attn_bwd.cu`` take bf16 q, k,
v, o and dO and round two things that the plain version
(:func:`~mxtpu_torch.ops.attention.flash_attention_bwd_plain`, all f32)
does not: P and dS are packed to bf16 as mma.sync operands, and dq, dk
and dv are written in bf16. This script repeats that arithmetic in
PyTorch on the CPU (an emulation, not the kernel) and prints, for each
grad, the largest ``|emulated - plain| / (1 + |plain|)``: the smallest
``atol = rtol`` under which ``torch.allclose`` accepts it. It then plants
the faults a kernel could have (the causal mask dropped, the wrong kv
head of a GQA group, the ``- D`` term dropped, the scale applied twice,
the first query tile skipped) and prints the same number for each, so
the chosen tolerance is shown to sit between the two.

With ``--train`` it does the same for the bound ``chip_smoke.py`` puts
on the relative distance between the training loss and grads (of
``layers.wq``, ``layers.wk``, ``tok_embed``) with flash attention and
with dense attention: a narrow llama3_8b (dim 256, 4 layers, bf16
compute, sequence 256) on the CPU, its flash attention's backward
replaced by the emulation above, with and without each planted fault.
"""
from __future__ import annotations

import argparse
import json
import math
from dataclasses import replace

import torch

from ..models import llama
from ..ops.attention import (_causal_allowed, _repeat_kv,
                             blockwise_attention, flash_attention_bwd_plain)

FAULTS = (None, "no_mask", "gqa_head", "no_delta", "scale_twice",
          "skip_tile")


def _rb(t):
    """Round to bf16 and back: what packing an mma.sync operand does."""
    return t.to(torch.bfloat16).float()


def emulated_bwd(q, k, v, o, lse, do, *, causal, scale, fault=None):
    """dq, dk, dv with the kernels' roundings; ``fault`` plants one bug."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    qf, of, dof = q.float(), o.float(), do.float()
    kf, vf = k.float(), v.float()
    if fault == "gqa_head":           # each group reads its neighbour's kv
        kf, vf = kf.roll(1, dims=1), vf.roll(1, dims=1)
    kr, vr = _repeat_kv(qf, kf, vf)
    s = torch.matmul(qf, kr.transpose(-1, -2)) * scale
    if fault == "scale_twice":
        s = s * scale
    if causal and fault != "no_mask":
        s = torch.where(_causal_allowed(sq, skv, 0, 0, q.device), s,
                        -math.inf)
    p = torch.exp(s - lse.float()[..., None])
    if fault == "skip_tile":          # the first 64-row query tile is lost
        p[:, :, :64] = 0.0
    delta = (dof * of).sum(-1, keepdim=True)
    dp = torch.matmul(dof, vr.transpose(-1, -2))
    ds = p * (dp if fault == "no_delta" else dp - delta)
    dv = torch.matmul(_rb(p).transpose(-1, -2), dof)
    dk = torch.matmul(_rb(ds).transpose(-1, -2), qf) * scale
    dq = torch.matmul(_rb(ds), kr) * scale
    rep = hq // hkv
    dk = dk.view(b, hkv, rep, skv, d).sum(2)
    dv = dv.view(b, hkv, rep, skv, d).sum(2)
    return _rb(dq), _rb(dk), _rb(dv)


class _EmulatedFlash(torch.autograd.Function):
    """Flash attention with the kernels' roundings: the plain forward
    (output rounded to the input dtype, f32 lse) and the emulated
    backward, with an optional planted fault."""

    @staticmethod
    def forward(ctx, q, k, v, fault):
        o, lse = blockwise_attention(q.float(), k.float(), v.float(),
                                     causal=True, return_lse=True)
        o = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.fault = fault
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        grads = emulated_bwd(q, k, v, o, lse, do, causal=True,
                             scale=1.0 / math.sqrt(q.shape[-1]),
                             fault=ctx.fault)
        return (*(g.to(t.dtype) for g, t in zip(grads, (q, k, v))), None)


def train_sweep(seed: int = 0, seq: int = 256):
    """Relative distance of flash-with-emulated-kernels from dense, in
    the loss and three grads, for each planted fault."""
    cfg = replace(llama.CONFIGS["llama3_8b"], dim=256, n_heads=4,
                  n_kv_heads=2, hidden_dim=896, vocab_size=20000,
                  n_layers=4)
    gen = torch.Generator().manual_seed(seed)
    params = llama.init_params(cfg, gen, device="cpu")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, seq),
                                     generator=gen)}

    def loss_and_grads(c):
        live = {k: ({a: b.detach().requires_grad_() for a, b in v.items()}
                    if k == "layers" else v.detach().requires_grad_())
                for k, v in params.items()}
        loss = llama.loss_fn(c)(live, batch)
        picked = (live["layers"]["wq"], live["layers"]["wk"],
                  live["tok_embed"])
        return loss.detach(), torch.autograd.grad(loss, picked)

    ld, gd = loss_and_grads(replace(cfg, attn_impl="dense"))
    kernel_flash = llama.flash_attention
    try:
        for fault in FAULTS:
            llama.flash_attention = (
                lambda q, k, v, causal, fault=fault:
                _EmulatedFlash.apply(q, k, v, fault))
            lf, gf = loss_and_grads(cfg)
            rel = {"loss": abs(lf.item() - ld.item()) / abs(ld.item())}
            rel.update({n: ((a - b).norm() / b.norm()).item() for n, a, b
                        in zip(("layers.wq", "layers.wk", "tok_embed"),
                               gf, gd)})
            print(json.dumps({"fault": fault, "dim": cfg.dim,
                              "n_layers": cfg.n_layers, "seq": seq,
                              "rel": rel}), flush=True)
    finally:
        llama.flash_attention = kernel_flash


def allclose_tol(got, want):
    """The least atol = rtol with which allclose(got, want) holds."""
    return ((got - want).abs() / (1.0 + want.abs())).max().item()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--kv-heads", type=int, default=2)
    ap.add_argument("--head-dim", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train", action="store_true",
                    help="the flash-vs-dense training sweep instead")
    args = ap.parse_args(argv)
    if args.train:
        return train_sweep(args.seed)
    gen = torch.Generator().manual_seed(args.seed)
    s, d = args.seq, args.head_dim

    def rand(h):
        return torch.randn((1, h, s, d), generator=gen).to(torch.bfloat16)

    q, k, v = rand(args.heads), rand(args.kv_heads), rand(args.kv_heads)
    do = rand(args.heads)
    scale = 1.0 / math.sqrt(d)
    o, lse = blockwise_attention(q.float(), k.float(), v.float(),
                                 causal=True, return_lse=True)
    o = o.to(torch.bfloat16)
    want = flash_attention_bwd_plain(q.float(), k.float(), v.float(), o,
                                     lse, do, causal=True)
    for fault in FAULTS:
        got = emulated_bwd(q, k, v, o, lse, do, causal=True, scale=scale,
                           fault=fault)
        print(json.dumps({
            "fault": fault, "seq": s, "heads": args.heads,
            "kv_heads": args.kv_heads, "head_dim": d,
            **{name: allclose_tol(g, w) for name, g, w in
               zip(("dq", "dk", "dv"), got, want)}}), flush=True)


if __name__ == "__main__":
    main()
