"""Seeded mxlint fixture (port idioms): MXL004 — torch's host syncs
inside a decode/generate loop body. ``mx.cpu()`` makes a context and
syncs nothing. Never imported; AST only."""
import torch

import mxtpu_torch as mx
from mxtpu_torch.models import llama


def serve_tokens(cfg, params, tok, cache, n):
    outs = []
    for _ in range(n):
        lg, cache = step(params, tok, cache)
        outs.append(lg.argmax(-1).tolist())  # seeded: MXL004
        outs.append(lg.max().item())  # seeded: MXL004
        outs.append(lg.cpu())  # seeded: MXL004
        torch.cuda.synchronize()  # seeded: MXL004
        ctx = mx.cpu()  # a context, not a sync: no finding
    return outs, ctx


def token_loop(cfg, params, tok, cache, n):
    toks = []
    while len(toks) < n:
        lg, cache = llama.decode_step(cfg, params, tok, cache)
        tok = lg.argmax(-1)[:, None]
        toks.append(mx.nd.NDArray(tok).asnumpy())  # seeded: MXL004
    return toks, lg.cpu()  # after the loop: no finding


def step(params, tok, cache):
    return tok, cache
