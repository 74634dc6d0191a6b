"""Clean mxlint fixture (port idioms): the routed forms, host reads
after the loop, and a loop that never decodes. Never imported; AST
only."""
import torch

from mxtpu_torch.gluon.block import HybridBlock
from mxtpu_torch.models import llama


class Good(HybridBlock):
    def hybrid_forward(self, F, x, w):
        if x.shape[0] > 1:          # static fact: fine
            x = F.relu(x)
        return F.FullyConnected(x, w, no_bias=True, num_hidden=4)


def generate_all(cfg, params, tok, cache, n):
    toks = []
    for _ in range(n):
        lg, cache = llama.decode_step(cfg, params, tok, cache)
        tok = lg.argmax(-1)[:, None]
        toks.append(tok)
    return torch.cat(toks, 1).tolist()


def data_loop(batches, net):
    total = 0.0
    for x in batches:
        total += net(x).mean().item()
    return total
