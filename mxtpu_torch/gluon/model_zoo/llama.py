"""Llama as a Gluon HybridBlock — the port of
``mxtpu/gluon/model_zoo/llama.py`` (BASELINE config 5: "Llama-3-8B as
a Gluon HybridBlock").

The block owns the parameters (Gluon semantics: initialize /
save_parameters / load_parameters / hybridize all work), while the math
is the functional core in :mod:`mxtpu_torch.models.llama` (stacked
per-layer weights, the flash-attention kernels on the card, the chunked
cross-entropy), called through the tape's funnel, so one source of truth
gives the Gluon surface the functional model's numbers. Parameter
NAMES are the functional tree's paths ("layers/wq", "tok_embed", ...).

The parameters' shapes come from ``init_params`` on the ``meta``
device, which allocates nothing (the reference asks ``jax.eval_shape``).
"""
from __future__ import annotations

from dataclasses import replace
from typing import Optional

import torch

from ...models import llama as _fl
from ...models._numpy_tree import params_from_numpy
from ...ndarray.ndarray import NDArray, apply_op
from ..block import HybridBlock
from ..parameter import Parameter

__all__ = ["GluonLlama"]


# attribute-safe alias ↔ functional tree path (entries absent from a
# config's tree — lm_head under tied embeddings, moe_gate for dense
# FFNs — are filtered at construction)
_PARAM_PATHS = {
    "tok_embed": ("tok_embed",),
    "layers_attn_norm": ("layers", "attn_norm"),
    "layers_wq": ("layers", "wq"),
    "layers_wk": ("layers", "wk"),
    "layers_wv": ("layers", "wv"),
    "layers_wo": ("layers", "wo"),
    "layers_ffn_norm": ("layers", "ffn_norm"),
    "layers_moe_gate": ("layers", "moe_gate"),
    "layers_w_gate": ("layers", "w_gate"),
    "layers_w_up": ("layers", "w_up"),
    "layers_w_down": ("layers", "w_down"),
    "final_norm": ("final_norm",),
    "lm_head": ("lm_head",),
}


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


class GluonLlama(HybridBlock):
    """Llama causal LM as a HybridBlock.

    - ``net(tokens)`` → logits (b, s, vocab) f32.
    - ``net(tokens, tokens)`` → scalar training loss (causal shift +
      chunked CE inside — :func:`mxtpu_torch.models.llama.loss_fn`).
    """

    def __init__(self, cfg: Optional[_fl.LlamaConfig] = None,
                 prefix: Optional[str] = None, params=None, **overrides):
        # parameter NAMES are the functional tree paths regardless of
        # prefix; prefix scopes the block
        super().__init__(prefix=prefix if prefix is not None else "",
                         params=params)
        cfg = cfg or _fl.LlamaConfig()
        if overrides:
            cfg = replace(cfg, **overrides)
        self._cfg = cfg
        shapes = _fl.init_params(cfg, torch.Generator(), device="meta")
        self._paths = {}
        for attr, path in _PARAM_PATHS.items():
            try:
                leaf = _leaf(shapes, path)
            except KeyError:
                continue
            p = Parameter("/".join(path), shape=tuple(leaf.shape),
                          dtype=leaf.dtype)
            self._paths[attr] = path
            self._reg_params[attr] = p
            object.__setattr__(self, attr, p)

    @property
    def cfg(self) -> _fl.LlamaConfig:
        return self._cfg

    # -- tree bridge -----------------------------------------------------------
    def _pytree(self, leaves) -> dict:
        tree: dict = {}
        for attr, path in self._paths.items():
            v = leaves[attr]
            v = v._data if isinstance(v, NDArray) else v
            if len(path) == 1:
                tree[path[0]] = v
            else:
                tree.setdefault(path[0], {})[path[1]] = v
        return tree

    def load_pytree(self, params, ctx=None) -> None:
        """Install a functional parameter tree: tensors as they are (no
        copy when they already live on ``ctx``), or the reference's tree
        as numpy arrays (through ``params_from_numpy``), onto ``ctx``
        (None: the tensors' own device, else the card)."""
        for attr, path in self._paths.items():
            leaf = _leaf(params, path)
            if not isinstance(leaf, torch.Tensor):
                leaf = params_from_numpy(leaf, ctx)
            dev = leaf.device if ctx is None else torch.device(ctx)
            self._reg_params[attr]._load_init(NDArray(leaf), dev)

    def as_pytree(self) -> dict:
        """The live weights as a functional parameter tree (the
        parameters' own tensors, no copy). An update rebinds them, so
        call this again after a step rather than holding the tree."""
        return self._pytree({a: p.data() for a, p in self._reg_params.items()})

    # -- forward -------------------------------------------------------------
    def hybrid_forward(self, F, tokens, labels=None, **ps):
        """``net(tokens)`` → logits; ``net(tokens, tokens)`` → scalar
        causal-LM loss. ``labels`` exists for the Gluon (data, label)
        calling convention but must be the same token sequence — the
        causal next-token shift happens inside."""
        attrs = list(self._paths)
        arrays = [ps[a] for a in attrs]
        cfg = self._cfg
        # the shard() mesh rides into the functional core (its
        # constrains, and ring/ulysses attention's sp axis)
        mesh = getattr(self, "_mesh", None)
        if labels is None:
            def logits(tok, *leaves):
                return _fl.forward(cfg, self._pytree(dict(zip(attrs, leaves))),
                                   tok, mesh)
            # the bridge into the functional model: the tape's funnel,
            # never a Symbol trace
            return apply_op(logits, [tokens] + arrays,  # mxlint: disable=MXL001
                            "GluonLlama")
        if tuple(labels.shape) != tuple(tokens.shape):
            raise ValueError(
                "GluonLlama loss mode: labels must BE the input token "
                f"sequence (got {labels.shape} vs {tokens.shape}); the "
                "causal shift is internal")
        loss_fn = _fl.loss_fn(cfg, mesh)

        def loss(tok, *leaves):
            return loss_fn(self._pytree(dict(zip(attrs, leaves))),
                           {"tokens": tok})
        return apply_op(loss, [tokens] + arrays,  # mxlint: disable=MXL001
                        "GluonLlama.loss")

    def generate(self, prompt, max_new_tokens: int, **kw):
        """KV-cache autoregressive generation (functional
        ``llama.generate`` over the live weights)."""
        tok = prompt._data if isinstance(prompt, NDArray) else prompt
        return NDArray(_fl.generate(self._cfg, self.as_pytree(), tok,
                                    max_new_tokens, **kw))

    def serve(self, **kw):
        """A continuous-batching :class:`mxtpu_torch.serve.ServeEngine`
        over the live weights. The engine holds the parameters' tensors:
        a ``Trainer.step`` rebinds them, so build a fresh engine after
        training steps rather than serving across them."""
        from ...serve import ServeEngine
        return ServeEngine(self._cfg, self.as_pytree(), **kw)
