"""ResNet v1 — the port of ``mxtpu/models/resnet.py``.

Plain functions over a parameter tree with ``mxtpu``'s keys and
layouts (NHWC images, HWIO conv kernels), plus the thin :class:`ResNet`
``nn.Module`` over them. ``forward`` in train mode returns
``(logits, new_state)`` with the running BatchNorm statistics updated,
so :func:`loss_fn` composes with
``mxtpu_torch.parallel.step.make_train_step(..., has_state=True)``.

The reference computes its convolutions with ``lax.conv_general_dilated``,
outside any Pallas kernel, so here they go to ``F.conv2d`` (cuDNN on the
card) on a channels-last view: ``x.permute(0, 3, 1, 2)`` of a contiguous
NHWC tensor is channels-last already and costs no copy. Numerics follow
``mxtpu``:

- SAME padding is XLA's, which is asymmetric for a stride-2 window on an
  even size (lo=0, hi=1 for the 3×3/2 conv and the 3×3/2 max-pool, lo=2,
  hi=3 for the 7×7/2 stem); :func:`_same_pad` computes it and the pad is
  written out (zeros for a conv, −inf for the pool) wherever it is not
  symmetric.
- BatchNorm normalises with the biased batch variance and updates the
  running statistics as ``m·old + (1−m)·batch`` with that variance, in
  f32 (``F.batch_norm`` would take the unbiased variance for the running
  update and read the momentum the other way round).
- Weights are cast to the compute dtype before each conv; the residual
  add, ReLU and the global average pool run in the compute dtype; the
  fc layer runs in f32.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..context import DeviceLike, resolve_device
from ._numpy_tree import params_from_numpy, params_to_numpy

__all__ = ["ResNetConfig", "CONFIGS", "init_params",
           "init_state", "params_from_numpy", "params_to_numpy",
           "space_to_depth", "s2d_stem_kernel", "forward", "loss_fn",
           "ResNet"]

# layers-per-stage, bottleneck?
_SPECS = {
    18: ([2, 2, 2, 2], False),
    34: ([3, 4, 6, 3], False),
    50: ([3, 4, 6, 3], True),
    101: ([3, 4, 23, 3], True),
    152: ([3, 8, 36, 3], True),
}


@dataclass(frozen=True)
class ResNetConfig:
    depth: int = 50
    num_classes: int = 1000
    width: int = 64
    dtype: Any = torch.bfloat16        # activation/compute dtype
    param_dtype: Any = torch.float32
    bn_momentum: float = 0.9
    bn_eps: float = 1e-5
    stem: str = "std"          # "std" (7×7/s2) | "s2d" (space-to-depth)

    @property
    def stages(self) -> List[int]:
        return _SPECS[self.depth][0]

    @property
    def bottleneck(self) -> bool:
        return _SPECS[self.depth][1]


CONFIGS: Dict[str, ResNetConfig] = {
    "resnet18": ResNetConfig(depth=18),
    "resnet50": ResNetConfig(depth=50),
    "resnet50_s2d": ResNetConfig(depth=50, stem="s2d"),
    "resnet101": ResNetConfig(depth=101),
    "tiny": ResNetConfig(depth=18, width=8, num_classes=10),
}


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _block_channels(cfg: ResNetConfig, stage: int) -> Tuple[int, int]:
    mid = cfg.width * (2 ** stage)
    out = mid * 4 if cfg.bottleneck else mid
    return mid, out


def _blocks(cfg: ResNetConfig):
    """(name, stride, cin, mid, cout) of every residual block."""
    cin = cfg.width
    for s, n_blocks in enumerate(cfg.stages):
        mid, cout = _block_channels(cfg, s)
        for b in range(n_blocks):
            yield (f"stage{s}_block{b}", 2 if (s > 0 and b == 0) else 1,
                   cin, mid, cout)
            cin = cout


def init_params(cfg: ResNetConfig,
                generator: Optional[torch.Generator] = None,
                device: DeviceLike = None):
    """He-initialised parameters in ``mxtpu``'s tree layout, drawn from
    ``generator`` (which must live on ``device``; by default one seeded
    with 0 is made there). The draws differ from ``jax.random``'s: to
    hold the two packages on the same weights, carry a tree with
    :func:`params_from_numpy`."""
    device = resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator(device=device).manual_seed(0)
    d = cfg.param_dtype

    def conv(kh, kw, cin, cout):
        std = math.sqrt(2.0 / (kh * kw * cin))   # He init (MSRAPrelu)
        return torch.randn((kh, kw, cin, cout), generator=gen,
                           device=device, dtype=d).mul_(std)

    def bn(c):
        return {"scale": torch.ones((c,), dtype=d, device=device),
                "bias": torch.zeros((c,), dtype=d, device=device)}

    p: Dict[str, Any] = {"stem_conv": conv(7, 7, 3, cfg.width),
                         "stem_bn": bn(cfg.width)}
    for name, stride, cin, mid, cout in _blocks(cfg):
        if cfg.bottleneck:
            blk = {"conv1": conv(1, 1, cin, mid), "bn1": bn(mid),
                   "conv2": conv(3, 3, mid, mid), "bn2": bn(mid),
                   "conv3": conv(1, 1, mid, cout), "bn3": bn(cout)}
        else:
            blk = {"conv1": conv(3, 3, cin, mid), "bn1": bn(mid),
                   "conv2": conv(3, 3, mid, cout), "bn2": bn(cout)}
        if stride != 1 or cin != cout:
            blk["down_conv"] = conv(1, 1, cin, cout)
            blk["down_bn"] = bn(cout)
        p[name] = blk
        cin = cout
    p["fc_w"] = torch.randn((cin, cfg.num_classes), generator=gen,
                            device=device, dtype=d).div_(math.sqrt(cin))
    p["fc_b"] = torch.zeros((cfg.num_classes,), dtype=d, device=device)
    return p


def init_state(cfg: ResNetConfig, device: DeviceLike = None):
    """Running BN statistics (the reference's aux params), f32."""
    device = resolve_device(device)

    def bn(c):
        return {"mean": torch.zeros((c,), dtype=torch.float32, device=device),
                "var": torch.ones((c,), dtype=torch.float32, device=device)}

    st: Dict[str, Any] = {"stem_bn": bn(cfg.width)}
    for name, stride, cin, mid, cout in _blocks(cfg):
        blk = ({"bn1": bn(mid), "bn2": bn(mid), "bn3": bn(cout)}
               if cfg.bottleneck else {"bn1": bn(mid), "bn2": bn(cout)})
        if stride != 1 or cin != cout:
            blk["down_bn"] = bn(cout)
        st[name] = blk
    return st


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _same_pad(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding (lo, hi) of one spatial axis: the output has
    ceil(size / stride) positions and the extra row, if any, goes high."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_nhwc(x, pads, value=0.0):
    """``pads`` = ((lo_h, hi_h), (lo_w, hi_w)) on an NHWC tensor."""
    (lh, hh), (lw, hw) = pads
    return F.pad(x, (0, 0, lw, hw, lh, hh), value=value)


def _conv_nhwc(x, w, stride, pads):
    """NHWC x, HWIO w (already in x's dtype) → NHWC, explicit padding.
    A symmetric pad goes to the conv itself, which gives the same
    numbers as padding first and saves the copy."""
    (lh, hh), (lw, hw) = pads
    if lh == hh and lw == hw:
        padding = (lh, lw)
    else:
        x = _pad_nhwc(x, pads)
        padding = (0, 0)
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def _conv(x, w, stride=1):
    """``lax.conv_general_dilated(x, w.astype(x.dtype), SAME)`` in NHWC."""
    kh, kw = w.shape[:2]
    pads = (_same_pad(x.shape[1], kh, stride), _same_pad(x.shape[2], kw, stride))
    return _conv_nhwc(x, w.to(x.dtype), stride, pads)


def space_to_depth(x, block: int = 2):
    """(N, H, W, C) → (N, H/b, W/b, b·b·C); flat channel order is
    (block_row, block_col, c) — ``s2d_stem_kernel`` depends on it."""
    n, h, w, c = x.shape
    b = block
    y = x.reshape(n, h // b, b, w // b, b, c)
    y = y.permute(0, 1, 3, 2, 4, 5)
    return y.reshape(n, h // b, w // b, b * b * c)


def s2d_stem_kernel(k7):
    """The exact rewrite of the (7,7,Cin,Cout) SAME/stride-2 stem kernel
    as the (4,4,4·Cin,Cout) kernel that reads the 2×2 space-to-depth
    input with padding (1,2)/(1,2) at stride 1: zero-pad the kernel 7→8
    at the end, regroup each spatial axis as (4 blocks × 2
    sub-positions) and fold the sub-positions into the channel axis in
    :func:`space_to_depth`'s order (see the reference for the
    derivation). Linear, so gradients reach the 7×7 kernel unchanged."""
    kh, kw, cin, cout = k7.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"s2d stem rewrite is for 7x7 kernels, got "
                         f"{(kh, kw)}")
    k8 = F.pad(k7, (0, 0, 0, 0, 0, 1, 0, 1))
    k = k8.reshape(4, 2, 4, 2, cin, cout)        # (i, bh, j, bw, ci, co)
    k = k.permute(0, 2, 1, 3, 4, 5)              # (i, j, bh, bw, ci, co)
    return k.reshape(4, 4, 4 * cin, cout)


def _stem(cfg: ResNetConfig, x, k7):
    if cfg.stem == "s2d":
        n, h, w, _ = x.shape
        if h % 2 or w % 2:
            raise ValueError(
                f"stem='s2d' needs even spatial dims, got {(h, w)}")
        return _conv_nhwc(space_to_depth(x), s2d_stem_kernel(k7.to(x.dtype)),
                          1, ((1, 2), (1, 2)))
    return _conv(x, k7, stride=2)


def _max_pool(x):
    """3×3/2 SAME max-pool (−inf padding) on NHWC."""
    pads = (_same_pad(x.shape[1], 3, 2), _same_pad(x.shape[2], 3, 2))
    x = _pad_nhwc(x, pads, value=-math.inf)
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2).permute(0, 2, 3, 1)


def _apply_bn(cfg: ResNetConfig, x, p, s, train: bool, updates, path):
    """BatchNorm in f32 over (N, H, W). In train mode it normalises with
    the batch mean and biased variance, and records
    ``m·running + (1−m)·batch`` for both under ``path`` in ``updates``;
    in eval mode it normalises with the running statistics ``s``.
    ``(x − mean)·rsqrt(var + eps)·scale + bias`` is computed as
    ``x·a + (bias − mean·a)`` with ``a = rsqrt(var + eps)·scale``, which
    autograd differentiates keeping one f32 copy of x, not three."""
    x32 = x.float()
    if train:
        var, mean = torch.var_mean(x32, dim=(0, 1, 2), unbiased=False)
        m = cfg.bn_momentum
        with torch.no_grad():
            updates[path] = {"mean": m * s["mean"] + (1 - m) * mean,
                             "var": m * s["var"] + (1 - m) * var}
    else:
        mean, var = s["mean"], s["var"]
    a = torch.rsqrt(var + cfg.bn_eps) * p["scale"].float()
    return (x32 * a + (p["bias"].float() - mean * a)).to(x.dtype)


def forward(cfg: ResNetConfig, params, x, state=None, train: bool = False):
    """x: (N, H, W, 3) → logits (N, classes) f32. In train mode returns
    ``(logits, new_state)``: a fresh nested tree with the running BN
    statistics updated; the ``state`` passed in is left as it was."""
    if state is None:
        state = init_state(cfg, x.device)
    updates: Dict[Tuple[str, ...], Any] = {}
    x = x.to(cfg.dtype)

    def bn(h, p, *path):
        s = state
        for k in path:
            s = s[k]
        return _apply_bn(cfg, h, p, s, train, updates, path)

    x = _stem(cfg, x, params["stem_conv"])
    x = _max_pool(F.relu(bn(x, params["stem_bn"], "stem_bn")))

    for name, stride, _, _, _ in _blocks(cfg):
        blk = params[name]
        shortcut = x
        if "down_conv" in blk:
            shortcut = bn(_conv(x, blk["down_conv"], stride=stride),
                          blk["down_bn"], name, "down_bn")
        if cfg.bottleneck:
            h = F.relu(bn(_conv(x, blk["conv1"]), blk["bn1"], name, "bn1"))
            h = F.relu(bn(_conv(h, blk["conv2"], stride=stride), blk["bn2"],
                          name, "bn2"))
            h = bn(_conv(h, blk["conv3"]), blk["bn3"], name, "bn3")
        else:
            h = F.relu(bn(_conv(x, blk["conv1"], stride=stride), blk["bn1"],
                          name, "bn1"))
            h = bn(_conv(h, blk["conv2"]), blk["bn2"], name, "bn2")
        x = F.relu(h + shortcut)

    x = x.mean(dim=(1, 2))            # global average pool
    logits = x.float() @ params["fc_w"].float() + params["fc_b"].float()
    if not train:
        return logits
    # fold the flat updates into a fresh nested state tree
    new_state = _rebuild(state)
    for path, upd in updates.items():
        node = new_state
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = upd
    return logits, new_state


def _rebuild(tree):
    """New dict nodes over the same leaves."""
    return {k: _rebuild(v) if isinstance(v, dict) else v
            for k, v in tree.items()}


def loss_fn(cfg: ResNetConfig):
    """Softmax cross-entropy over ``{'image', 'label'}`` batches:
    ``loss(params, bn_state, batch) -> (loss, new_bn_state)``, for
    ``make_train_step(..., has_state=True)`` with the state made by
    ``init_state(params, tx, model_state=resnet.init_state(cfg))``."""

    def loss(params, state, batch):
        logits, new_state = forward(cfg, params, batch["image"], state,
                                    train=True)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, batch["label"].long()[:, None])
        return nll.mean(), new_state
    return loss


# ---------------------------------------------------------------------------
# module façade
# ---------------------------------------------------------------------------
class _Tree(nn.Module):
    """A nested dict as a module: dicts become submodules, leaves
    parameters (or buffers). ``tree()`` gives the dict back, no copy."""

    def __init__(self, tree, buffers: bool = False):
        super().__init__()
        self._order = list(tree)
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _Tree(v, buffers))
            elif buffers:
                self.register_buffer(k, v)
            else:
                self.register_parameter(k, nn.Parameter(v))

    def tree(self):
        def get(k):
            if k in self._modules:
                return self._modules[k].tree()
            return self._parameters[k] if k in self._parameters \
                else self._buffers[k]
        return {k: get(k) for k in self._order}


class ResNet(nn.Module):
    """One ResNet under ``mxtpu``'s parameter names (``params``) with its
    running BN statistics as buffers (``bn_state``). In training mode
    (``.train()``) :meth:`forward` normalises with batch statistics and
    copies the updated running statistics into the buffers, as
    ``nn.BatchNorm2d`` does; in eval mode it uses them."""

    def __init__(self, cfg: ResNetConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.params = _Tree(init_params(cfg, generator, device))
        self.bn_state = _Tree(init_state(cfg, device), buffers=True)

    def forward(self, x):
        if not self.training:
            return forward(self.cfg, self.params.tree(), x,
                           self.bn_state.tree())
        logits, new = forward(self.cfg, self.params.tree(), x,
                              self.bn_state.tree(), train=True)
        with torch.no_grad():
            _copy_into(self.bn_state.tree(), new)
        return logits

    def loss(self, batch):
        """The training loss of :func:`loss_fn` on ``batch``; the
        running statistics are updated as in :meth:`forward`."""
        logp = torch.log_softmax(self(batch["image"]), dim=-1)
        return -logp.gather(-1, batch["label"].long()[:, None]).mean()


def _copy_into(dst, src):
    """Copy ``src``'s leaves into the same-shaped tree ``dst``."""
    for k, v in dst.items():
        if isinstance(v, dict):
            _copy_into(v, src[k])
        else:
            v.copy_(src[k])
