"""The Threefry-2x32 key chain — the port's counterpart of ``jax.random``.

``mxtpu`` draws every random number through ``jax.random`` under its
default mode (``jax_threefry_partitionable=True``, impl
``threefry2x32``). This module reproduces that chain bit for bit in
plain PyTorch, so a key made, split or folded here gives the same key,
bits and uniforms as the reference's on the same seed: sampled tokens,
dropout masks and crash replays carry over.

A key is an int64 tensor of shape ``(2,)`` that holds two uint32
words, on any device; what a function draws lands on its key's
device. A batch of keys, shape ``(S, 2)``, has ``jax.vmap``'s
semantics over its rows: :func:`split` gives ``(S, num, 2)``,
:func:`fold_in` ``(S, 2)``, and a draw of ``shape`` gives
``(S, *shape)``, row i from key i over the row's own counters, in one
broadcast pass (key words ``(S, 1, ...)`` against the counters).

The arithmetic runs on int64 lanes masked to 32 bits (add, then mask;
rotate as ``((x << r) | (x >> (32 - r))) & mask``), since
torch's ``uint32`` lacks most ops. A 64-bit draw comes back as the
int64 with the same bit pattern as jax's uint64.

Seeds follow ``PRNGKey`` in 64-bit mode: any int in [-2**63, 2**63),
the high word first. (Without ``jax_enable_x64`` jax keeps a seed's low
32 bits, which differs from this for seeds outside [0, 2**31).)
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .context import DeviceLike, resolve_device

__all__ = ["PRNGKey", "threefry_2x32", "split", "fold_in", "random_bits",
           "uniform", "gumbel", "categorical", "bernoulli",
           "key_from_numpy", "key_to_numpy"]

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
Shape = Union[int, Sequence[int]]


def _check_key(key) -> torch.Tensor:
    if not isinstance(key, torch.Tensor) or key.dtype != torch.int64 \
            or key.ndim not in (1, 2) or key.shape[-1] != 2:
        raise TypeError("a key is an int64 tensor of shape (2,) holding two "
                        "uint32 words (PRNGKey, split, fold_in, "
                        "key_from_numpy), or a batch of them (S, 2); got "
                        f"{_describe(key)}")
    if key.device.type == "meta":
        raise ValueError("a key on the meta device holds no value")
    return key


def _describe(x) -> str:
    if isinstance(x, torch.Tensor):
        return f"a {x.dtype} tensor of shape {tuple(x.shape)}"
    return repr(type(x))


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (shape,) if isinstance(shape, int) else tuple(int(d) for d in shape)


def PRNGKey(seed: int, device: DeviceLike = None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the key (seed >> 32, seed & mask)."""
    seed = int(seed)
    if not -2 ** 63 <= seed < 2 ** 63:
        raise OverflowError(f"seed {seed} does not fit in 64 bits")
    seed &= 2 ** 64 - 1                  # the two's-complement bits
    return torch.tensor([seed >> 32, seed & MASK], dtype=torch.int64,
                        device=resolve_device(device))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry_2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor):
    """The Threefry-2x32 block cipher, 20 rounds, on uint32 words held in
    int64 lanes: key words k1 and k2 (0-d tensors or ints) and counter
    words x1 and x2 (tensors of one shape) → the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x1 + ks[0]) & MASK
    x1 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def _words(key: torch.Tensor, ndim: int):
    """A key's two words, shaped to broadcast against ``ndim`` counter
    dims: 0-d for one key, (S, 1, ..., 1) for a batch (vmap's rows)."""
    key = _check_key(key)
    k1, k2 = key[..., 0], key[..., 1]
    if key.ndim == 2:
        k1, k2 = (k.reshape((-1,) + (1,) * ndim) for k in (k1, k2))
    return k1, k2


def _hash_iota(key: torch.Tensor, shape: Tuple[int, ...]):
    """Threefry of the row-major flat index over ``shape``, split into
    its high and low words (jax's ``iota_2x32_shape``); a batch of S
    keys hashes the same counters under each key, (S, *shape)."""
    k1, k2 = _words(key, len(shape))
    count = torch.arange(int(np.prod(shape, dtype=np.int64)),
                         dtype=torch.int64, device=key.device).reshape(shape)
    return threefry_2x32(k1, k2, count >> 32, count & MASK)


def split(key: torch.Tensor, num: Shape = 2) -> torch.Tensor:
    """``jax.random.split``: ``num`` keys (an int or a shape), stacked
    on a leading axis; key i is the hash of the counter i. A batch of S
    keys gives (S, *num, 2)."""
    bits1, bits2 = _hash_iota(key, _shape(num))
    return torch.stack([bits1, bits2], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of the counter (0, data), where
    data is a uint32 (a Python int in [0, 2**32), or a 0-d integer
    tensor taken modulo 2**32 as jax's ``astype`` does). A batch of S
    keys folds the same data into each, (S, 2)."""
    k1, k2 = _words(key, 0)
    if isinstance(data, torch.Tensor):
        if data.ndim or data.is_floating_point():
            raise TypeError("fold_in takes one integer, got "
                            + _describe(data))
        data = data.to(key.device, torch.int64) & MASK
    else:
        data = int(data)
        if not 0 <= data <= MASK:
            raise OverflowError(f"fold_in data {data} is not a uint32")
        data = torch.tensor(data, dtype=torch.int64, device=key.device)
    out0, out1 = threefry_2x32(k1, k2, torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(out0, out1), dim=-1)


def random_bits(key: torch.Tensor, bit_width: int = 32,
                shape: Shape = ()) -> torch.Tensor:
    """``jax.random.bits``: uniform 32-bit words (``bits1 ^ bits2``) in
    int64 lanes, or 64-bit words (``bits1 << 32 | bits2``) as int64 bit
    patterns."""
    bits1, bits2 = _hash_iota(key, _shape(shape))
    if bit_width == 32:
        return bits1 ^ bits2
    if bit_width == 64:
        return (bits1 << 32) | bits2
    raise ValueError(f"bit_width must be 32 or 64, got {bit_width}")


# dtype → (bits, mantissa bits, int type of its width, the bits of 1.0,
# Veltkamp's splitter 2^ceil(p/2) + 1 for its p-bit significand)
_FLOAT_LAYOUT = {torch.float32: (32, 23, torch.int32, 0x3F800000, 4097.0),
                 torch.float64: (64, 52, torch.int64, 0x3FF0000000000000,
                                 134217729.0)}


def _two_sum(a, b):
    """s + err == a + b exactly, s = fl(a + b) (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b, splitter):
    """p + err == a * b exactly, p = fl(a * b) (Dekker, Veltkamp's split)."""
    def split(x):
        c = x * splitter
        hi = c - (c - x)
        return hi, x - hi
    p = a * b
    (ah, al), (bh, bl) = split(a), split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _fma(a, b, c, itype, splitter):
    """a * b + c rounded once, from ops that each round once (Boldo and
    Melquiond's emulation: the exact product's tail and the sum's tail
    added with rounding to odd, then one rounding to nearest). Every op
    is its own kernel, so no compiler contracts any of them, on the CPU
    or the card."""
    uh, ul = _two_prod(a, b, splitter)
    th, tl = _two_sum(c, uh)
    v, err = _two_sum(tl, ul)
    even = (v.view(itype) & 1) == 0
    toward = torch.where(err > 0, math.inf, -math.inf).to(v.dtype)
    v = torch.where((err != 0) & even, torch.nextafter(v, toward), v)
    return th + v


def uniform(key: torch.Tensor, shape: Shape = (),
            dtype: torch.dtype = torch.float32, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in f32 (32-bit draws) or f64 (64-bit
    draws): the top mantissa bits over 1.0's exponent, bit-cast, minus
    1, then ``floats * (maxval - minval) + minval`` and
    ``max(minval, ·)``. XLA contracts that product and sum into one
    fused multiply-add, rounded once, which :func:`_fma` reproduces
    exactly; where ``maxval - minval`` is a power of two (the default
    [0, 1), gumbel's [tiny, 1)) the product is exact and the plain sum
    rounds once already. That branch copies nothing from the host, so a
    step captured as a CUDA graph can draw on it (the other copies its
    two constants from the host)."""
    if dtype not in _FLOAT_LAYOUT:
        raise TypeError(f"uniform draws float32 or float64, not {dtype}")
    nbits, nmant, itype, one, splitter = _FLOAT_LAYOUT[dtype]
    bits = random_bits(key, nbits, shape)
    # a logical shift right: the arithmetic shift's sign bits are masked
    mant = (bits >> (nbits - nmant)) & ((1 << nmant) - 1)
    floats = (mant | one).to(itype).view(dtype) - 1.0
    np_dtype = {32: np.float32, 64: np.float64}[nbits]
    lo = np_dtype(float(minval))
    span = np_dtype(float(maxval)) - lo          # rounded as jax rounds it
    if np.frexp(span)[0] == 0.5:
        out = floats * float(span) + float(lo)
    else:
        out = _fma(floats, torch.tensor(float(span), dtype=dtype,
                                        device=key.device),
                   torch.tensor(float(lo), dtype=dtype, device=key.device),
                   itype, splitter)
    return torch.clamp_min(out, float(lo))


def gumbel(key: torch.Tensor, shape: Shape = (),
           dtype: torch.dtype = torch.float32, mode: str = "low"):
    """``jax.random.gumbel`` in its "low" mode (the default, as
    ``jax_high_dynamic_range_gumbel`` is off): ``-log(-log(u))`` with u
    uniform over [tiny, 1)."""
    if mode != "low":
        raise NotImplementedError(
            "gumbel's 'high' mode is not ported; jax's default is 'low'")
    u = uniform(key, shape, dtype, torch.finfo(dtype).tiny, 1.0)
    return -torch.log(-torch.log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor,
                axis: int = -1) -> torch.Tensor:
    """``jax.random.categorical`` with replacement: the Gumbel-max
    draw ``argmax(gumbel + logits)`` (the first index on ties), int64.
    With a batch of S keys, logits (S, ...) and row i is drawn from key
    i over the row's own shape (``jax.vmap`` over keys and rows)."""
    key = _check_key(key)
    if key.device != logits.device:
        raise ValueError(f"the key is on {key.device}, the logits on "
                         f"{logits.device}")
    shape = tuple(logits.shape)
    if key.ndim == 2:
        if not shape or shape[0] != key.shape[0]:
            raise ValueError(f"{key.shape[0]} keys for logits of shape "
                             f"{shape}: a batch of keys draws one row each")
        shape = shape[1:]
    noise = gumbel(key, shape, logits.dtype)
    return torch.argmax(noise + logits, dim=axis)


def bernoulli(key: torch.Tensor, p=0.5,
              shape: Optional[Shape] = None) -> torch.Tensor:
    """``jax.random.bernoulli`` in its "low" mode: ``uniform < p``,
    drawn in p's float dtype; a Python ``p`` draws in float32, as jax
    does outside its 64-bit mode (in it, pass a float64 tensor). One
    key only: a batch of keys raises."""
    key = _check_key(key)
    if key.ndim != 1:
        raise TypeError(f"bernoulli takes one key, got {_describe(key)}")
    if not isinstance(p, torch.Tensor):
        p = torch.tensor(p, dtype=torch.float32, device=key.device)
    if not p.is_floating_point():
        raise TypeError(f"p must be floating, got {p.dtype}")
    shape = tuple(p.shape) if shape is None else _shape(shape)
    return uniform(key, shape, p.dtype) < p


def key_from_numpy(a, device: DeviceLike = None) -> torch.Tensor:
    """A uint32 numpy key (``np.asarray`` of a jax key, or what
    ``resume_key`` returns) → the port's key on ``device``."""
    a = np.asarray(a)
    if a.dtype != np.uint32 or a.shape[-1:] != (2,):
        raise TypeError(f"a key is uint32 of shape (..., 2); got {a.dtype} "
                        f"{a.shape}")
    return torch.from_numpy(a.astype(np.int64)).to(resolve_device(device))


def key_to_numpy(key: torch.Tensor) -> np.ndarray:
    """The port's key(s) → uint32 numpy, as jax holds them."""
    return key.detach().cpu().numpy().astype(np.uint32)
