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

The distributions (``normal``, ``exponential``, ``randint``,
``permutation``, ``categorical``, ``bernoulli``, ``gamma``,
``poisson``) follow jax 0.9's algorithms step for step, on the same
keys and counters; where jax's float32 math goes through XLA's own
``log``, ``log1p``, ``erf_inv`` or ``lgamma``, :mod:`xla_math` rounds
as XLA's CPU code does, so float32 normals, exponentials and Poisson
counts are the reference's bits. ``gumbel`` keeps torch's ``log``
(within an ulp of XLA's): it sits in the serving step, where the
written-out ``log`` would cost a hundred passes.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import xla_math
from .context import DeviceLike, resolve_device

__all__ = ["PRNGKey", "threefry_2x32", "split", "fold_in", "random_bits",
           "uniform", "normal", "exponential", "randint", "permutation",
           "gumbel", "categorical", "bernoulli", "gamma", "poisson",
           "choice",
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
    """``jax.random.bits`` (``jax_threefry_partitionable``): uniform
    32-bit words (``bits1 ^ bits2``) in int64 lanes, 8- and 16-bit words
    (the low bits of that word, as jax's conversion to uint8/uint16
    keeps them), or 64-bit words (``bits1 << 32 | bits2``) as int64 bit
    patterns."""
    if bit_width not in (8, 16, 32, 64):
        raise ValueError(f"bit_width must be 8, 16, 32 or 64, got "
                         f"{bit_width}")
    bits1, bits2 = _hash_iota(key, _shape(shape))
    if bit_width == 64:
        return (bits1 << 32) | bits2
    if bit_width == 32:
        return bits1 ^ bits2
    return (bits1 ^ bits2) & ((1 << bit_width) - 1)


# dtype → (bits, mantissa bits, int type of its width, the bits of 1.0)
_FLOAT_LAYOUT = {torch.float32: (32, 23, torch.int32, 0x3F800000),
                 torch.float64: (64, 52, torch.int64, 0x3FF0000000000000),
                 torch.bfloat16: (16, 7, torch.int16, 0x3F80),
                 torch.float16: (16, 10, torch.int16, 0x3C00)}
_WIDE = (torch.float32, torch.float64)


def uniform(key: torch.Tensor, shape: Shape = (),
            dtype: torch.dtype = torch.float32, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in f32 (32-bit draws), f64 (64-bit draws),
    f16 (16-bit draws) or bf16 (8-bit draws: jax draws 8 bits for fewer
    than 8 mantissa bits): the top mantissa bits over 1.0's exponent,
    bit-cast, minus 1, then ``floats * (maxval - minval) + minval`` and
    ``max(minval, ·)``, the bounds first rounded to ``dtype``. XLA
    contracts that product and sum into one fused multiply-add, rounded
    once, which :func:`xla_math.fma` reproduces exactly; where
    ``maxval - minval`` is a power of two (the default [0, 1), gumbel's
    [tiny, 1)) the product is exact and the plain sum rounds once
    already. In 16 bits, XLA's CPU rounds a bf16 product and sum each
    to bf16 (every bf16 op is an f32 op between roundings), and
    contracts the f16 product and sum into one rounding (the f32
    product of two 11-bit values is exact). No branch copies anything
    from the host, so a step captured as a CUDA graph can draw on it."""
    if dtype not in _FLOAT_LAYOUT:
        raise TypeError(f"uniform draws float16, bfloat16, float32 or "
                        f"float64, not {dtype}")
    nbits, nmant, itype, one = _FLOAT_LAYOUT[dtype]
    rng_bits = nbits if nmant >= 8 else 8
    bits = random_bits(key, rng_bits, shape)
    # a logical shift right: the arithmetic shift's sign bits are masked
    mant = (bits >> (rng_bits - nmant)) & ((1 << nmant) - 1)
    floats = (mant | one).to(itype).view(dtype) - 1.0
    if nbits == 16:
        lo, hi = (torch.tensor(float(v), dtype=dtype).item()
                  for v in (minval, maxval))
        span = torch.tensor(hi - lo, dtype=dtype).item()
        if dtype == torch.bfloat16:
            out = floats * span + lo
        else:
            out = (floats.float() * span + lo).to(dtype)
        return torch.clamp_min(out, lo)
    np_dtype = {32: np.float32, 64: np.float64}[nbits]
    lo = np_dtype(float(minval))
    span = np_dtype(float(maxval)) - lo          # rounded as jax rounds it
    if np.frexp(span)[0] == 0.5:
        out = floats * float(span) + float(lo)
    else:
        out = xla_math.fma(floats, float(span), float(lo))
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
                axis: int = -1, shape: Optional[Shape] = None) -> torch.Tensor:
    """``jax.random.categorical`` with replacement: the Gumbel-max
    draw ``argmax(gumbel + logits)`` (the first index on ties), int64.
    ``shape`` (one key only) is the result's shape: the batch shape
    (logits' shape without ``axis``) with leading sample dims before
    it; the noise is drawn over (*leading, *logits' shape) as jax draws
    it. With a batch of S keys, logits (S, ...) and row i is drawn from
    key i over the row's own shape (``jax.vmap`` over keys and rows)."""
    key = _check_key(key)
    if key.device != logits.device:
        raise ValueError(f"the key is on {key.device}, the logits on "
                         f"{logits.device}")
    lshape = tuple(logits.shape)
    if key.ndim == 2:
        if shape is not None:
            raise TypeError("a batch of keys draws one row each; shape= "
                            "takes one key")
        if not lshape or lshape[0] != key.shape[0]:
            raise ValueError(f"{key.shape[0]} keys for logits of shape "
                             f"{lshape}: a batch of keys draws one row each")
        noise = gumbel(key, lshape[1:], logits.dtype)
        return torch.argmax(noise + logits, dim=axis)
    ndim = len(lshape)
    axis = axis - ndim if axis >= 0 else axis
    batch = lshape[:ndim + axis] + lshape[ndim + axis + 1:]
    shape = batch if shape is None else _shape(shape)
    n_lead = len(shape) - len(batch)
    if n_lead < 0 or shape[n_lead:] != batch:
        raise ValueError(f"shape {shape} does not end in the logits' batch "
                         f"shape {batch}")
    draw = list(shape[n_lead:])
    draw.insert(axis % ndim, lshape[axis])
    noise = gumbel(key, shape[:n_lead] + tuple(draw), logits.dtype)
    return torch.argmax(noise + logits.reshape((1,) * n_lead + lshape),
                        dim=axis)


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


def normal(key: torch.Tensor, shape: Shape = (),
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.normal``: ``sqrt(2) * erf_inv(u)`` with u uniform over
    (nextafter(-1, 0), 1), ``erf_inv`` as XLA expands it
    (:mod:`xla_math`). A batch of keys draws (S, *shape)."""
    if dtype not in _WIDE:
        raise TypeError(f"normal draws float32 or float64, not {dtype}")
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    lo = float(np.nextafter(np_dtype(-1.0), np_dtype(0.0)))
    u = uniform(key, shape, dtype, lo, 1.0)
    return xla_math.erf_inv(u) * float(np_dtype(math.sqrt(2.0)))


def exponential(key: torch.Tensor, shape: Shape = (),
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.exponential``: ``-log1p(-u)``, u uniform over [0, 1)."""
    if dtype not in _WIDE:
        raise TypeError(f"exponential draws float32 or float64, not {dtype}")
    return -xla_math.log1p(-uniform(key, shape, dtype))


_INT_BITS = {torch.int8: 8, torch.int16: 16, torch.int32: 32,
             torch.int64: 64, torch.uint8: 8}
_INT64_MIN = -2 ** 63


def _ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < b for uint64 bit patterns held in int64."""
    return (a ^ _INT64_MIN) < (b ^ _INT64_MIN)


def _urem(x: torch.Tensor, span: torch.Tensor, nbits: int) -> torch.Tensor:
    """XLA's unsigned remainder ``x % span`` (``x`` itself where span is
    0) of ``nbits``-wide words in int64 lanes. A 32-bit word is a
    non-negative int64, where torch's signed remainder is exact; a
    64-bit span at or past 2^63 leaves x or x - span, and a smaller one
    takes the remainder of x's top 63 bits, doubled, plus its last bit,
    brought below span once more."""
    zero = span == 0
    safe = torch.where(zero, torch.ones_like(span), span)
    if nbits < 64:
        return torch.where(zero, x, x % safe)
    big = safe < 0
    low = torch.where(big, torch.ones_like(safe), safe)
    r = (((x >> 1) & (2 ** 63 - 1)) % low) * 2 + (x & 1)
    r = torch.where(_ult(r, low), r, r - low)
    r = torch.where(big, torch.where(_ult(x, safe), x, x - safe), r)
    return torch.where(zero, x, r)


def randint(key: torch.Tensor, shape: Shape, minval: int, maxval: int,
            dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """``jax.random.randint`` over [minval, maxval): two draws of the
    dtype's width (at least 32 bits) from ``split(key)``, combined as
    ``(hi % span * (2^(bits/2) % span)^2 % span + lo % span) % span`` in
    unsigned arithmetic, where span is ``maxval - minval`` (1 when
    maxval <= minval; one more when maxval lies past the dtype's
    largest value, which may wrap to 0 and leave the bits as they are).
    ``minval`` and ``maxval`` are ints, clipped to the dtype's range."""
    if dtype not in _INT_BITS:
        raise TypeError(f"randint draws int8/16/32/64 or uint8, not {dtype}")
    shape = _shape(shape)
    info = torch.iinfo(dtype)
    minval, maxval = int(minval), int(maxval)
    sample_dtype = dtype if _INT_BITS[dtype] >= 32 else torch.int32
    if sample_dtype != dtype:    # jax samples narrow types in 32 bits,
        # its bounds cast to int32 (wrapping) and clipped to the type
        minval, maxval = (((v + 2 ** 31) & MASK) - 2 ** 31
                          for v in (minval, maxval))
        minval = min(max(minval, info.min), info.max)
        maxval = min(max(maxval, info.min), info.max + 1)
    nbits = _INT_BITS[sample_dtype]
    smax = torch.iinfo(sample_dtype).max
    out_of_range = maxval > smax
    lo_v = min(max(minval, -smax - 1), smax)
    hi_v = min(max(maxval, -smax - 1), smax)
    umask = (1 << nbits) - 1
    span = (hi_v - lo_v) & umask
    if hi_v <= lo_v:
        span = 1
    elif out_of_range:
        span = (span + 1) & umask
    as_i64 = span - (1 << 64) if span >= 1 << 63 else span
    k1, k2 = split(key)
    higher, lower = (random_bits(k, nbits, shape) for k in (k1, k2))
    if nbits == 32:
        higher, lower = higher & MASK, lower & MASK
    span_t = torch.full(shape, as_i64, dtype=torch.int64, device=key.device)
    half = torch.full_like(span_t, 1 << (nbits // 2))
    mult = _urem(half, span_t, nbits)
    mult = _urem((mult * mult) & umask if nbits == 32 else mult * mult,
                 span_t, nbits)
    prod = _urem(higher, span_t, nbits) * mult
    offset = prod + _urem(lower, span_t, nbits)
    if nbits == 32:
        offset = offset & umask
    offset = _urem(offset, span_t, nbits)
    out = offset + lo_v
    if nbits == 32:                      # wrap to int32 as XLA's add does
        out = ((out + 2 ** 31) & umask) - 2 ** 31
    return out.to(dtype)


def permutation(key: torch.Tensor, x, axis: int = 0) -> torch.Tensor:
    """``jax.random.permutation``: ``x`` (an int n for ``arange(n)``, or a
    tensor) shuffled along ``axis`` by ``ceil(3 ln n / ln(2^32 - 1))``
    rounds, each a ``split`` and a stable sort on fresh 32-bit keys; a
    tensor of more than one dim is indexed by a shuffled ``arange``."""
    key = _check_key(key)
    if key.ndim != 1:
        raise TypeError(f"permutation takes one key, got {_describe(key)}")
    if isinstance(x, int):
        return _shuffle(key, torch.arange(x, device=key.device))
    if x.ndim == 0:
        raise TypeError("x must be an integer or at least 1-dimensional")
    if x.ndim == 1:
        return _shuffle(key, x)
    axis = axis % x.ndim
    ind = _shuffle(key, torch.arange(x.shape[axis], device=x.device))
    return torch.index_select(x, axis, ind)


def _shuffle(key: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    n = x.numel()
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(random_bits(sub, 32, x.shape), stable=True)[1]
        x = x[order]
    return x


def choice(key: torch.Tensor, a, shape: Shape = (), replace: bool = True,
           p: Optional[torch.Tensor] = None, axis: int = 0) -> torch.Tensor:
    """``jax.random.choice``: ``shape`` draws from ``a`` (an int n for
    ``arange(n)``, or a tensor, drawn along ``axis``), by jax's four
    branches: with replacement and no ``p``, ``randint`` indices (int64,
    as in jax's 64-bit mode); with ``p``, a search of ``cumsum(p)`` for
    ``cumsum(p)[-1] * (1 - uniform)`` in p's dtype; without replacement
    and no ``p``, the first draws of ``permutation``; without
    replacement and with ``p``, the top ``shape`` of ``gumbel + log p``
    (lower index first on ties, as ``lax.top_k``)."""
    key = _check_key(key)
    if key.ndim != 1:
        raise TypeError(f"choice takes one key, got {_describe(key)}")
    shape = _shape(shape)
    arr = torch.arange(a, device=key.device) if isinstance(a, int) else a
    axis = axis % max(arr.ndim, 1)
    n_inputs = arr.shape[axis]
    n_draws = math.prod(shape)
    if n_draws == 0:
        return torch.zeros(shape, dtype=arr.dtype, device=arr.device)
    if n_inputs <= 0:
        raise ValueError("a must be greater than 0 unless no samples are "
                         "taken")
    if not replace and n_draws > n_inputs:
        raise ValueError(f"Cannot take a larger sample (size {n_draws}) "
                         f"than population (size {n_inputs}) when "
                         "'replace=False'")
    if p is None:
        if replace:
            ind = randint(key, shape, 0, n_inputs, torch.int64)
            result = torch.index_select(arr, axis, ind.reshape(-1))
        else:
            perm = permutation(key, arr, axis)
            return perm.narrow(axis, 0, n_draws).reshape(
                arr.shape[:axis] + shape + arr.shape[axis + 1:])
    else:
        if not p.is_floating_point():
            p = p.to(torch.float32)
        if tuple(p.shape) != (n_inputs,):
            raise ValueError(f"p must be None or a 1D vector with the same "
                             f"size as a.shape[axis]. p has shape "
                             f"{tuple(p.shape)} and a.shape[axis] is "
                             f"{n_inputs}.")
        if replace:
            cum = torch.cumsum(p, 0)
            r = cum[-1] * (1 - uniform(key, shape, p.dtype))
            ind = torch.searchsorted(cum, r.reshape(-1).contiguous())
        else:
            g = gumbel(key, (n_inputs,), p.dtype) + xla_math.log(p)
            ind = torch.sort(g, descending=True, stable=True)[1][:n_draws]
        result = torch.index_select(arr, axis, ind.reshape(-1))
    return result.reshape(arr.shape[:axis] + shape + arr.shape[axis + 1:])


def _f64_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in float64 ulps of the larger magnitude (the margin of a
    comparison a <= b)."""
    a, b = a.double(), b.double()
    big = torch.maximum(torch.abs(a), torch.abs(b))
    ulp = torch.nextafter(big, torch.full_like(big, math.inf)) - big
    return torch.abs(a - b) / ulp


def gamma(key: torch.Tensor, a, shape: Optional[Shape] = None,
          dtype: torch.dtype = torch.float64, margins: bool = False):
    """``jax.random.gamma`` (Marsaglia and Tsang; alpha < 1 boosted to
    alpha + 1 and scaled by ``(1 - u)^(1/alpha)``), as jax vmaps it:
    ``split(key, n)`` gives each element its own key, and each element
    loops on its own chain (``split(key)`` first, ``split(key, 3)`` in
    the accept loop, ``split`` in the inner ``v <= 0`` loop), every
    scalar normal and uniform from its own key. The lanes still looping
    are gathered each round (one host read a round). ``margins=True``
    also returns, per element, the smallest distance in float64 ulps
    between the two sides of a comparison that decided one of its
    rounds: ``u < 1 - 0.0331 x^4`` always, ``log u < ...`` where the
    first did not accept (a distance from an infinite side, NaN, is
    left out)."""
    key = _check_key(key)
    if key.ndim != 1:
        raise TypeError(f"gamma takes one key, got {_describe(key)}")
    if dtype not in _WIDE:
        raise TypeError(f"gamma draws float32 or float64, not {dtype}")
    a = torch.as_tensor(a, dtype=dtype, device=key.device)
    shape = tuple(a.shape) if shape is None else _shape(shape)
    alpha = torch.broadcast_to(a, shape).reshape(-1)
    n = alpha.numel()
    keys = split(key, n).reshape(n, 2)
    boost = alpha >= 1.0
    alpha_b = torch.where(boost, alpha, alpha + 1.0)
    third = float(np.array(1.0 / 3.0, dtype=str(dtype)[6:]))
    d = alpha_b - third
    c = xla_math.rsqrt(d) * third     # XLA rewrites (1/3) / sqrt(d)
    keys, sub = split(keys).unbind(1)
    X, V, U = (torch.full_like(alpha, v) for v in (0.0, 1.0, 2.0))
    margin = torch.full_like(alpha, math.inf, dtype=torch.float64)
    live = torch.arange(n, device=key.device)
    while live.numel():
        kl, xk, uk = split(keys[live], 3).unbind(1)
        keys[live] = kl
        cl, dl = c[live], d[live]
        x, v = torch.zeros_like(cl), torch.full_like(cl, -1.0)
        inner = torch.arange(live.numel(), device=key.device)
        while inner.numel():
            xk_next, xs = split(xk[inner]).unbind(1)
            xk[inner] = xk_next
            xi = normal(xs, (), dtype)
            x[inner] = xi
            v[inner] = xla_math.fma(xi, cl[inner], 1.0)
            inner = inner[v[inner] <= 0]
        Xl, Vl = x * x, (v * v) * v
        Ul = uniform(uk, (), dtype)
        X[live], V[live], U[live] = Xl, Vl, Ul
        rhs1 = xla_math.fma(Xl * Xl, -0.0331, 1.0)
        rhs2 = xla_math.fma(Xl, 0.5, dl * ((1.0 - Vl) + xla_math.log(Vl)))
        lhs2 = xla_math.log(Ul)
        if margins:
            second = torch.where(Ul >= rhs1, _f64_ulps(lhs2, rhs2), math.inf)
            margin[live] = torch.fmin(margin[live], torch.fmin(
                _f64_ulps(Ul, rhs1), second))
        live = live[(Ul >= rhs1) & (lhs2 >= rhs2)]
    scale = torch.where(boost, torch.ones_like(alpha),
                        torch.pow(1.0 - uniform(sub, (), dtype),
                                  torch.ones_like(alpha) / alpha))
    out = ((d * V) * scale).reshape(shape)
    return (out, margin.reshape(shape)) if margins else out


def poisson(key: torch.Tensor, lam, shape: Optional[Shape] = None,
            dtype: torch.dtype = torch.int64, margins: bool = False):
    """``jax.random.poisson``: ``lam`` cast to float32; Knuth's product of
    uniforms where lam < 10 (or NaN) and Hormann's transformed rejection
    elsewhere, both run on ``key`` over the whole shape (one ``split``
    and one full-shape uniform a round for Knuth, ``split(key, 3)`` and
    two for Hormann, until every element is done: one host read a
    round), picked per element; lam == 0 gives 0. ``margins=True`` also
    returns, per element, the smallest distance in float32 ulps at a
    comparison that decided it: Knuth's ``log_prod > -lam`` in each
    round the lane goes on; in each of Hormann's rounds the floor, and
    ``s <= t`` where ``accept1`` and ``reject`` left it open (lanes
    accepted earlier included, since a later accept overwrites their
    count, as in jax). A distance from an infinite or NaN side is left
    out. The margins cost several float64 passes a round, so they are
    computed only when asked for."""
    key = _check_key(key)
    if key.ndim != 1:
        raise TypeError(f"poisson takes one key, got {_describe(key)}")
    lam = torch.as_tensor(lam, device=key.device)
    shape = tuple(lam.shape) if shape is None else _shape(shape)
    lam = torch.broadcast_to(lam, shape).to(torch.float32)
    knuth = torch.isnan(lam) | (lam < 10)
    margin = torch.full(shape, math.inf, dtype=torch.float64,
                        device=key.device) if margins else None
    k_knuth = _poisson_knuth(key, torch.where(knuth, lam, 0.0), margin)
    k_rej = _poisson_rejection(key, torch.where(knuth, 1e5, lam),
                               margin, knuth)
    out = torch.where(knuth, k_knuth, k_rej)
    out = torch.where(lam == 0, torch.zeros_like(out), out).to(dtype)
    return (out, margin) if margins else out


def _f32_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    big = torch.maximum(torch.abs(a), torch.abs(b))
    ulp = torch.nextafter(big, torch.full_like(big, math.inf)) - big
    return (torch.abs(a - b) / ulp).double()


def _poisson_knuth(key, lam, margin):
    k = torch.zeros(lam.shape, dtype=torch.int64, device=lam.device)
    log_prod = torch.zeros_like(lam)
    while True:
        going = log_prod > -lam
        if not bool(going.any()):
            break
        key, sub = split(key)
        k = torch.where(going, k + 1, k)
        log_prod = log_prod + xla_math.log(uniform(sub, lam.shape))
        if margin is not None:
            torch.fmin(margin, torch.where(
                going, _f32_ulps(log_prod, -lam), math.inf), out=margin)
    return k - 1


def _poisson_rejection(key, lam, margin, skip):
    log_lam = xla_math.log(lam)
    b = xla_math.fma(xla_math._sqrt(lam), 2.53, 0.931)
    a = xla_math.fma(b, 0.02483, -0.059)
    inv_alpha = 1.1239 + torch.full_like(lam, 1.1328) / (b - 3.4)
    v_r = 0.9277 - torch.full_like(lam, 3.6224) / (b - 2.0)
    k_out = torch.full_like(lam, -1.0)
    accepted = torch.zeros(lam.shape, dtype=torch.bool, device=lam.device)
    while not bool(accepted.all()):
        key, sub0, sub1 = split(key, 3)
        u = uniform(sub0, lam.shape) - 0.5
        v = uniform(sub1, lam.shape)
        us = 0.5 - torch.abs(u)
        pre = xla_math.fma((2.0 * a) / us + b, u, lam) + 0.43
        k = torch.floor(pre)
        s = xla_math.log(v * inv_alpha / (a / (us * us) + b))
        t = xla_math.fma(k, log_lam, -lam) - xla_math.lgamma(k + 1.0)
        accept1 = (us >= 0.07) & (v <= v_r)
        reject = (k < 0) | ((us < 0.013) & (v > us))
        accept = accept1 | (~reject & (s <= t))
        if margin is not None:
            undecided = ~(accept1 | reject | skip)
            torch.fmin(margin, torch.where(skip, math.inf, torch.fmin(
                _f32_ulps(pre, torch.round(pre)),
                torch.where(undecided, _f32_ulps(s, t), math.inf))),
                out=margin)
        k_out = torch.where(accept, k, k_out)
        accepted = accepted | accept
    return k_out.to(torch.int64)


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
