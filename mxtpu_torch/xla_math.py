"""XLA's CPU roundings of the elementary functions ``jax.random`` uses.

``mxtpu`` draws its normals, exponentials, gammas and Poisson counts
through XLA, whose CPU backend does not call a libm for ``log``,
``log1p``, ``erf_inv`` and ``lgamma`` in float32: it expands each into
a fixed polynomial (Eigen's ``plog`` for ``log``, a rational
approximation for ``log1p`` near 0, Giles' polynomial for ``erf_inv``,
Lanczos' series for ``lgamma``), and LLVM then contracts every multiply
whose only user is an add into one fused multiply-add. This module
writes those expansions out op by op, with :func:`fma` where the
compiled code fuses, so the port's float32 draws round as the
reference's do, on the CPU and on the card alike: every op here rounds
once (IEEE add, multiply, divide, sqrt), and no compiler contracts
across torch's kernels.

In float64 XLA calls glibc's ``log`` (correctly rounded in nearly every
case); torch's ``log`` on the CPU and the card's are within an ulp of
it, so the float64 forms here follow XLA's structure but are not held
bit for bit.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["fma", "log", "log1p", "erf_inv", "lgamma", "digamma",
           "rsqrt"]

_F32_MIN_NORMAL = 1.1754943508222875e-38
_VELTKAMP_64 = 134217729.0                # 2^27 + 1 splits a float64 in two
_SQRT_HALF = 0.7071067690849304            # f32(sqrt(0.5)), Eigen's cutoff
# Eigen's plog_float: y = ((p0 x + p1) x + p2), y1 = ..., y2 = ...
_LOG_P = (0.07037683576345444, -0.11514610052108765, 0.11676998436450958,
          -0.12420140951871872, 0.14249323308467865, -0.16668057441711426,
          0.2000071406364441, -0.24999994039535522, 0.3333333134651184)
_LN2_LO, _LN2_HI = -0.00021219444170128554, 0.693359375
# XLA's log1p for |x| < f32(sqrt(2) - 1): x - x²/2 + x³ N(x)/D(x)
_LOG1P_SMALL = 0.4142135679721832
_LOG1P_N = (4.527000055531971e-05, 0.4985410273075104, 6.578732490539551,
            29.91191864013672, 60.949668884277344, 57.11296463012695,
            20.039552688598633)
_LOG1P_D = (1.0, 15.062909126281738, 83.04756927490234, 221.7624053955078,
            309.0987243652344, 216.42788696289062, 60.11865997314453)
# the same rational in float64 (XLA's Log1p for |x| < sqrt(2) - 1)
_LOG1P_N64 = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_D64 = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
# Giles' single-precision erfinv: coefficients for w < 5 and for w >= 5
_ERF_INV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                -4.39150654e-06, 0.00021858087, -0.00125372503,
                -0.00417768164, 0.246640727, 1.50140941)
_ERF_INV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                -0.00367342844, 0.00573950773, -0.0076224613,
                0.00943887047, 1.00167406, 2.83297682)
# XLA's ErfInv64 (Giles' double-precision branches w < 6.25, < 16, >= 16)
_ERF_INV64_LT625 = (
    -3.6444120640178196996e-21, -1.685059138182016589e-19,
    1.2858480715256400167e-18, 1.115787767802518096e-17,
    -1.333171662854620906e-16, 2.0972767875968561637e-17,
    6.6376381343583238325e-15, -4.0545662729752068639e-14,
    -8.1519341976054721522e-14, 2.6335093153082322977e-12,
    -1.2975133253453532498e-11, -5.4154120542946279317e-11,
    1.051212273321532285e-09, -4.1126339803469836976e-09,
    -2.9070369957882005086e-08, 4.2347877827932403518e-07,
    -1.3654692000834678645e-06, -1.3882523362786468719e-05,
    0.0001867342080340571352, -0.00074070253416626697512,
    -0.0060336708714301490533, 0.24015818242558961693,
    1.6536545626831027356)
_ERF_INV64_LT16 = (
    2.2137376921775787049e-09, 9.0756561938885390979e-08,
    -2.7517406297064545428e-07, 1.8239629214389227755e-08,
    1.5027403968909827627e-06, -4.013867526981545969e-06,
    2.9234449089955446044e-06, 1.2475304481671778723e-05,
    -4.7318229009055733981e-05, 6.8284851459573175448e-05,
    2.4031110387097893999e-05, -0.0003550375203628474796,
    0.00095328937973738049703, -0.0016882755560235047313,
    0.0024914420961078508066, -0.0037512085075692412107,
    0.005370914553590063617, 1.0052589676941592334,
    3.0838856104922207635)
_ERF_INV64_GE16 = (
    -2.7109920616438573243e-11, -2.5556418169965252055e-10,
    1.5076572693500548083e-09, -3.7894654401267369937e-09,
    7.6157012080783393804e-09, -1.4960026627149240478e-08,
    2.9147953450901080826e-08, -6.7711997758452339498e-08,
    2.2900482228026654717e-07, -9.9298272942317002539e-07,
    4.5260625972231537039e-06, -1.9681778105531670567e-05,
    7.5995277030017761139e-05, -0.00021503011930044477347,
    -0.00013871931833623122026, 1.0103004648645343977,
    4.8499064014085844221)
# Lanczos (g = 7, n = 9) as XLA rounds it to float32
_LANCZOS = (676.520386, -1259.13916, 771.323425, -176.615036, 12.5073433,
            -0.138571098, 9.98436917e-06, 1.50563267e-07)
_LANCZOS_G_HALF = 7.5
_LOG_LANCZOS_G_HALF = 2.01490307           # f32(log(7.5))
_INV_LANCZOS_G_HALF = 0.13333334           # f32(1 / 7.5)
_LOG_SQRT_2PI = 0.918938518                # f32(log(sqrt(2 pi)))


def _f32(v: float) -> float:
    """``v`` rounded to float32, as a Python float (exact in f32)."""
    return float(np.float32(v))


def _full(like: torch.Tensor, v: float) -> torch.Tensor:
    return torch.full_like(like, v)


def _two_sum(a, b):
    """s + err == a + b exactly, s = fl(a + b) (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b):
    """p + err == a * b exactly for float64, p = fl(a * b) (Dekker,
    Veltkamp's split)."""
    def split(x):
        c = x * _VELTKAMP_64
        hi = c - (c - x)
        return hi, x - hi
    p = a * b
    (ah, al), (bh, bl) = split(a), split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _round_to_odd(s: torch.Tensor, err: torch.Tensor) -> torch.Tensor:
    """s moved one ulp toward ``err`` where err is not 0 and s is even:
    s + err rounded to odd (``err`` is the exact tail of a sum s)."""
    itype = torch.int64 if s.dtype == torch.float64 else torch.int32
    even = (s.view(itype) & 1) == 0
    toward = torch.where(err > 0, math.inf, -math.inf).to(s.dtype)
    return torch.where((err != 0) & even & torch.isfinite(s),
                       torch.nextafter(s, toward), s)


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once, in ``a``'s dtype (float32 or
    float64), as XLA's contracted multiply-add rounds it. ``b`` and
    ``c`` are tensors or Python floats exact in that dtype. Float32: the
    product is exact in float64 and the sum, rounded to odd there, loses
    nothing to the final rounding to float32. Float64: Boldo and
    Melquiond's emulation, the exact product's tail and the sum's tail
    added with rounding to odd, then one rounding to nearest. Every op
    is its own kernel, so no compiler contracts any of them, on the CPU
    or the card; nothing is copied from the host."""
    if a.dtype == torch.float64:
        b = b if isinstance(b, torch.Tensor) else _full(a, b)
        c = c if isinstance(c, torch.Tensor) else _full(a, c)
        uh, ul = _two_prod(a, b)
        th, tl = _two_sum(c, uh)
        return th + _round_to_odd(*_two_sum(tl, ul))
    if a.dtype != torch.float32:
        raise TypeError(f"fma takes float32 or float64, not {a.dtype}")
    b = b.double() if isinstance(b, torch.Tensor) else _f32(b)
    c = c.double() if isinstance(c, torch.Tensor) else _f32(c)
    p = a.double() * b
    return _round_to_odd(*_two_sum(p, c)).float()


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """IEEE sqrt, rounded once: torch's float32 sqrt on the CPU is not
    correctly rounded, its float64 one is within an ulp of 2^-53, and
    rounding that to float32 is exact rounding of the square root."""
    if x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    """``1 / sqrt(x)`` rounded once (float32: from float64, where it is
    within an ulp of 2^-53). XLA's CPU code takes the processor's
    estimate (``vrsqrtss``) and two Newton steps, which lands on the
    correctly rounded value nearly always, but not on every processor
    the same way."""
    if x.dtype == torch.float32:
        xd = x.double()
        return (torch.ones_like(xd) / torch.sqrt(xd)).float()
    return torch.ones_like(x) / torch.sqrt(x)


def _horner(x: torch.Tensor, coeffs, start=None) -> torch.Tensor:
    """``((c0 x + c1) x + c2) ...``, every step one fused multiply-add."""
    p = _full(x, coeffs[0]) if start is None else start
    for c in coeffs[1:]:
        p = fma(p, x, c)
    return p


def _log_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log`` (Eigen's ``plog_float``) as its CPU backend
    compiles it: the mantissa folded into [sqrt(1/2), sqrt(2)), three
    interleaved Horner chains, and the exponent's ln 2 in two parts."""
    xc = torch.clamp_min(x, _F32_MIN_NORMAL)
    bits = xc.view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = ((bits & -2139095041) | 0x3F000000).view(torch.float32)
    small = m < _SQRT_HALF
    x1 = (m - 1.0) + torch.where(small, m, 0.0)
    e = e - small.float()
    x2 = x1 * x1
    x3 = x2 * x1
    p = _LOG_P
    y = fma(fma(x1, p[0], p[1]), x1, p[2])
    y1 = fma(fma(x1, p[3], p[4]), x1, p[5])
    y2 = fma(fma(x1, p[6], p[7]), x1, p[8])
    y = fma(fma(y, x3, y1), x3, y2)
    y = fma(y, x3, e * _LN2_LO)
    r = fma(e, _LN2_HI, (x1 - x2 * 0.5) + y)
    # XLA's CPU code runs with denormals read as zero
    r = torch.where((x < 0) | torch.isnan(x), math.nan, r)
    r = torch.where(torch.abs(x) < _F32_MIN_NORMAL, -math.inf, r)
    return torch.where(x == math.inf, math.inf, r)


def log(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log`` as XLA computes it on the CPU (float32 bit for bit;
    float64 within an ulp, see the module's docstring)."""
    if x.dtype == torch.float32:
        return _log_f32(x)
    return torch.log(x)


def log1p(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log1p`` as XLA computes it: for |x| < sqrt(2) - 1 the
    rational ``x + (x³ N(x)/D(x) - x²/2)``, else ``log(1 + x)``."""
    f32 = x.dtype == torch.float32
    num, den, cut = ((_LOG1P_N, _LOG1P_D, _LOG1P_SMALL) if f32 else
                     (_LOG1P_N64, _LOG1P_D64, math.sqrt(2.0) - 1.0))
    x2 = x * x
    z = x * 0.0                          # XLA's leading term: 0, or NaN
    n = _horner(x, num, z + num[0])
    d = _horner(x, den, z + den[0])
    small = x + fma(x2, -0.5, (x * x2) * (n / d))
    return torch.where(torch.abs(x) < cut, small, log(x + 1.0))


def _erf_inv_f32(x: torch.Tensor) -> torch.Tensor:
    w = -log1p(x * -x)
    lt5 = w < 5.0
    coeff = [torch.where(lt5, a, b) for a, b in zip(_ERF_INV_LT5,
                                                    _ERF_INV_GE5)]
    w = torch.where(lt5, w - 2.5, _sqrt(w) - 3.0)
    p = coeff[0]
    for c in coeff[1:]:
        p = fma(p, w, c)
    return torch.where(torch.abs(x) == 1.0, x * math.inf, p * x)


def _erf_inv_f64(x: torch.Tensor) -> torch.Tensor:
    w = -log1p(x * -x)
    lt625, lt16 = w < 6.25, w < 16.0
    lo, mid, hi = _ERF_INV64_LT625, _ERF_INV64_LT16, _ERF_INV64_GE16

    def coeff(i):
        c = _full(x, lo[i])
        if i < 19:
            c = torch.where(lt625, c, mid[i])
        if i < 17:
            c = torch.where(lt16, c, hi[i])
        return c
    w = torch.where(lt625, w - 3.125,
                    _sqrt(w) - torch.where(lt16, 3.25, 5.0))
    p = coeff(0)
    for i in range(1, 17):
        p = fma(p, w, coeff(i))
    for i in range(17, 19):
        p = torch.where(lt16, fma(p, w, coeff(i)), p)
    for i in range(19, 23):
        p = torch.where(lt625, fma(p, w, coeff(i)), p)
    return torch.where(torch.abs(x) == 1.0, x * math.inf, p * x)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """``jax.lax.erf_inv``: Giles' polynomial in w = -log1p(-x²), as XLA
    expands it (two branches in float32, three in float64)."""
    if x.dtype == torch.float32:
        return _erf_inv_f32(x)
    if x.dtype == torch.float64:
        return _erf_inv_f64(x)
    raise TypeError(f"erf_inv takes float32 or float64, not {x.dtype}")


def lgamma(x: torch.Tensor) -> torch.Tensor:
    """``jax.lax.lgamma`` in float32 for x >= 0.5 (XLA's Lanczos branch;
    the reflection XLA takes below 0.5 is not written out, and gives
    NaN here): with z = x - 1 and t = z + 7.5,
    ``(z + 0.5 - t / log t) log t + log sqrt(2 pi) + log(series)``, where
    log t is ``log(7.5) + log1p(z / 7.5)``."""
    if x.dtype != torch.float32:
        raise TypeError(f"lgamma takes float32, not {x.dtype}")
    z = x - 1.0
    t = z + _LANCZOS_G_HALF
    log_t = log1p(z * _INV_LANCZOS_G_HALF) + _LOG_LANCZOS_G_HALF
    lead = fma((z + 0.5) - t / log_t, log_t, _LOG_SQRT_2PI)
    series = _full(x, 1.0)
    for i, c in enumerate(_LANCZOS):
        series = _full(x, c) / (z + float(i + 1)) + series
    out = lead + log(series)
    out = torch.where(x < 0.5, math.nan, out)
    return torch.where(torch.abs(x) == math.inf, math.inf, out)


_LANCZOS_BASE = 1.0                         # f32(0.99999999999980993)
_LANCZOS_G = 7.0


def digamma(x: torch.Tensor) -> torch.Tensor:
    """``jax.lax.digamma`` in float32 for x >= 0.5 (XLA's Lanczos branch,
    the derivative of :func:`lgamma`'s series; NaN below 0.5): with
    z = x - 1 and t = z + 7.5, ``log t + num / denom - 7 / t``, where
    num = -Σ c_i / (z + i + 1)² and denom = 1 + Σ c_i / (z + i + 1)."""
    if x.dtype != torch.float32:
        raise TypeError(f"digamma takes float32, not {x.dtype}")
    z = x - 1.0
    num = _full(x, 0.0)
    denom = _full(x, _LANCZOS_BASE)
    for i, c in enumerate(_LANCZOS):
        zi = z + float(i + 1)
        num = num - _full(x, c) / (zi * zi)
        denom = denom + _full(x, c) / zi
    t = z + _LANCZOS_G_HALF
    log_t = log1p(z * _INV_LANCZOS_G_HALF) + _LOG_LANCZOS_G_HALF
    out = log_t + num / denom - _full(x, _LANCZOS_G) / t
    return torch.where(x < 0.5, math.nan, out)
