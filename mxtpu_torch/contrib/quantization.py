"""INT8 quantization — the port of ``mxtpu/contrib/quantization.py``
(reference ``python/mxnet/contrib/quantization.py`` over
``src/operator/quantization/``).

Symmetric int8: a tensor quantizes to ``clip(round(x · 127 / t), ±127)``
with ``t`` its calibrated |threshold| (or max |x| when uncalibrated).
The quantized ``FullyConnected``/``Convolution`` multiply int8 codes
and accumulate exactly in int32, then rescale to float32:
``acc · (t / 127) · (w_thr / 127) + bias``. The conversion pass
rewrites a Symbol graph (offline weight quantization plus calibrated
activation ranges), the reference's ``quantize_model`` flow:

    qsym, qarg, aux = quantize_model(sym, arg_params, aux_params,
                                     calib_data=..., calib_mode='naive')

and ``quantize_net`` does it for a Gluon HybridBlock.

The int32 accumulation is exact on both devices, so the card's results
are the CPU's bit for bit: on the card the products go through
``torch._int_mm`` (cuBLASLt's int8 GEMM with int32 accumulation; its
operands padded with zero rows and columns to the shapes it takes: more
than 16 rows, multiples of 8 for the inner and output widths), on the
CPU through float64 (every partial sum of int8 products is an integer
below 2^53, so exact). A convolution is an im2col (strided views of the
zero-padded int8 input, copied once) and one such product per group.
No float32 or TF32 accumulation is used: neither is exact.
"""
from __future__ import annotations

import os
import tempfile
from typing import Dict, List, Tuple

import numpy as onp
import torch

from .. import ndarray as nd
from ..base import MXNetError
from ..ndarray import NDArray
from ..ndarray.ndarray import apply_op
from ..ndarray.ops import register_op

__all__ = ["quantize", "dequantize", "quantize_model", "quantize_net",
           "calib_thresholds", "int8_matmul"]


# ---------------------------------------------------------------------------
# int8 products
# ---------------------------------------------------------------------------
def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 · (K, N) int8 → (M, N) int32, accumulated exactly."""
    M, K = a.shape
    N = b.shape[1]
    if not a.is_cuda:
        return torch.mm(a.to(torch.float64), b.to(torch.float64)).to(
            torch.int32)
    Mp, Kp, Np = max(M, 17), _round_up(max(K, 8), 8), _round_up(max(N, 8), 8)
    if (Mp, Kp) != (M, K):
        ap = a.new_zeros((Mp, Kp))
        ap[:M, :K] = a
        a = ap
    if (Kp, Np) != (K, N):
        bp = b.new_zeros((Kp, Np))
        bp[:K, :N] = b
        b = bp
    out = torch._int_mm(a.contiguous(), b.contiguous())
    return out[:M, :N] if (Mp, Np) != (M, N) else out


def _quantize_act(x: torch.Tensor, a_thr):
    """x → (int8 codes, t): t the calibrated threshold (a float32
    scalar) or max |x|, never below 1e-8."""
    if a_thr is not None:
        t = torch.full((), a_thr, dtype=torch.float32, device=x.device)
    else:
        t = torch.max(torch.abs(x))
    t = torch.maximum(t, torch.full_like(t, 1e-8))
    scale = torch.full_like(t, 127.0) / t
    q = torch.clamp(torch.round(x * scale), -127, 127).to(torch.int8)
    return q, t


def _rescale(acc: torch.Tensor, t: torch.Tensor, w_thr) -> torch.Tensor:
    """acc · (t / 127) · (w_thr / 127) in float32, each step rounded as
    the reference rounds it."""
    step = t / torch.full_like(t, 127.0)
    w_step = torch.full((), w_thr / 127.0, dtype=torch.float32,
                        device=acc.device)
    return acc.to(torch.float32) * step * w_step


# ---------------------------------------------------------------------------
# primitive ops
# ---------------------------------------------------------------------------
@register_op("_contrib_quantize_v2", aliases=("quantize_v2",))
def quantize(data, min_calib_range=None, max_calib_range=None, **kwargs):
    """float → int8 + (min, max) range scalars (reference quantize_v2,
    symmetric int8)."""
    static = min_calib_range is not None and max_calib_range is not None
    thr = max(abs(float(min_calib_range)), abs(float(max_calib_range))) \
        if static else None

    def _f(x):
        q, t = _quantize_act(x, thr)
        return q, -t, t
    return apply_op(_f, [data], "quantize_v2", n_out=3)


@register_op("_contrib_dequantize", aliases=("dequantize",))
def dequantize(data, min_range, max_range, **kwargs):
    def _f(q, lo, hi):
        t = torch.maximum(torch.maximum(torch.abs(lo), torch.abs(hi)),
                          torch.full_like(lo, 1e-8))
        return q.to(torch.float32) * (t / torch.full_like(t, 127.0))
    return apply_op(_f, [data, min_range, max_range], "dequantize")


def _quantize_weight(w: onp.ndarray) -> Tuple[onp.ndarray, float]:
    thr = max(float(onp.abs(w).max()), 1e-8)
    q = onp.clip(onp.round(w * (127.0 / thr)), -127, 127).astype(onp.int8)
    return q, thr


def _act_threshold(calib_min, calib_max):
    if calib_min is None or calib_max is None:
        return None
    return max(abs(float(calib_min)), abs(float(calib_max)))


@register_op("_contrib_quantized_fully_connected")
def quantized_fully_connected(data, weight, bias=None, num_hidden=None,
                              no_bias=False, flatten=True, w_thr=1.0,
                              calib_min=None, calib_max=None, **kwargs):
    """int8 FC with exact int32 accumulation, rescaled to float32
    (reference src/operator/quantization/quantized_fully_connected.cc).
    ``weight`` is pre-quantized int8; activations quantize on the fly
    (calibrated range when given, dynamic otherwise)."""
    a_thr = _act_threshold(calib_min, calib_max)
    arrs = [data, weight] + ([] if no_bias or bias is None else [bias])

    def _f(x, qw, *b):
        if flatten:
            x = x.reshape(x.shape[0], -1)
        qx, t = _quantize_act(x, a_thr)
        lead = qx.shape[:-1]
        acc = int8_matmul(qx.reshape(-1, qx.shape[-1]), qw.T)
        out = _rescale(acc.reshape(lead + (qw.shape[0],)), t, w_thr)
        if b:
            out = out + b[0]
        return out
    return apply_op(_f, arrs, "quantized_fc")


def _im2col(q: torch.Tensor, kernel, stride, pad):
    """(N, C, *S) → (N·prod(out), C·prod(kernel)), channels outermost
    in each row, as the weight (O, C, *kernel) flattens."""
    nd_ = len(kernel)
    if any(pad):
        padded = q.new_zeros(q.shape[:2] + tuple(
            s + 2 * p for s, p in zip(q.shape[2:], pad)))
        padded[(slice(None), slice(None)) + tuple(
            slice(p, p + s) for s, p in zip(q.shape[2:], pad))] = q
        q = padded
    for d in range(nd_):
        q = q.unfold(2 + d, kernel[d], stride[d])
    # (N, C, *out, *kernel) → (N, *out, C, *kernel)
    perm = (0,) + tuple(range(2, 2 + nd_)) + (1,) + tuple(
        range(2 + nd_, 2 + 2 * nd_))
    out_sizes = tuple(q.shape[2:2 + nd_])
    cols = q.permute(perm).reshape(-1, q.shape[1] * int(
        onp.prod(kernel)))
    return cols, out_sizes


@register_op("_contrib_quantized_conv")
def quantized_conv(data, weight, bias=None, kernel=None, stride=None,
                   pad=None, num_filter=None, num_group=1, no_bias=False,
                   w_thr=1.0, calib_min=None, calib_max=None, **kwargs):
    """int8 convolution with exact int32 accumulation (reference
    quantized_conv.cc), channels-first, 1-3 spatial dims."""
    kernel = tuple(int(k) for k in kernel)
    ndim = len(kernel)
    stride = tuple(stride) if stride else (1,) * ndim
    pad_ = tuple(pad) if pad else (0,) * ndim
    a_thr = _act_threshold(calib_min, calib_max)
    arrs = [data, weight] + ([] if no_bias or bias is None else [bias])

    def _f(x, qw, *b):
        qx, t = _quantize_act(x, a_thr)
        N, C = qx.shape[:2]
        O, G = qw.shape[0], int(num_group)
        accs = []
        for g in range(G):
            cols, out_sizes = _im2col(
                qx[:, g * (C // G):(g + 1) * (C // G)], kernel, stride, pad_)
            wg = qw[g * (O // G):(g + 1) * (O // G)].reshape(O // G, -1)
            accs.append(int8_matmul(cols, wg.T))
        acc = accs[0] if G == 1 else torch.cat(accs, dim=1)
        acc = acc.reshape((N,) + out_sizes + (O,))
        acc = acc.permute((0, ndim + 1) + tuple(range(1, ndim + 1)))
        out = _rescale(acc, t, w_thr)
        if b:
            out = out + b[0].reshape((1, -1) + (1,) * ndim)
        return out
    return apply_op(_f, arrs, "quantized_conv")


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------
def _kl_threshold(samples: onp.ndarray, num_bins: int = 2048,
                  num_quantized_bins: int = 255) -> float:
    """Entropy-optimal |threshold| (reference _LayerHistogramCollector's
    KL divergence calibration, simplified), numpy on the host."""
    mags = onp.abs(samples.ravel())
    max_val = float(mags.max()) if mags.size else 1.0
    if max_val <= 0:
        return 1.0
    hist, edges = onp.histogram(mags, bins=num_bins, range=(0, max_val))
    best_kl, best_thr = onp.inf, max_val
    for i in range(num_quantized_bins, num_bins + 1,
                   max(1, num_bins // 64)):
        thr = edges[i]
        p = hist[:i].astype(onp.float64).copy()
        p[-1] += hist[i:].sum()                  # clip outliers in
        if p.sum() == 0:
            continue
        # quantize p into num_quantized_bins then expand back
        factor = i / num_quantized_bins
        q = onp.zeros_like(p)
        for j in range(num_quantized_bins):
            lo, hi = int(j * factor), int((j + 1) * factor)
            hi = max(hi, lo + 1)
            chunk = p[lo:hi]
            nz = (chunk > 0).sum()
            if nz:
                q[lo:hi] = onp.where(chunk > 0, chunk.sum() / nz, 0)
        pn, qn = p / p.sum(), q / max(q.sum(), 1e-12)
        mask = pn > 0
        kl = float(onp.sum(pn[mask] * onp.log(
            pn[mask] / onp.maximum(qn[mask], 1e-12))))
        if kl < best_kl:
            best_kl, best_thr = kl, thr
    # never clip more than the 99.9th percentile of observed magnitude
    # (at factor≈1 the quantized histogram reproduces the clipped one
    # exactly and the KL degenerates to 0)
    floor = float(onp.percentile(mags, 99.9)) if mags.size else best_thr
    return float(max(best_thr, floor))


def calib_thresholds(sym, arg_params, aux_params, calib_data,
                     data_name: str = "data", node_names: List[str] = (),
                     calib_mode: str = "naive", num_calib_batches: int = 4,
                     ctx=None) -> Dict[str, float]:
    """Run calibration batches through the float32 graph and return the
    |threshold| of each requested internal output: its max |value|
    ('naive', kept as a running max on the device, so only one number
    an output crosses to the host) or the KL-optimal one ('entropy',
    over every value, gathered on the host). ``ctx`` None runs where
    the first batch lies."""
    from .. import symbol as msym
    internals = sym.get_internals()
    group = msym.Group([internals[n] for n in node_names])
    calib_data.reset()
    first = next(calib_data)
    ex = group.bind(ctx if ctx is not None else first.data[0].context,
                    {**arg_params, data_name: first.data[0]},
                    grad_req="null", aux_states=dict(aux_params))
    collected: Dict[str, list] = {n: [] for n in node_names}
    batch = first
    for _ in range(num_calib_batches):
        outs_nd = ex.forward(is_train=False, **{data_name: batch.data[0]})
        for n, o in zip(node_names, outs_nd):
            if calib_mode == "entropy":
                collected[n].append(o.asnumpy())
            else:
                collected[n].append(torch.max(torch.abs(o._data)))
        try:
            batch = next(calib_data)
        except StopIteration:
            break
    if calib_mode != "entropy":
        return {n: float(torch.max(torch.stack(c)).item())
                for n, c in collected.items()}
    return {n: _kl_threshold(onp.concatenate([c.ravel() for c in chunks]))
            for n, chunks in collected.items()}


# ---------------------------------------------------------------------------
# graph rewrite
# ---------------------------------------------------------------------------
_QUANTIZABLE = {"FullyConnected": "_contrib_quantized_fully_connected",
                "Convolution": "_contrib_quantized_conv"}


def quantize_model(sym, arg_params: Dict[str, NDArray],
                   aux_params: Dict[str, NDArray],
                   data_names=("data",), excluded_sym_names=(),
                   calib_mode: str = "none", calib_data=None,
                   num_calib_batches: int = 4, quantized_dtype="int8",
                   ctx=None):
    """Rewrite FullyConnected/Convolution to int8 (reference
    ``quantize_model``). Returns (qsym, qarg_params, aux_params); the
    int8 weights sit beside the float ones' device."""
    if quantized_dtype != "int8":
        raise MXNetError("only int8 quantization is supported")
    from ..symbol.symbol import _Node, Symbol

    excluded = set(excluded_sym_names)
    targets = [n for n in sym._topo()
               if n.op in _QUANTIZABLE and n.name not in excluded]

    # calibrate activation ranges at each target's data input
    th_dict: Dict[str, float] = {}
    if calib_mode in ("naive", "entropy") and calib_data is not None:
        input_names = {node.name: node.inputs[0][0].name
                       for node in targets}
        uniq = sorted({v for v in input_names.values()
                       if v not in data_names})
        ths = calib_thresholds(sym, arg_params, aux_params, calib_data,
                               data_names[0], uniq, calib_mode,
                               num_calib_batches, ctx)
        for node_name, inp in input_names.items():
            if inp in ths:
                th_dict[node_name] = ths[inp]

    qarg_params = dict(arg_params)
    memo: Dict[int, _Node] = {}

    def clone(node: _Node) -> _Node:
        if id(node) in memo:
            return memo[id(node)]
        new_inputs = [(clone(p), i) for p, i in node.inputs]
        if node.op in _QUANTIZABLE and node.name not in excluded:
            wname = node.inputs[1][0].name
            w = arg_params[wname]
            qw, w_thr = _quantize_weight(w.asnumpy())
            # int8 codes under a new arg name: a weight shared with a
            # float consumer keeps its float entry
            qwname = wname + "_quantized"
            qarg_params[qwname] = nd.array(qw, ctx=w.context, dtype="int8")
            qw_var = _Node("null", qwname, {}, [])
            new_inputs = [new_inputs[0], (qw_var, 0)] + new_inputs[2:]
            attrs = dict(node.attrs)
            attrs["w_thr"] = w_thr
            if node.name in th_dict:
                attrs["calib_min"] = -th_dict[node.name]
                attrs["calib_max"] = th_dict[node.name]
            new = _Node(_QUANTIZABLE[node.op], node.name + "_quantized",
                        attrs, new_inputs)
        else:
            new = _Node(node.op, node.name, dict(node.attrs), new_inputs)
        memo[id(node)] = new
        return new

    qsym = Symbol([(clone(n), i) for n, i in sym._entries])
    # drop the args the rewritten graph no longer reads (float copies of
    # weights only quantized layers used)
    live = set(qsym.list_inputs())
    qarg_params = {k: v for k, v in qarg_params.items() if k in live}
    return qsym, qarg_params, dict(aux_params)


def quantize_net(network, calib_data=None, calib_mode="naive",
                 excluded_sym_names=(), num_calib_batches=4, ctx=None,
                 data_shape=None):
    """Quantize a Gluon HybridBlock → SymbolBlock (reference
    ``quantize_net``): export, rewrite, reload. The parameters stay on
    the network's device."""
    from .. import gluon
    from .. import symbol as msym
    from ..model import load_params

    dev = next(iter(network.collect_params().values())).data().context
    with tempfile.TemporaryDirectory(prefix="mxtpu_quant_") as tmp:
        prefix = os.path.join(tmp, "net")
        network.export(prefix)
        sym = msym.load(prefix + "-symbol.json")
        arg_params, aux_params = load_params(prefix, 0, ctx=dev)
    qsym, qargs, auxs = quantize_model(
        sym, arg_params, aux_params, calib_mode=calib_mode,
        calib_data=calib_data, excluded_sym_names=excluded_sym_names,
        num_calib_batches=num_calib_batches, ctx=ctx)
    return gluon.SymbolBlock(qsym, [msym.var("data")],
                             params={**qargs, **auxs}, ctx=dev)
