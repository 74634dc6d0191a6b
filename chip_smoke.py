#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mxtpu_torch) once on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed as one JSON object per line; any failure raises
and the script exits non-zero without a result line:

1. card: ``nvidia-smi`` name and power limit, TF32 settings, and the
   build of every CUDA kernel from ``mxtpu_torch/ops/csrc`` (seconds,
   and ptxas' register/spill report).
2. kernel: the flash-attention forward kernel against its plain version
   (``blockwise_attention`` in f32 on the same bf16 values) at the main
   path's shape (llama3_8b: b=1, hq=32, hkv=8, s=2048, d=128, causal), a
   ragged one (b=2, hq=hkv=4, sq=1000, skv=777, d=64, non-causal) and a
   few edge shapes, within ``atol=rtol=2e-2`` (bf16 output rounding,
   about 2^-8 relative, plus a different summation order). Times: the
   kernel, ``scaled_dot_product_attention`` as a yardstick only (the
   port never calls it), and the plain version; the bound is computed
   from the shapes.
3. slice: ``CONFIGS["llama3_8b"]`` at bf16 params (8.03 B parameters,
   all 32 layers) with random weights from a seeded generator on the
   card. (a) ``forward`` on (1, 2048) tokens: finite f32 logits, 32
   kernel launches, and the relative distance to the same model's
   ``attn_impl="dense"`` logits within its bound. (b) greedy
   ``generate`` answering 4 requests (prompt 128, 32 new tokens each),
   twice, with the same tokens both times.

Then the ``kernels`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Exits non-zero with no result when no
CUDA card is visible or when the package is not beside the script.
"""
import json
import math
import subprocess
import sys
import time
from dataclasses import replace

TOL = 2e-2                 # kernel vs plain, atol = rtol, bf16 output
LOGITS_REL_BOUND = 5e-2    # ||flash - dense|| / ||dense|| at full width
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core peak
PEAK_HBM_BYTES = 3.35e12   # H100 SXM HBM3 bytes/s
SEED = 0

# (name, b, hq, hkv, sq, skv, d, causal, strided)
KERNEL_SHAPES = [
    ("llama3_8b", 1, 32, 8, 2048, 2048, 128, True, False),
    ("ragged", 2, 4, 4, 1000, 777, 64, False, False),
    ("single", 1, 2, 1, 1, 1, 128, True, False),
    ("causal_sq<skv", 1, 4, 2, 65, 130, 64, True, False),
    ("causal_sq>skv", 1, 4, 4, 130, 65, 128, True, False),
    ("strided_bshd", 2, 8, 2, 100, 100, 128, True, True),
    ("short_q", 1, 2, 2, 3, 200, 64, False, False),
]


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps, warmup=2):
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def attention_bound_ms(b, hq, hkv, sq, skv, d, causal):
    """(ms, 'operations' | 'bytes'): the least time for this call's work.
    Operations: 2 matmuls x 2 flops over every visible (q, k) pair;
    bytes: q, k, v read once and o written once, in bf16."""
    if causal:
        m = min(sq, skv)
        pairs = m * (m + 1) // 2 + max(sq - skv, 0) * skv
    else:
        pairs = sq * skv
    flops = 4 * d * hq * b * pairs
    nbytes = 2 * d * b * (2 * hq * sq + 2 * hkv * skv)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def sdpa_call(q, k, v, causal, scale):
    """One PyTorch call computing the same function, as a yardstick."""
    import torch.nn.functional as F
    kw = {"enable_gqa": True} if q.shape[1] != k.shape[1] else {}
    return lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, scale=scale, **kw)


def kernel_phase():
    import torch
    from mxtpu_torch.ops import attention as A
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for name, b, hq, hkv, sq, skv, d, causal, strided in KERNEL_SHAPES:
        def rand(h, s):
            shape = (b, s, h, d) if strided else (b, h, s, d)
            t = torch.randn(shape, generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            return t.transpose(1, 2) if strided else t
        q, k, v = rand(hq, sq), rand(hkv, skv), rand(hkv, skv)
        scale = 1.0 / math.sqrt(d)
        out = A.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref = A.blockwise_attention(q.float(), k.float(), v.float(),
                                    causal=causal)
        err = (out.float() - ref).abs().max().item()
        ok = torch.allclose(out.float(), ref, atol=TOL, rtol=TOL)
        row = {"phase": "kernel", "kernel": "flash_attention_fwd",
               "shape": name, "b": b, "hq": hq, "hkv": hkv, "sq": sq,
               "skv": skv, "d": d, "causal": causal, "strided": strided,
               "max_abs_err": err, "tol": TOL, "ok": ok}
        if name in ("llama3_8b", "ragged"):
            bound, bound_by = attention_bound_ms(b, hq, hkv, sq, skv, d,
                                                 causal)
            row.update(
                kernel_ms=time_ms(lambda: A.flash_attention(
                    q, k, v, causal=causal), reps=50),
                library_ms=time_ms(sdpa_call(q, k, v, causal, scale),
                                   reps=50),
                plain_ms=time_ms(lambda: A.blockwise_attention(
                    q, k, v, causal=causal), reps=3, warmup=1),
                bound_ms=bound, bound_by=bound_by)
            row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
        emit(row)
        if not (ok and math.isfinite(err)):
            raise AssertionError(f"flash kernel disagrees with its plain "
                                 f"version at {name}: max err {err}")
        rows.append(row)
    return rows


def slice_phase():
    import torch
    from mxtpu_torch.models import llama
    from mxtpu_torch.ops import attention as A
    cfg = replace(llama.CONFIGS["llama3_8b"], param_dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    params = llama.init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params["layers"].values()) + sum(
        p.numel() for k, p in params.items() if k != "layers")
    emit({"phase": "init", "config": "llama3_8b", "params": n_params,
          "param_dtype": "bfloat16", "n_layers": cfg.n_layers,
          "seconds": time.perf_counter() - t0})

    with torch.inference_mode():
        tokens = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen,
                               device="cuda")
        torch.cuda.reset_peak_memory_stats()
        A.flash_attention_fwd.launches = 0
        t0 = time.perf_counter()
        logits = llama.forward(cfg, params, tokens)
        torch.cuda.synchronize()
        fwd_s = [time.perf_counter() - t0]
        launches = A.flash_attention_fwd.launches
        t0 = time.perf_counter()        # again, with cuBLAS warm
        llama.forward(cfg, params, tokens)
        torch.cuda.synchronize()
        fwd_s.append(time.perf_counter() - t0)
        dense = llama.forward(replace(cfg, attn_impl="dense"), params,
                              tokens)
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(logits).all())
        rel = ((logits - dense).norm() / dense.norm()).item()
        agree = (logits.argmax(-1) == dense.argmax(-1)).float().mean().item()
        emit({"phase": "forward", "tokens": list(tokens.shape),
              "logits": list(logits.shape), "dtype": str(logits.dtype),
              "finite": finite, "flash_launches": launches,
              "seconds": fwd_s, "rel_err_vs_dense": rel,
              "rel_err_bound": LOGITS_REL_BOUND, "argmax_agree": agree,
              "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
        if not (finite and logits.dtype == torch.float32
                and tuple(logits.shape) == (1, 2048, cfg.vocab_size)):
            raise AssertionError("forward logits are not finite f32 "
                                 "(1, 2048, vocab)")
        if launches != cfg.n_layers:
            raise AssertionError(f"forward launched the flash kernel "
                                 f"{launches} times, not {cfg.n_layers}")
        if not rel <= LOGITS_REL_BOUND:
            raise AssertionError(f"flash vs dense logits {rel} > "
                                 f"{LOGITS_REL_BOUND}")
        del logits, dense

        prompts = torch.randint(0, cfg.vocab_size, (4, 128), generator=gen,
                                device="cuda")
        runs = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = llama.generate(cfg, params, prompts, 32)
            torch.cuda.synchronize()
            runs.append((out, time.perf_counter() - t0))
        (out, t1), (out2, t2) = runs
        new = out[:, 128:]
        emit({"phase": "generate", "requests": 4, "prompt_len": 128,
              "new_tokens": 32, "seconds": [t1, t2],
              "tok_per_s": [4 * 32 / t1, 4 * 32 / t2],
              "reproducible": bool(torch.equal(out, out2)),
              "first_tokens": new[:, :8].tolist()})
        if not (tuple(out.shape) == (4, 160)
                and torch.equal(out[:, :128], prompts)
                and bool(((new >= 0) & (new < cfg.vocab_size)).all())):
            raise AssertionError("generate returned malformed tokens")
        if not torch.equal(out, out2):
            raise AssertionError("greedy generate is not reproducible")
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is visible", file=sys.stderr)
        return 1
    import mxtpu_torch  # noqa: F401  (fails when run outside the repo)
    from mxtpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    emit({"phase": "card", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})
    _build.load_kernels()
    info = _build.build_info()
    emit({"phase": "build", "built": info["built"],
          "seconds": info["seconds"], "path": info["path"],
          "ptxas": [ln.strip() for ln in str(info["ptxas"]).splitlines()
                    if any(w in ln for w in ("entry function", "registers",
                                             "spill"))]})

    rows = {r["shape"]: r for r in kernel_phase()}
    torch.cuda.empty_cache()
    launches = slice_phase()

    main_row = rows["llama3_8b"]
    emit({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "mxtpu_torch/ops/csrc/flash_attn_fwd.cu",
        "replaces": "mxtpu/ops/attention.py:157",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}]})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
