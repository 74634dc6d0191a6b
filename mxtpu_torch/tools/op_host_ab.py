"""Host time of one call of the hand kernels' wrappers, in two checkouts
in turn, and the dispatcher's cost of an operator defined either way.

    python -m mxtpu_torch.tools.op_host_ab --trees build/parent . . build/parent

Each tree (a checkout holding ``chip_smoke.py`` and ``mxtpu_torch``) runs
in a process of its own, in the order given: it builds its kernels,
then times the host's cost of one ``flash_attention`` forward call at
``chip_smoke.py``'s kernel shapes "llama3_8b" (causal, (1, 32, 2048,
128) bf16 q, 8 kv heads) and "single" (one query row), and of one
``conv3x3`` call at the conv shape "experiment" (128 × 14 × 14 × 256 →
256): ``tools.timing.host_ms`` over 100 calls from an idle card, the
median of 9 windows (and the least and most). Prints one JSON line a
tree with the card (``nvidia-smi`` name and power limit).

Then, in this process, one line with the dispatcher's µs a call of an
operator whose CUDA implementation only allocates its output, defined
with ``torch.library.custom_op`` and with ``torch.library.Library``
(``define`` + ``impl``), beside the plain Python call (medians of 9
windows of 2,000 calls), and one line with the µs of the pieces of a
flash forward call in this process's tree (the wrapper, the operator,
the launch, the checks, the allocation, the device context, the
stream query).

Runs on the card only; compare two trees only within one call, in turns
(A, B, B, A).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

_RUN = r"""
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as c
from mxtpu_torch.ops import _build, attention as A, conv as C
from mxtpu_torch.tools.timing import host_ms
torch.backends.cuda.matmul.allow_tf32 = False
_build.load_kernels()
gen = torch.Generator(device="cuda").manual_seed(c.SEED)

def spread(fn):
    for _ in range(20):
        fn()
    xs = sorted(host_ms(fn, reps=100) for _ in range(9))
    return {"median": xs[4], "min": xs[0], "max": xs[-1]}

out = {"card": c.nvidia_smi()}
for name, b, hq, hkv, sq, skv, d, causal, strided in c.KERNEL_SHAPES:
    if name in ("llama3_8b", "single"):
        q, k, v, _ = c.shape_inputs(gen, b, hq, hkv, sq, skv, d, strided)
        out["flash_" + name] = spread(
            lambda: A.flash_attention(q, k, v, causal=causal))
for name, b, h, w, ci, co in c.CONV_SHAPES:
    if name == "experiment":
        x = torch.randn((b, h, w, ci), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        wt = torch.randn((3, 3, ci, co), generator=gen, device="cuda",
                         dtype=torch.bfloat16)
        out["conv_" + name] = spread(lambda: C.conv3x3(x, wt))
print(json.dumps(out))
"""


def _median_us(fn, args, n=2000, windows=9):
    for _ in range(200):
        fn(*args)
    xs = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(n):
            fn(*args)
        xs.append((time.perf_counter() - t0) / n * 1e6)
    return sorted(xs)[len(xs) // 2]


def dispatch_costs():
    """µs a call: a plain function, a ``custom_op`` and a
    ``Library``-defined operator, each only allocating its output."""
    import torch

    def plain(x, causal, scale):
        return torch.empty_like(x)

    plain.__annotations__ = {"x": torch.Tensor, "causal": bool,
                             "scale": float, "return": torch.Tensor}
    custom = torch.library.custom_op(
        "mxtpu_torch_ab::custom", mutates_args=(), device_types="cuda")(
        plain)
    lib = torch.library.Library("mxtpu_torch_ab", "FRAGMENT")
    lib.define("direct(Tensor x, bool causal, float scale) -> Tensor")
    lib.impl("direct", plain, "CUDA")
    direct = torch.ops.mxtpu_torch_ab.direct.default
    x = torch.empty((1, 32, 2048, 128), device="cuda", dtype=torch.bfloat16)
    return {name + "_us": _median_us(fn, (x, True, 0.1))
            for name, fn in (("plain", plain), ("custom_op", custom),
                             ("library", direct))}


def breakdown():
    """µs a call of the pieces of one flash forward call at the
    "single" shape in this tree (the host's costs, the card idle):
    the wrapper, the operator, the launch it runs, and the launch's
    own steps."""
    import contextlib

    import torch

    from mxtpu_torch.ops import _build, attention as A
    _build.load_kernels()
    q = torch.randn((1, 2, 1, 128), device="cuda", dtype=torch.bfloat16)
    k = torch.randn((1, 1, 1, 128), device="cuda", dtype=torch.bfloat16)
    dev = q.device

    def device_context():
        with torch.cuda.device(dev):
            pass

    def null_context():
        with contextlib.nullcontext():
            pass

    out = {}
    for name, fn, args in (
            ("flash_attention", lambda: A.flash_attention(q, k, k,
                                                          causal=True), ()),
            ("flash_attention_fwd", lambda: A.flash_attention_fwd(
                q, k, k, causal=True), ()),
            ("operator", A._FWD_OP, (q, k, k, True, 0.1)),
            ("launch", A._fwd_launch, (q, k, k, True, 0.1, False)),
            ("check_kernel_args", A._check_kernel_args, (q, k, k)),
            ("empty", lambda: torch.empty((1, 2, 1, 128), device=dev,
                                          dtype=torch.bfloat16), ()),
            ("device_context", device_context, ()),
            ("null_context", null_context, ()),
            ("current_stream", lambda: torch.cuda.current_stream(
                dev).cuda_stream, ())):
        torch.cuda.synchronize()
        out[name + "_us"] = _median_us(fn, args, n=500)
        torch.cuda.synchronize()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", default=["."],
                    help="checkouts to run, in order")
    args = ap.parse_args(argv)
    for tree in args.trees:
        env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
        res = subprocess.run([sys.executable, "-c", _RUN], cwd=tree,
                             env=env, capture_output=True, text=True,
                             timeout=600)
        if res.returncode:
            sys.stderr.write(res.stderr[-4000:])
            return res.returncode
        line = res.stdout.strip().splitlines()[-1]
        print(json.dumps({"tree": tree, **json.loads(line)}), flush=True)
    print(json.dumps({"dispatch": dispatch_costs()}), flush=True)
    print(json.dumps({"breakdown": breakdown()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
