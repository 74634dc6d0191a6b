"""The serve engine's decode dispatch, host ms, in two checkouts in turn.

    python -m mxtpu_torch.tools.dispatch_ab --trees . build/parent . build/parent
    python -m mxtpu_torch.tools.dispatch_ab --trees build/parent . --profile 15

Each tree (a checkout holding ``chip_smoke.py`` and ``mxtpu_torch``) runs
in a process of its own, in the order given: llama3_8b at full width and
depth in bf16 with ``chip_smoke.py``'s seeded random weights, then
``chip_smoke.dense_serve_run`` of that tree over ``bench.py``'s serve
stream (48 requests, 16 slots, max_len 768, every bucket warmed first).
Prints one JSON line a run: the tree, the card (``nvidia-smi`` name and
power limit), tok/s, p50/p99 inter-token ms and the decode dispatch's
host ms (``span_serve_decode_dispatch_ms`` over the timed run: mean, p50,
p99). With ``--profile N`` the run is under ``cProfile`` (which slows
every Python call, so its times are not the dispatch's) and the line
also has the N functions with the most own and the most cumulative
time: calls, and µs a call.
Runs on the card only; compare two trees only within one call, in turns
(A, B, A, B).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_RUN = r"""
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as c
from dataclasses import replace
from mxtpu_torch.models import llama
cfg = replace(llama.CONFIGS["llama3_8b"], param_dtype=torch.bfloat16)
gen = torch.Generator(device="cuda").manual_seed(c.SEED)
params = llama.init_params(cfg, gen, device="cuda")
top = {}
with torch.inference_mode():
    if PROFILE:
        import cProfile, pstats
        prof = cProfile.Profile()
        prof.enable()
    row, invariant, _ = c.dense_serve_run(cfg, params, c.serve_requests(cfg))
    if PROFILE:
        prof.disable()
        st = pstats.Stats(prof).stats
        for kind, col in (("own", 2), ("cumulative", 3)):
            top[kind] = [
                [f"{f.split('/')[-1]}:{line}({fn})", v[1], v[col] / v[1] * 1e6]
                for (f, line, fn), v in sorted(
                    st.items(), key=lambda kv: -kv[1][col])[:PROFILE]]
print(json.dumps({"card": c.nvidia_smi(), "tok_per_s": row["tok_per_s"],
                  "p50_token_ms": row["p50_token_ms"],
                  "p99_token_ms": row["p99_token_ms"],
                  "decode_dispatch_host_ms": row["decode_dispatch_host_ms"],
                  "compile_count": row["compile_count"],
                  "scheduling_invariant": invariant, "profile": top}))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", default=["."],
                    help="checkouts to run, in order")
    ap.add_argument("--profile", type=int, default=0,
                    help="run under cProfile and report the N functions "
                    "with the most own time")
    args = ap.parse_args(argv)
    run = f"PROFILE = {args.profile}\n" + _RUN
    for tree in args.trees:
        env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
        res = subprocess.run([sys.executable, "-c", run], cwd=tree, env=env,
                             capture_output=True, text=True, timeout=900)
        if res.returncode:
            sys.stderr.write(res.stderr[-4000:])
            return res.returncode
        line = res.stdout.strip().splitlines()[-1]
        print(json.dumps({"tree": tree, **json.loads(line)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
