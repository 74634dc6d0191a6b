"""``chip_smoke.py``'s ``gateway`` comparison of disaggregated TTFT, one-shot
against streamed, repeated in each checkout given, so that two commits
are compared on one NVIDIA card.

    python3 mxtpu_torch/tools/disagg_ab.py [--rounds 3] ROOT [ROOT ...]

Each ROOT is a checkout holding ``chip_smoke.py`` and ``mxtpu_torch``;
give them in the order to run them (parent, change, change, parent).
Each runs in a fresh interpreter that imports that checkout's package
and script, builds ``CONFIGS["llama3_8b"]`` with bf16 params at all 32
layers from the script's seed, as its ``slice_phase`` does, and then,
``--rounds`` times, runs the script's own ``disagg_mode`` on the
requests of its ``gateway_phase`` as that phase does: the one-shot and
streamed backends built together, one warm request each, then
DISAGG_TIMED timed requests interleaved between them. One JSON object a
round: the checkout, each mode's TTFTs, median, worker span and stage
medians, the paired differences, and whether streamed is below
one-shot (the phase's check), with the card's name and power limit.

Run it by path, not with ``-m``: the package it measures is the
checkout's. Unlike the whole script, nothing else has run on the card
before the first round.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from dataclasses import replace


def _one(root: str, rounds: int) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import torch
    import chip_smoke as cs
    from mxtpu_torch.models import llama
    card = cs.nvidia_smi()
    cfg = replace(llama.CONFIGS["llama3_8b"], param_dtype=torch.bfloat16)
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(cs.SEED),
        device="cuda")
    reqs = cs.disagg_requests(cfg)
    for k in range(rounds):
        row = {"root": root, "round": k, "card": card}
        modes = cs.disagg_mode(
            cfg, params, reqs[1:], {"one_shot": (0, cs.DISAGG_WIRE_MBPS),
                                    "streamed": (cs.DISAGG_CHUNK,
                                                 cs.DISAGG_WIRE_MBPS)},
            max_slots=2, max_len=cs.DISAGG_MAX_LEN, warm=reqs[0])
        torch.cuda.empty_cache()
        for name, (_, _, r) in modes.items():
            row[name] = {n: r[n] for n in (
                "ttft_ms", "median_ttft_ms", "worker_span_ms",
                "stages_median_ms")}
        row["paired"] = cs.disagg_pairs(modes["one_shot"][1],
                                        modes["streamed"][1])
        row["streamed_below_one_shot"] = (
            row["streamed"]["median_ttft_ms"]
            < row["one_shot"]["median_ttft_ms"])
        print(json.dumps(row), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        _one(args.roots[0], args.rounds)
        return 0
    rc = 0
    for root in args.roots:
        rc |= subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one",
             "--rounds", str(args.rounds), root], timeout=1800).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
