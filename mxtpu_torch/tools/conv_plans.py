"""Every tile plan of the conv3x3 kernel at the shapes ``chip_smoke.py``
times, on one NVIDIA card: the data behind ``ops.conv._conv_plan``.

    python -m mxtpu_torch.tools.conv_plans

For each shape and each plan (BN in {64, 128} output channels a tile,
K split in {1, 2} CTAs a tile): the device time of one launch, the
median of 5 windows of 20 launches queued behind a spin of the card (so
the host's cost of a call is not timed), after a check against
``conv3x3_plain`` within ``CONV_TOL``; and which plan ``_conv_plan``
picks. The shapes are ``chip_smoke.py``'s five and thin grids of a few
tiles with K from 9 to 72 stages, where the split and the tile width
trade CTAs against each CTA's work. Its rows are the evidence for the
rule, so run it again whenever ``_conv_plan`` changes. One JSON object
a line; the first names the card and its power limit.
"""
from __future__ import annotations

import json

import torch

from ..ops import conv
from .resnet_shape_experiment import (CONV_TOL, conv_bound_ms, conv_inputs,
                                      nvidia_smi)
from .timing import median_ms

# (name, B, H, W, C, O): the shape experiment's and ResNet-50's 3x3 convs
# at batch 32, and a ragged one; then thin grids (tiles at BN 128, stages)
SHAPES = [
    ("experiment", 128, 14, 14, 256, 256),
    ("resnet50_56", 32, 56, 56, 64, 64),
    ("resnet50_28", 32, 28, 28, 128, 128),
    ("resnet50_7", 32, 7, 7, 512, 512),
    ("ragged", 3, 5, 9, 64, 72),
    ("7x7_c256", 32, 7, 7, 256, 256),      # 26 tiles, 36 stages
    ("7x7_c128", 32, 7, 7, 128, 128),      # 13 tiles, 18 stages
    ("7x7_c128_o512", 32, 7, 7, 128, 512),  # 52 tiles, 18 stages
    ("7x7_b8", 8, 7, 7, 512, 512),         # 16 tiles, 72 stages
    ("ragged_c512", 3, 5, 9, 512, 72),     # 2 tiles, 72 stages
    ("ragged_c192", 3, 5, 9, 192, 136),    # 4 tiles, 27 stages
]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("conv_plans needs a CUDA card")
    print(json.dumps({"card": nvidia_smi(), "torch": torch.__version__}),
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, *shape in SHAPES:
        x, w = conv_inputs(shape, gen)
        ref = conv.conv3x3_plain(x.float(), w.float())
        chosen = conv._conv_plan(*shape)
        row = {"shape": name, "bhwco": shape,
               "bound_ms": conv_bound_ms(*shape)[0],
               "chosen": f"{chosen.bn}/{chosen.split}", "ms": {}}
        for bn in (64, 128):
            for split in (1, 2):
                plan = chosen._replace(bn=bn, split=split,
                                       n_tiles=-(-shape[4] // bn))
                y = conv._launch(x, w, plan)
                torch.cuda.synchronize()
                if not torch.allclose(y.float(), ref, atol=CONV_TOL,
                                      rtol=CONV_TOL):
                    raise AssertionError(f"plan {bn}/{split} disagrees with "
                                         f"the plain version at {name}")
                row["ms"][f"{bn}/{split}"] = median_ms(
                    lambda: conv._launch(x, w, plan), reps=20)
        row["best"] = min(row["ms"], key=row["ms"].get)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
