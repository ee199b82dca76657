"""The stochastic corner gradient's quality cost on one CUDA card.

Trains chip_smoke.py's phase-4 configuration (Stage1Config defaults: tet
corner L16 F2 T2^19, SG head, bf16 MLPs, 128^3 grid, 2^18 samples) for
300 steps on its 4 fixture views of 256^2 (chip_smoke.paired_run),
`--runs` times with the exact
table gradient and as often with grad_mode "stochastic", every run from
the same seed, and prints each run's final eval PSNR, each mode's mean
and spread, and the difference of the means, with the card's name and
power limit. Every run draws the same batches (the loader's generator
reset to its seed); with `--streams`, run i of both modes draws its own
stream (the generator at seed + i). Runs of one mode on one stream
differ only by the order of the atomic adds (table gradients,
composites), which 300 steps amplify.

    python3 tools/probe_stochastic_quality.py [--runs 3] [--streams]
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    import torch

    import chip_smoke

    argv = sys.argv[1:] if argv is None else argv
    runs = int(argv[argv.index("--runs") + 1]) if "--runs" in argv else 3
    streams = "--streams" in argv
    if not torch.cuda.is_available():
        print("probe_stochastic_quality: no CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    print(card)
    views = chip_smoke.FixtureViews()
    psnrs = {"exact": [], "stochastic": []}
    for i in range(runs):
        for mode in psnrs:
            psnrs[mode].append(chip_smoke.paired_run(
                views, mode, stream=i if streams else 0))
            print(f"run {i} {mode}: eval PSNR {psnrs[mode][-1]:.4f} dB",
                  flush=True)
    for mode, vals in psnrs.items():
        print(f"{mode}: mean {np.mean(vals):.4f} dB, min {min(vals):.4f}, "
              f"max {max(vals):.4f} over {runs} runs [{card}]")
    cost = np.mean(psnrs["exact"]) - np.mean(psnrs["stochastic"])
    print(f"the stochastic mode costs {cost:.4f} dB on the means [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
