#!/usr/bin/env python3
"""K1's stochastic form (csrc/hashgrid_encode.cu
qf_hashgrid_encode_bwd_stochastic) on one NVIDIA card at every feature
count it takes (F = 1, 2, 4, 8; L16, T2^19, the stage-1 grid's
resolutions), tet and cube, on 2^18 uniform points and on 2^18
ray-ordered slots whose last eighth is zero-cotangent padding: its
picks and sum against the plain version (chip_smoke.stochastic_case),
its time beside the bound, the zeroing of its gradient, its plain
version and index_add_ of the picked rows; with `--baseline DIR`, the
same kernel as another checkout at DIR builds it (e.g. a parent commit
unpacked with `git archive`), timed in turns with this one.

    python3 tools/probe_stochastic_grad.py [--baseline DIR]   # ~1 min
"""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_stochastic_grad: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import (
        Baseline,
        card_line,
        ray_ordered_points,
        stochastic_case,
    )
    from quadraturefields_tpu_torch.ops import hashgrid as hg

    args = sys.argv[1:] if argv is None else argv
    baseline = (Baseline(args[args.index("--baseline") + 1])
                if "--baseline" in args else None)
    card = card_line()
    print(card)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    n = 1 << 18
    inputs = {"uniform": torch.rand((n, 3), generator=g, device=dev),
              "ray_ordered": ray_ordered_points(torch, g, n, n // 8)}
    rows = []
    for f in (1, 2, 4, 8):
        for name, x in inputs.items():
            for interp in ("tet", "cube"):
                cfg = dataclasses.replace(
                    hg.HashGridConfig.from_max_resolution(
                        4096, n_levels=16, n_features=f,
                        log2_hashmap_size=19, interp=interp),
                    grad_mode="stochastic")
                cot = torch.randn((n, cfg.output_dim), generator=g,
                                  device=dev)
                if name == "ray_ordered":
                    cot[n - n // 8:] = 0.0
                entry = stochastic_case(
                    torch, f"F{f} {interp} {name}", x, cot, cfg, card,
                    baseline)
                rows.append(dict(F=f, interp=interp, inputs=name, **entry))
    print(json.dumps({"stochastic_grad": rows, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
