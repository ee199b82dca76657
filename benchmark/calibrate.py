"""Readings from which a cell's correctness limits are set.

    python3 benchmark/calibrate.py --workload corner-train \
        --seeds 101,102,103 --controls fp8,bf16table --faults half_batch \
        --out chiprun_out/calib_corner-train.jsonl

For each seed, in one process: the program's checked steps (train: the
last steps of a run's set-up) or checked views (render) as a run of the
cell makes them, then the plain reference, and each control (the reference in a lower precision put in
the program's place: `fp8` MLP operands and gradients, `bf16table`
table values) and each planted fault (`half_batch`: the reference on
the first half of every batch, its mean over that half). Every line
printed and written holds one seed's readings of one side against the
reference. The benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CONTROLS = {"fp8": {"operands": "fp8"}, "bf16table": {"table": "bfloat16"}}


def calibrate(cell, seed: int, controls, faults, device="cuda") -> list:
    from benchmark.harness import drive

    run = drive.make_run(cell, seed, device)
    t0 = time.perf_counter()
    run.setup()
    about = {}
    if cell.traffic["loop"] == "render":
        run.render_checked()
        about["fit_rms"] = run.fit_rms
    else:
        about["rays"] = [b["rays"].origins.shape[0]
                         for b in run.views.recorded]
    t_prog = time.perf_counter() - t0
    run.free_program()
    t0 = time.perf_counter()
    ref = run.reference()
    t_ref = time.perf_counter() - t0
    if cell.traffic["loop"] == "render":
        about["samples"] = [n for _, _, n in ref]
    lines = [{"seed": seed, "side": "program", **run.readings(ref),
              "program_s": t_prog, "reference_s": t_ref, **about}]
    for name in controls:
        other = run.reference(precision=drive.rngp.Precision(**CONTROLS[name]))
        lines.append({"seed": seed, "side": f"control:{name}",
                      **run.readings(ref, run.as_program(other))})
    for name in faults:
        if name != "half_batch" or cell.traffic["loop"] != "train":
            raise ValueError(f"no fault {name!r} for this cell")
        other = run.reference(half_batch=True)
        lines.append({"seed": seed, "side": f"fault:{name}",
                      **run.readings(ref, run.as_program(other))})
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--controls", default=",".join(CONTROLS))
    p.add_argument("--faults", default="")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)

    import torch

    from benchmark.harness import cells

    if not torch.cuda.is_available():
        print("calibration runs on the card", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    cell = cells.find_cell(args.workload)
    controls = [c for c in args.controls.split(",") if c]
    faults = [f for f in args.faults.split(",") if f]
    out = open(args.out, "a") if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            for line in calibrate(cell, seed, controls, faults):
                line["workload"] = cell.name
                print(json.dumps(line), flush=True)
                if out:
                    out.write(json.dumps(line) + "\n")
                    out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
