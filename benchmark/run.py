"""Run one cell of the H100 benchmark of quadraturefields_tpu_torch once.

    python3 benchmark/run.py --workload corner-train --seed 7 \
        --seconds 10 --trace 0

(or `python3 -m benchmark.run ...`) from the root of a checkout on a
machine with the card(s) the cell asks for. Set-up builds the cell's
trainer from its configuration file, feeds it the traffic file's
fixture views and seeded weights, and warms it up; the window then
drives `Stage1Trainer.train_one_step` or `render_view` for `--seconds`.
With `--trace 1` a traced slice follows the window and the per-layer
metrics are reported instead of the end-to-end ones. Once the program's
state is freed, the plain reference (benchmark/reference/) checks what
the window produced. The last line of standard output is the result's
JSON; the numbers compared, each beside its limit, are the last lines
of standard error and the result's last key.

Exits 2 without a result when the card(s) are missing, and 3 when a
JAX module was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "quadraturefields_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def pin_cache_dirs() -> None:
    """Compile caches at fixed paths inside the checkout; the port's
    own kernels build into build/kernels there by themselves."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    # one host thread for CPU tensor work: the dispatch thread and the
    # autograd engine's are the run's load
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def execute(args, require_card: bool = True, device: str = "cuda"):
    """Run the cell and return its result (the last line's object);
    exits 2 without one where the card(s) are missing."""
    pin_cache_dirs()
    import torch

    from benchmark.harness import cells, check, drive

    cell = cells.find_cell(args.workload)
    if require_card and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < cell.chips):
        log(f"{cell.name} needs {cell.chips} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        sys.exit(2)
    torch.set_num_threads(1)
    run = drive.make_run(cell, args.seed, device)
    run.marks[0] = ("imports", T_START)
    run.mark("imports and CUDA context")
    run.setup()
    setup_s = time.perf_counter() - T_START
    log(f"set-up phases: {run.phases()}")
    win = run.window(args.seconds)
    log(f"window: {win.units} {cell.traffic['loop']} units in "
        f"{win.seconds:.4f} s, {win.rays} rays, {win.samples} samples "
        f"composited, peak {win.memory_peak_bytes} bytes; set-up "
        f"{setup_s:.3f} s")
    log(f"window blocks: {run.blocks()}")
    if args.trace:
        sl = run.trace_slice()
        per_unit = win.seconds / max(win.units, 1)
        log(f"traced slice: {sl.units} units in {sl.wall_s:.4f} s "
            f"({sl.wall_s / sl.units * 1e3:.3f} ms a unit against "
            f"{per_unit * 1e3:.3f} untraced: tracing costs "
            f"{100 * (sl.wall_s / sl.units / per_unit - 1):.1f}%), "
            f"{len(sl.kernels)} kernels, busy {sl.busy_s():.4f} s")
        for cls, sec in sl.classes().items():
            log(f"  {cls}: {sec / sl.units * 1e3:.4f} ms a unit")
    run.free_program()
    ref = run.reference()
    readings = run.readings(ref)
    correct, checks = check.judge(readings, cell.limits)

    ctx = types.SimpleNamespace(run=run, cell=cell, window=win,
                                setup_s=setup_s, slice=run.slice,
                                reference=ref, grid=run.grid)
    wanted = cell.per_layer if args.trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = cells.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else device),
           "count": cell.chips,
           "memory_peak_bytes": int(win.memory_peak_bytes)}
    result = {"correct": bool(correct), "attempted": int(win.units),
              "failed": 0, "metrics": metrics, "device": dev}
    if args.trace:
        sl = run.slice
        dev["busy_s"] = sl.busy_s()
        dev["window_s"] = sl.wall_s
        result["breakdown"] = {"device_ops": sl.top_ops(),
                               "idle_gaps": sl.idle_gaps()}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    args = parse(argv)
    log(f"card: {card_line()}")
    result = execute(args)
    bad = forbidden_modules()
    if bad:
        log("modules of JAX or the JAX package were loaded: "
            + ", ".join(bad[:20]))
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
