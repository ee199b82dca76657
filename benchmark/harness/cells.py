"""The manifest: a cell's configuration, traffic, limits and per-layer
readers, each found by its name in BENCHMARK.json.

  configs/<config>.json      the configuration as it is run
  traffic/<traffic>.json     the traffic mix's parameters
  limits/<workload>.json     the limits of the numbers `correct` compares
  metrics/<metric>.py        a per-layer metric's reader: read(ctx)
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
MANIFEST = ROOT / "BENCHMARK.json"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list      # the manifest's entries this cell reports
    per_layer: list


def load_manifest(path: Path = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def find_cell(name: str, manifest: dict | None = None) -> Cell:
    manifest = manifest or load_manifest()
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"({', '.join(sorted(cells))})")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    conf = configs[w["config"]]
    with open(ROOT / conf["file"]) as f:
        config = json.load(f)
    with open(BENCH_DIR / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    with open(BENCH_DIR / "limits" / f"{name}.json") as f:
        limits = json.load(f)
    e2e = [m for m in manifest["end_to_end"] if _reports(m, name)]
    layers = [m for m in manifest["per_layer"] if _reports(m, name)]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits, end_to_end=e2e,
                per_layer=layers)


def reader(metric_name: str):
    """The `read(ctx)` of metrics/<metric_name>.py."""
    path = BENCH_DIR / "metrics" / f"{metric_name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{metric_name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
