"""The manifest and the harness around it, on the CPU.

Every cell resolves to its files; the configuration files hold their
scripts' flags; the result line has exactly the contract's keys; no
module of JAX or of the JAX package is loaded by a run, and the
reference imports nothing of the port (top-level names compared
whole)."""
from __future__ import annotations

import ast
import dataclasses
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.harness import cells

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
MANIFEST = cells.load_manifest()
WORKLOADS = [w["name"] for w in MANIFEST["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_cell_resolves_to_its_files(workload):
    cell = cells.find_cell(workload)
    assert cell.traffic["loop"] in ("train", "render")
    assert set(cell.config["stage1"]) <= {
        f.name for f in dataclasses.fields(_stage1_config())}
    assert cell.limits
    names = [m["name"] for m in cell.end_to_end + cell.per_layer]
    assert "setup_s" in names
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for name in names:
        assert callable(cells.reader(name))


def _stage1_config():
    from quadraturefields_tpu_torch.train.stage1_ngp import Stage1Config

    return Stage1Config


def test_manifest_keeps_the_contract():
    m = MANIFEST
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["paths"] == ["benchmark"]
    assert 1 <= m["run_seconds"] <= 51
    used = {w["config"] for w in m["workloads"]}
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert c["file"].startswith("benchmark/")
        assert 1 <= len(c["why"]) <= 200 and len(c["source"]) <= 200
        assert all(NAME.match(k) for k in c["reduced"])
    pairs = set()
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    names = [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    assert len(names) == len(set(names))
    e2e = {x["name"] for x in m["end_to_end"]}
    for x in m["end_to_end"]:
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
    for x in m["per_layer"]:
        assert x["moves"] in e2e and "bound" not in x
        assert x["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert "\n" not in x["layer"] and len(x["layer"]) <= 200
    for x in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(x["name"]) and UNIT.match(x["unit"])
        assert x["better"] in ("lower", "higher")
        for w in x.get("workloads", []):
            assert w in WORKLOADS
    assert len(json.dumps(m)) < 64 * 1024


def _script_flags(path: Path) -> dict:
    text = path.read_text()
    return dict(re.findall(r"--(\w+) ([^\s\\]+)", text))


@pytest.mark.parametrize("config", [c["name"] for c in MANIFEST["configs"]])
def test_configuration_holds_its_script_flags(config):
    conf = next(c for c in MANIFEST["configs"] if c["name"] == config)
    data = json.loads((ROOT / conf["file"]).read_text())
    flags = _script_flags(ROOT / data["script"])
    stage1 = data["stage1"]
    rename = {"batch_size": "batch_size_log2"}
    for flag, value in flags.items():
        key = rename.get(flag, flag)
        if key in ("scene", "data_root", "root", "exp_name"):
            continue
        got = stage1[key]
        assert str(got) == value or float(got) == float(value), (key, got)
    assert set(conf["reduced"]) == set(data["reduced"])


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    from benchmark import run

    for name in ("quadraturefields_tpu_torch", "quadraturefields_tpu_torchx",
                 "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "quadraturefields_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert run.forbidden_modules() == ["jax", "quadraturefields_tpu.ops"]


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_reference_imports_nothing_of_the_port_or_jax():
    for path in (BENCH / "reference").glob("*.py"):
        bad = _imports(path) & {"jax", "jaxlib", "flax",
                                "quadraturefields_tpu",
                                "quadraturefields_tpu_torch", "benchmark"}
        assert not bad, (path.name, bad)
    for path in BENCH.rglob("*.py"):
        assert not (_imports(path) & {"jax", "jaxlib", "flax",
                                      "quadraturefields_tpu"}), path


def test_run_without_a_card_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", WORKLOADS[0],
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


_TINY_RUN = """
import json, sys
sys.path[:0] = [{root!r}, {tests!r}]
from benchmark import run
from benchmark.harness import cells
import tiny
find = cells.find_cell
cells.find_cell = lambda name, manifest=None: tiny.shrink(find(name))
args = run.parse(["--workload", {w!r}, "--seed", "2147483659",
                  "--seconds", "0.5", "--trace", {t!r}])
result = run.execute(args, require_card=False, device="cpu")
print(json.dumps({{"result": result, "bad": run.forbidden_modules()}}))
"""


@pytest.mark.parametrize("workload,trace", [("corner-train", "1"),
                                            ("cell-render", "0")])
def test_result_line_has_the_contract_keys_and_no_jax(workload, trace):
    code = _TINY_RUN.format(root=str(ROOT), tests=str(BENCH / "tests"),
                            w=workload, t=trace)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    result = out["result"]
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    if trace == "1":
        keys.append("breakdown")
        assert set(result["device"]) >= {"busy_s", "window_s"}
    assert list(result) == keys + ["checks"]
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert result["correct"] is True
    for name, m in result["metrics"].items():
        assert set(m) == {"value", "unit"}
