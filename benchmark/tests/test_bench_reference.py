"""The plain reference against the port, at a tiny size on the CPU, where
the port runs its plain paths: the first training steps of each layout
and a render of one view (the window renderer, several chunks)."""
from __future__ import annotations

import pytest
import torch

from benchmark.harness import check, drive
from benchmark.reference import ngp

from tiny import tiny_cell


@pytest.mark.parametrize("workload", ["corner-train", "cell-train"])
def test_reference_follows_the_first_train_steps(workload):
    torch.manual_seed(0)
    run = drive.make_run(tiny_cell(workload), 2**31 + 17, "cpu")
    run.setup()
    run.free_program()
    readings = run.readings(run.reference())
    assert readings["occ_binary_mismatches"] == 0
    assert readings["loss_gap"] <= 1e-6
    assert readings["occ_gap"] <= 1e-6
    assert readings["grad_gap"] <= 1e-5
    assert readings["change_gap"] <= 1e-5


@pytest.mark.parametrize("workload", ["corner-render", "cell-render"])
def test_reference_renders_the_served_view(workload):
    run = drive.make_run(tiny_cell(workload), 2**31 + 23, "cpu")
    run.setup()
    run.render_checked()
    run.free_program()
    ref = run.reference()
    readings = run.readings(ref)
    assert readings["rgb_max_gap"] <= 1e-5
    assert all(n > 0 for _, _, n in ref)


def test_rows_touched_counts_distinct_rows():
    grid = ngp.Grid(n_levels=2, n_features=2, log2_hashmap_size=8)
    x = torch.full((5, 3), 0.25)
    rows, _ = ngp.corner_rows_weights(x, grid)
    assert ngp.rows_touched(x, grid) == len(set(rows.reshape(-1).tolist()))


def test_judge_fails_a_missing_or_large_number():
    ok, checks = check.judge({"a": 1e-6, "b": 0}, {"a": 1e-5, "b": 0})
    assert ok and checks["a"] == {"value": 1e-6, "limit": 1e-5}
    assert not check.judge({"a": 2e-5}, {"a": 1e-5})[0]
    assert not check.judge({}, {"a": 1e-5})[0]
    assert not check.judge({"a": float("nan")}, {"a": 1e-5})[0]
