"""`correct` must come out false when the timed path is broken, and the
control must be told apart from the program.

On the CPU at a tiny size: a run of each cell (without the look for a
card) with a fault planted under the timed path (a training step that
leaves its state unchanged, a training step over half its batch, a
served view with one pixel altered, a served view with half its rays
left out), judged by the cell's own limits. The controls (the reference
in the program's place with fp8 MLP operands, and with the table read
in bf16) at that size. On the card (marker `cuda`): each control at
each cell's own size on three seeds fails the cell's limits."""
from __future__ import annotations

import contextlib

import pytest
import torch

from benchmark import calibrate
from benchmark.harness import cells, check, drive

from tiny import tiny_cell

SEED = 2**31 + 29


def _run(cell, seconds=0.3):
    run = drive.make_run(cell, SEED, "cpu")
    run.setup()
    run.window(seconds)
    run.free_program()
    readings = run.readings(run.reference())
    return check.judge(readings, cell.limits)[0], readings


@contextlib.contextmanager
def _fault(monkeypatch, name):
    from quadraturefields_tpu_torch.train.stage1_ngp import Stage1Trainer

    if name == "state_unchanged":
        monkeypatch.setattr(torch.optim.Adam, "step",
                            lambda self, closure=None: None)
    elif name == "half_batch":
        loss_fn = Stage1Trainer._loss_fn

        def half(self, params, occ, o, d, pixels, bkgd, jit, rcfg=None):
            n = o.shape[0] // 2
            return loss_fn(self, params, occ, o[:n], d[:n], pixels[:n],
                           bkgd, jit[:n], rcfg)
        monkeypatch.setattr(Stage1Trainer, "_loss_fn", half)
    else:
        render_view = Stage1Trainer.render_view

        def broken(self, data):
            rgb = render_view(self, data).clone()
            if name == "pixel_altered":
                rgb[0] += 0.05
            else:
                rgb[rgb.shape[0] // 2:] = 0.0
            return rgb
        monkeypatch.setattr(Stage1Trainer, "render_view", broken)
    yield


@pytest.mark.parametrize("workload,fault", [
    ("corner-train", "state_unchanged"), ("corner-train", "half_batch"),
    ("cell-train", "state_unchanged"), ("cell-train", "half_batch"),
    ("corner-render", "pixel_altered"), ("corner-render", "half_view"),
    ("cell-render", "pixel_altered"), ("cell-render", "half_view"),
])
def test_a_fault_under_the_timed_path_is_not_correct(monkeypatch, workload,
                                                     fault):
    cell = tiny_cell(workload)
    with _fault(monkeypatch, fault):
        correct, readings = _run(cell)
    assert not correct, readings


@pytest.mark.parametrize("workload", ["corner-train", "cell-train",
                                      "corner-render", "cell-render"])
def test_a_sound_run_is_correct(workload):
    correct, readings = _run(tiny_cell(workload))
    assert correct, readings


@pytest.mark.parametrize("workload", ["corner-train", "cell-render"])
def test_the_controls_are_told_apart_at_a_small_size(workload):
    run = drive.make_run(tiny_cell(workload), SEED, "cpu")
    run.setup()
    if run.cell.traffic["loop"] == "render":
        run.render_checked()
    run.free_program()
    ref = run.reference()
    prog = run.readings(ref)
    for name, precision in calibrate.CONTROLS.items():
        control = run.readings(ref, run.as_program(run.reference(
            precision=drive.rngp.Precision(**precision))))
        assert any(control[k] > 10 * prog[k] and control[k] > 0
                   for k in prog), (name, control, prog)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      cells.load_manifest()["workloads"]])
def test_the_controls_fail_each_cell_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("the controls at a cell's own size run on the card")
    cell = cells.find_cell(workload)
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        lines = calibrate.calibrate(cell, seed, list(calibrate.CONTROLS), [])
        by_side = {line.pop("side"): line for line in lines}
        for side, line in by_side.items():
            line.pop("seed")
            ok = check.judge(line, cell.limits)[0]
            assert ok == (side == "program"), (side, line)
