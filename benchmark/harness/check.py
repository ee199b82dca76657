"""The numbers that decide `correct`, each against its limit.

Training: the checked steps' losses, the first gradient as the
optimiser took it (read from Adam's first moment before and after one
step), and each leaf's change after the checked steps, held against the
plain reference following the same steps from the same state, batches
and uniforms; norms are compared leaf by leaf, the gap measured against
the larger of the reference's norm of that leaf and of the median leaf.
The occupancy refresh of the first checked step, which the reference
does not follow (it marches on the program's binaries), is checked on
its own: the EMA densities against the reference's, and the binaries
against the program's own densities and threshold, exactly.

Rendering: the rgb of views the window served, against the reference's
render of the same rays with the same weights and grid.
"""
from __future__ import annotations

import statistics

import torch


def _norm_gaps(prog: dict, ref: dict, leaves) -> float:
    med = statistics.median(ref[k] for k in ref)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in leaves)


def changed_leaves(ref_grad_norms: dict) -> list:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others move under Adam by round-off alone."""
    med = statistics.median(ref_grad_norms.values())
    return [k for k, v in ref_grad_norms.items() if v >= 1e-3 * med]


def train_readings(prog: dict, ref: dict, occ_thre: float) -> dict:
    losses = [abs(p - r) / max(abs(r), 1e-30)
              for p, r in zip(prog["losses"], ref["losses"])]
    occ_ref = ref["occs"]
    occ_gap = float((prog["occs"] - occ_ref).abs().max()
                    / occ_ref.abs().max().clamp_min(1e-30))
    occs = prog["occs"]
    thre = torch.clamp(occs.mean(), max=occ_thre)
    mismatches = int(((occs > thre).reshape(prog["binaries"].shape)
                      != prog["binaries"]).sum())
    return {
        "loss_gap": max(losses),
        "grad_gap": _norm_gaps(prog["grad_norms"], ref["grad_norms"],
                               ref["grad_norms"]),
        "change_gap": _norm_gaps(prog["change_norms"], ref["change_norms"],
                                 changed_leaves(ref["grad_norms"])),
        "occ_gap": occ_gap,
        "occ_binary_mismatches": mismatches,
    }


def render_readings(prog_rgb: list, ref_rgb: list) -> dict:
    diffs = [(p.to(torch.float32) - r.to(p.device)).abs()
             for p, r in zip(prog_rgb, ref_rgb)]
    return {
        "rgb_max_gap": max(float(d.max()) for d in diffs),
        "rgb_mean_gap": max(float(d.mean()) for d in diffs),
    }


def judge(readings: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}); a number with no limit, or
    a reading that is not a number, fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = readings.get(name)
        checks[name] = {"value": value, "limit": limit}
        if value is None or not (value == value) or value > limit:
            ok = False
    return ok, checks
