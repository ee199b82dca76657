"""Experiment logging: TensorBoard scalars + JSON metrics + repro
snapshots (reference train_ngp_nerf_sg_occ.py:140-147, 343-356,
431-441). A copy of quadraturefields_tpu/utils/logging.py."""
from __future__ import annotations

import json
import os
import shutil
from typing import Optional


class ExperimentLogger:
    def __init__(self, log_dir: str, results_dir: Optional[str] = None,
                 snapshot_code: bool = False):
        self.log_dir = log_dir
        self.results_dir = results_dir or log_dir
        os.makedirs(self.log_dir, exist_ok=True)
        os.makedirs(self.results_dir, exist_ok=True)
        self._tb = None
        try:
            from tensorboardX import SummaryWriter

            self._tb = SummaryWriter(log_dir, flush_secs=200)
        except Exception:
            pass
        if snapshot_code:
            self.snapshot_code()

    def add_scalar(self, tag: str, value, step: int):
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)

    def dump_json(self, name: str, payload: dict, append: bool = False):
        path = os.path.join(self.results_dir, name)
        mode = "a" if append else "w"
        with open(path, mode) as f:
            json.dump(payload, f)
            if append:
                f.write("\n")

    def snapshot_code(self):
        """Copy the package into the results dir for reproducibility
        (reference shutil.copytree of examples/,
        train_ngp_nerf_sg_occ.py:147)."""
        src = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        dst = os.path.join(self.results_dir, "code")
        shutil.copytree(
            src, dst,
            ignore=shutil.ignore_patterns("*.pyc", "__pycache__"),
            dirs_exist_ok=True,
        )

    def close(self):
        if self._tb is not None:
            self._tb.close()
