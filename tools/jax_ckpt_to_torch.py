"""Convert a JAX package checkpoint (orbax) into the PyTorch port's format.

The JAX trainers save orbax pytree checkpoints (utils/checkpoint.py of
quadraturefields_tpu); the port (quadraturefields_tpu_torch) saves
torch.save dicts of the same trees and cannot read orbax. This tool
reads a JAX checkpoint of stage 1, 2, 4 or 5 with the JAX package and
writes the port's checkpoint, through the port's carry-over functions
(quadraturefields_tpu_torch/utils/convert.py):

  stage 1  {"params", "occs", "binaries", "step"}          Stage1Trainer.load,
                                                           stage 2's and 4's --ckpt_path
  stage 2  {"field_params", "occs", "binaries", "step"}    Stage2Trainer.load
  stage 4  {"radiance_field", "field_model", ...}          Stage4Trainer.load,
                                                           stage 5's and the bake's --ckpt_path
  stage 5  {"radiance_field", "occs", "binaries", "step"}  Stage5Trainer.load,
                                                           the bake's --sg_ckpt_path

The stage follows from the checkpoint's keys. The optax state is not
carried over: a trainer that loads the result starts a fresh Adam at the
saved step.

  python tools/jax_ckpt_to_torch.py --in runs/ckpts/lego/nerf/ngp \\
      --out runs_torch/ckpts/lego/nerf/ngp.pt

Needs JAX and orbax (to read) and torch (to write): it runs where the
JAX package runs, not on a host that has only the port.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# the model trees each stage saves, and the port function for each
_STAGE_KEYS = {
    1: ("params",),
    2: ("field_params",),
    4: ("radiance_field", "field_model"),
    5: ("radiance_field",),
}


def detect_stage(state: dict) -> int:
    if "params" in state:
        return 1
    if "field_params" in state:
        return 2
    if "field_model" in state:
        return 4
    if "radiance_field" in state:
        return 5
    raise ValueError(f"not a stage 1, 2, 4 or 5 checkpoint: {sorted(state)}")


def convert_state(state: dict) -> dict:
    """A restored JAX checkpoint tree (numpy leaves) -> the port's tree
    (tensors): the model trees, the occupancy grid and the step."""
    from quadraturefields_tpu_torch.utils.convert import (
        field_params_from_jax,
        occ_state_from_jax,
        params_from_jax,
    )

    stage = detect_stage(state)
    out = {}
    for key in _STAGE_KEYS[stage]:
        conv = field_params_from_jax if key in ("field_params",
                                                "field_model") \
            else params_from_jax
        out[key] = conv(state[key])
    occ = occ_state_from_jax(state["occs"], state["binaries"],
                             np.zeros(6, np.float32))
    out["occs"], out["binaries"] = occ.occs, occ.binaries
    out["step"] = int(state.get("step", 0))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--in", dest="inp", type=str, required=True,
                   help="a JAX trainer's checkpoint directory (orbax)")
    p.add_argument("--out", type=str, required=True,
                   help="the port's checkpoint file (.pt)")
    args = p.parse_args(argv)

    from quadraturefields_tpu.utils.checkpoint import load_checkpoint
    from quadraturefields_tpu_torch.utils.checkpoint import save_checkpoint

    state = load_checkpoint(args.inp)
    out = convert_state(state)
    save_checkpoint(args.out, out)
    print(f"stage {detect_stage(state)} checkpoint {args.inp} -> {args.out} "
          f"(keys {sorted(out)}, step {out['step']})")
    return out


if __name__ == "__main__":
    main()
