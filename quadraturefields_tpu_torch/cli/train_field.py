"""CLI: stage-2 quadrature-field training (reference
examples/train_field.py), with the JAX CLI's flags.

    python -m quadraturefields_tpu_torch.cli.train_field \\
        --ckpt_path runs/ckpts/lego/ngp/ngp.pt --scene lego

`--ckpt_path` is a stage-1 checkpoint the port wrote
(`Stage1Trainer.save`, e.g. the stage-1 CLI's ngp.pt). Runs on the CUDA
card unless main() is given another device; `--num_devices` > 1 (data
parallelism) is not ported yet and raises.
"""
from __future__ import annotations

import argparse

from ..train.stage2_field import Stage2Config, Stage2Trainer


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--data_root", type=str, default="data/nerf_synthetic")
    p.add_argument("--train_split", type=str, default="train")
    p.add_argument("--root", type=str, default="runs/")
    p.add_argument("--exp_name", type=str, default="field")
    p.add_argument("--scene", type=str, default="lego")
    p.add_argument("--ckpt_path", type=str, required=True)
    p.add_argument("--occ_thres", type=float, default=0.01)
    p.add_argument("--num_lobes", type=int, default=2)
    p.add_argument("--num_layers", type=int, default=2)
    p.add_argument("--log2_hashmap_size", type=int, default=19)
    p.add_argument("--field_log2_hashmap_size", type=int, default=30)
    p.add_argument("--batch_size", type=int, default=18)
    p.add_argument("--scale", type=float, default=1.5)
    p.add_argument("--max_steps", type=int, default=25000)
    p.add_argument("--grid_export_size", type=int, default=1024)
    p.add_argument("--coarse_factor", type=int, default=4,
                   help="two-level march factor (0 = single-level; "
                        "the sample set is identical either way)")
    p.add_argument("--interp", type=str, default="tet",
                   choices=["cube", "tet"],
                   help="hash-grid interpolation (hashgrid.py)")
    p.add_argument("--grad_mode", type=str, default="auto",
                   choices=["auto", "exact", "sorted", "stochastic"],
                   help="table-gradient strategy (hashgrid.py)")
    p.add_argument("--layout", type=str, default="corner",
                   choices=["corner", "cell"],
                   help="hash-table layout (must match the upstream "
                        "checkpoint; hashgrid.py)")
    p.add_argument("--grad_payload", type=str, default="f32",
                   choices=["f32", "bf16pair", "bf16sim", "bf16factor"],
                   help="cell table-gradient precision (hashgrid.py)")
    p.add_argument("--num_devices", type=int, default=0,
                   help="ray-batch data parallelism over the first N "
                        "devices (0/1 = single device; not ported yet)")
    return p


def main(argv=None, device: str = "cuda"):
    args = build_parser().parse_args(argv)
    if args.num_devices and args.num_devices > 1:
        raise NotImplementedError("data parallelism is not ported yet")
    cfg = Stage2Config(
        interp=args.interp,
        grad_mode=args.grad_mode,
        layout=args.layout,
        grad_payload=args.grad_payload,
        scene=args.scene,
        data_root=args.data_root,
        exp_name=args.exp_name,
        root=args.root,
        ckpt_path=args.ckpt_path,
        train_split=args.train_split,
        max_steps=args.max_steps,
        batch_size_log2=args.batch_size,
        occ_thres=args.occ_thres,
        num_lobes=args.num_lobes,
        num_layers=args.num_layers,
        log2_hashmap_size=args.log2_hashmap_size,
        field_log2_hashmap_size=args.field_log2_hashmap_size,
        scale=args.scale,
        grid_export_size=args.grid_export_size,
        coarse_factor=args.coarse_factor,
        num_devices=args.num_devices,
    )
    Stage2Trainer(cfg, device=device).train()


if __name__ == "__main__":
    main()
