"""CLI: stage-1 NGP training (reference examples/train_ngp_nerf_sg_occ.py).

Port of quadraturefields_tpu/cli/train_ngp.py, with the same parser and
flags, so the reference shell scripts map 1:1:
  python -m quadraturefields_tpu_torch.cli.train_ngp --scene lego \
      --data_root data/nerf_synthetic --root runs/ --exp_name nerf \
      --batch_size 18 --max_steps 20000
scripts/run_nerfsynthetic_tpu_fast.sh's flags (--layout cell
--grad_payload bf16factor --n_levels 8 --n_features 4 --num_lobes 0
--batch_size 20 ...) train the cell layout, whose table gradient is the
K7 kernel on the card. Training runs on the CUDA card;
`main(argv, device="cpu")` runs it on the CPU. Data parallelism
(--num_devices > 1) is not ported yet.
"""
from __future__ import annotations

import argparse

from ..train.stage1_ngp import Stage1Config, Stage1Trainer


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--data_root", type=str, default="data/nerf_synthetic")
    p.add_argument("--train_split", type=str, default="train",
                   choices=["train", "trainval"])
    p.add_argument("--reg_type", type=str, default="occ")
    p.add_argument("--occ_thres", type=float, default=0.01)
    p.add_argument("--root", type=str, default="runs/")
    p.add_argument("--exp_name", type=str, default="ngp")
    p.add_argument("--scene", type=str, default="lego")
    p.add_argument("--num_lobes", type=int, default=2)
    p.add_argument("--o_lambda", type=float, default=1e-3)
    p.add_argument("--c_lambda", type=float, default=1e-5)
    p.add_argument("--num_layers", type=int, default=2)
    p.add_argument("--log2_hashmap_size", type=int, default=19)
    p.add_argument("--batch_size", type=int, default=18)
    p.add_argument("--scale", type=float, default=1.5)
    p.add_argument("--max_steps", type=int, default=20000)
    p.add_argument("--save_images", action="store_true")
    p.add_argument("--coarse_factor", type=int, default=4,
                   help="two-level march factor (0 = single-level; "
                        "the sample set is identical either way)")
    p.add_argument("--interp", type=str, default="tet",
                   choices=["cube", "tet"],
                   help="hash-grid interpolation (hashgrid.py)")
    p.add_argument("--grad_mode", type=str, default="auto",
                   choices=["auto", "exact", "sorted",
                            "stochastic"],
                   help="table-gradient strategy (hashgrid.py)")
    p.add_argument("--layout", type=str, default="corner",
                   choices=["corner", "cell"],
                   help="hash-table layout: corner = tcnn parity, "
                        "cell = one gather per level (hashgrid.py)")
    p.add_argument("--grad_payload", type=str, default="f32",
                   choices=["f32", "bf16pair", "bf16sim", "bf16factor"],
                   help="cell-layout table-gradient contribution "
                        "precision (hashgrid.py)")
    p.add_argument("--n_levels", type=int, default=16,
                   help="hash-grid levels (tcnn L; the cell layout at "
                        "L=8/F=4 halves forward gathers at parity — "
                        "tools/quality_parity.py)")
    p.add_argument("--n_features", type=int, default=2,
                   help="features per level (tcnn F)")
    p.add_argument("--scene_type", type=str, default="auto",
                   choices=["auto", "synthetic", "360"],
                   help="force the scene family (auto: 360 scene names "
                        "select the unbounded path, utils.py:37-45)")
    p.add_argument("--data_factor", type=int, default=4,
                   help="360 loader image downsample factor")
    p.add_argument("--num_devices", type=int, default=0,
                   help="ray-batch data parallelism over the first N "
                        "devices (0/1 = single device; parallel/dp.py "
                        "shard_map step + sharded occ refresh over a "
                        "1-D mesh)")
    return p


def main(argv=None, device: str = "cuda"):
    args = build_parser().parse_args(argv)
    if args.num_devices and args.num_devices > 1:
        raise NotImplementedError("data parallelism is not ported yet")
    cfg = Stage1Config(
        interp=args.interp,
        grad_mode=args.grad_mode,
        layout=args.layout,
        grad_payload=args.grad_payload,
        n_levels=args.n_levels,
        n_features=args.n_features,
        scene=args.scene,
        data_root=args.data_root,
        exp_name=args.exp_name,
        root=args.root,
        train_split=args.train_split,
        max_steps=args.max_steps,
        batch_size_log2=args.batch_size,
        occ_thres=args.occ_thres,
        reg_type=args.reg_type,
        o_lambda=args.o_lambda,
        c_lambda=args.c_lambda,
        num_lobes=args.num_lobes,
        num_layers=args.num_layers,
        log2_hashmap_size=args.log2_hashmap_size,
        scale=args.scale,
        save_images=args.save_images,
        coarse_factor=args.coarse_factor,
        scene_type=args.scene_type,
        data_factor=args.data_factor,
        num_devices=args.num_devices,
    )
    trainer = Stage1Trainer(cfg, device=device)
    metrics = trainer.train()
    print("evaluation:", metrics)
    return metrics


if __name__ == "__main__":
    main()
