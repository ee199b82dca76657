"""CLI: stage-5 SG fitting (reference examples/train_fit_sg.py), with
the JAX CLI's flags.

    python -m quadraturefields_tpu_torch.cli.train_fit_sg \\
        --ckpt_path runs/ckpts/lego/finetune/finetune.pt \\
        --mesh_path runs/results/lego/finetune/mesh.ply --scene lego

`--ckpt_path` is a stage-4 checkpoint the port wrote
(`Stage4Trainer.save`), `--mesh_path` stage 4's mesh.ply. The SG model
is saved to ROOT/ckpts/SCENE/EXP/fit_sg.pt. Runs on the CUDA card
unless main() is given another device; `--num_devices` > 1 (data
parallelism) is not ported yet and raises. `--optix` is accepted for
script parity (the host BVH casts the rays).
"""
from __future__ import annotations

import argparse

from ..train.stage5_fit_sg import Stage5Config, Stage5Trainer


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--data_root", type=str, default="data/nerf_synthetic")
    p.add_argument("--root", type=str, default="runs/")
    p.add_argument("--exp_name", type=str, default="finetune_sg")
    p.add_argument("--scene", type=str, default="lego")
    p.add_argument("--ckpt_path", type=str, required=True)
    p.add_argument("--mesh_path", type=str, required=True)
    p.add_argument("--scaling", type=float, default=0.0434)
    p.add_argument("--up_sample", type=float, default=2.0)
    p.add_argument("--max_hits", type=int, default=25)
    p.add_argument("--num_lobes", type=int, default=6)
    p.add_argument("--num_layers", type=int, default=2)
    p.add_argument("--log2_hashmap_size", type=int, default=19)
    p.add_argument("--batch_size", type=int, default=18)
    p.add_argument("--scale", type=float, default=1.5)
    p.add_argument("--max_iterations", type=int, default=20000)
    p.add_argument("--occ_thres", type=float, default=0.01)
    p.add_argument("--optix", type=int, default=0)
    p.add_argument("--interp", type=str, default="tet",
                   choices=["cube", "tet"],
                   help="hash-grid interpolation (hashgrid.py)")
    p.add_argument("--grad_mode", type=str, default="auto",
                   choices=["auto", "exact", "sorted",
                            "stochastic"],
                   help="table-gradient strategy (hashgrid.py)")
    p.add_argument("--layout", type=str, default="corner",
                   choices=["corner", "cell"],
                   help="hash-table layout (must match the upstream "
                        "checkpoint; hashgrid.py)")
    p.add_argument("--grad_payload", type=str, default="f32",
                   choices=["f32", "bf16pair", "bf16sim", "bf16factor"],
                   help="cell table-gradient precision (hashgrid.py)")
    p.add_argument("--pack_slack", type=float, default=1.25,
                   help="packed-hit stream budget as a multiple of the "
                        "sample target; 0 = dense rows "
                        "(render/quadrature.py)")
    p.add_argument("--num_devices", type=int, default=0,
                   help="ray-batch data parallelism over the first N "
                        "devices (0/1 = single device; not ported yet)")
    return p


def main(argv=None, device: str = "cuda"):
    args = build_parser().parse_args(argv)
    if args.num_devices and args.num_devices > 1:
        raise NotImplementedError("data parallelism is not ported yet")
    scale = 2.0 if args.scene in ("horse", "woolly") else args.scale
    cfg = Stage5Config(
        num_devices=args.num_devices,
        interp=args.interp,
        grad_mode=args.grad_mode,
        layout=args.layout,
        grad_payload=args.grad_payload,
        pack_slack=args.pack_slack,
        scene=args.scene,
        data_root=args.data_root,
        exp_name=args.exp_name,
        root=args.root,
        ckpt_path=args.ckpt_path,
        mesh_path=args.mesh_path,
        max_steps=args.max_iterations,
        batch_size_log2=args.batch_size,
        occ_thres=args.occ_thres,
        scaling=args.scaling,
        up_sample=int(args.up_sample),
        max_hits=args.max_hits,
        num_lobes=args.num_lobes,
        num_layers=args.num_layers,
        log2_hashmap_size=args.log2_hashmap_size,
        scale=scale,
    )
    Stage5Trainer(cfg, device=device).train()


if __name__ == "__main__":
    main()
