"""CLI: the stage-6 baking chain (reference run_*_baking.sh:32-38:
prune_mesh_after_finetuning.py + segmentator + generate_uv_xatlas_old.py
+ bake_texture_images_shelly.py + test_baking_texture_images.py), as
subcommands of one entry point, with the JAX CLI's flags:

    python -m quadraturefields_tpu_torch.cli.bake all --scene lego \\
        --ckpt_path runs/ckpts/lego/finetune/finetune.pt \\
        --sg_ckpt_path runs/ckpts/lego/finetune_sg/fit_sg.pt \\
        --mesh_path runs/results/lego/finetune/mesh.ply --texture_size 4096

`--ckpt_path` is a stage-4 checkpoint the port wrote (the teacher's
density), `--sg_ckpt_path` a stage-5 one (`Stage5Trainer.save`). One
flag more than JAX's: `--interp` (default tet, the trainers' default),
the hash grid's interpolation of both models; JAX's CLI builds them
with NGPConfig's default, cube, whatever the stages trained with. Runs
on the CUDA card unless main() is given another device.
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("command", choices=["all", "prune", "uv", "bake", "eval"])
    p.add_argument("--data_root", type=str, default="data/nerf_synthetic")
    p.add_argument("--root", type=str, default="runs/")
    p.add_argument("--exp_name", type=str, default="baking")
    p.add_argument("--scene", type=str, default="lego")
    p.add_argument("--ckpt_path", type=str, required=True,
                   help="stage-4 finetune checkpoint (teacher density)")
    p.add_argument("--sg_ckpt_path", type=str, default="",
                   help="stage-5 fit-SG checkpoint")
    p.add_argument("--mesh_path", type=str, required=True)
    p.add_argument("--texture_size", type=int, default=4096)
    p.add_argument("--compression_type", type=str, default="sigmoid")
    p.add_argument("--lambda_thres", type=float, default=7.5)
    p.add_argument("--num_lobes", type=int, default=6)
    p.add_argument("--num_layers", type=int, default=2)
    p.add_argument("--log2_hashmap_size", type=int, default=19)
    p.add_argument("--max_hits", type=int, default=25)
    p.add_argument("--scale", type=float, default=1.5)
    p.add_argument("--kthr", type=float, default=0.01)
    p.add_argument("--min_segment_size", type=int, default=None,
                   help="Felzenszwalb merge floor in faces; default: "
                        "adaptive ~1%% of the face count")
    p.add_argument("--prune_spiral_views", type=int, default=0,
                   help="extra spiral prune-coverage views per ring "
                        "(3 rings); the split-independent analog of the "
                        "reference's --train_split trainval knob "
                        "(prune_mesh_after_finetuning.py:62-66)")
    p.add_argument("--prune_spiral_distance", type=float, default=4.0,
                   help="spiral camera distance (NeRF-synthetic train "
                        "cameras orbit at ~4.03)")
    p.add_argument("--interp", type=str, default="tet",
                   choices=["cube", "tet"],
                   help="hash-grid interpolation of the teacher and the "
                        "SG model (as stages 4 and 5 trained them)")
    return p


def main(argv=None, device: str = "cuda"):
    from ..baking.compression import FeatureCompression
    from ..baking.stage6 import (
        BakedRenderer,
        bake_textures,
        evaluate_baked,
        prune_mesh,
        segment_and_atlas,
    )
    from ..data.nerf_synthetic import SubjectLoader
    from ..geometry.intersect import MeshIntersection
    from ..geometry.meshio import load_obj_with_uv, load_ply
    from ..models.ngp import NGPConfig
    from ..utils.checkpoint import load_checkpoint

    args = build_parser().parse_args(argv)
    out_dir = os.path.join(args.root, "results", args.scene, args.exp_name)
    os.makedirs(out_dir, exist_ok=True)
    aabb = np.array([-1, -1, -1, 1, 1, 1], np.float32) * args.scale

    teacher_cfg = NGPConfig(
        head="mlp", use_viewdirs=False, num_layers=args.num_layers,
        log2_hashmap_size=args.log2_hashmap_size, interp=args.interp,
    )
    sg_cfg = NGPConfig(
        head="sg", use_viewdirs=False, num_g_lobes=args.num_lobes,
        num_layers=args.num_layers,
        log2_hashmap_size=args.log2_hashmap_size, interp=args.interp,
    )
    teacher = load_checkpoint(args.ckpt_path,
                              map_location=device)["radiance_field"]

    run_all = args.command == "all"

    if run_all or args.command == "prune":
        train_ds = SubjectLoader(
            subject_id=args.scene, root_fp=args.data_root, split="train",
            num_rays=8192,
        )
        mi = MeshIntersection(
            mesh_path=args.mesh_path, simplify_mesh=False, scale=1.0,
            num_intersections=args.max_hits,
        )
        extra_views = None
        if args.prune_spiral_views > 0:
            from ..data.own_views import spiral_prune_rings

            extra_views = spiral_prune_rings(
                distance=args.prune_spiral_distance,
                n_per_ring=args.prune_spiral_views,
                resolution=train_ds.WIDTH,
            )
        pruned, _ = prune_mesh(
            teacher, teacher_cfg, mi, train_ds, aabb,
            extra_views=extra_views, out_dir=out_dir,
        )
        print("pruned mesh:", pruned.faces.shape)

    if run_all or args.command == "uv":
        mesh = load_ply(os.path.join(out_dir, "mesh_updated.ply"))
        atlas_mesh, uv, v_image, tri_image = segment_and_atlas(
            mesh, args.texture_size, kthr=args.kthr,
            min_size=args.min_segment_size, out_dir=out_dir,
        )
        np.save(os.path.join(out_dir, "atlas_uv.npy"), uv)
        np.save(os.path.join(out_dir, "tri_image.npy"), tri_image)
        print("atlas:", atlas_mesh.faces.shape,
              "filled texels:", int((tri_image >= 0).sum()))

    if run_all or args.command == "bake":
        sg = load_checkpoint(args.sg_ckpt_path,
                             map_location=device)["radiance_field"]
        v_image = np.load(
            os.path.join(out_dir, f"V_{args.texture_size}.npy")
        ).astype(np.float32)
        tri_image = np.load(os.path.join(out_dir, "tri_image.npy"))
        bake_textures(
            sg, sg_cfg, v_image, tri_image, aabb,
            teacher_params=teacher,
            teacher_cfg=teacher_cfg,
            texture_size=args.texture_size,
            compression_type=args.compression_type,
            lambda_thres=args.lambda_thres,
            out_dir=out_dir,
        )
        print("textures written to",
              os.path.join(out_dir, f"texture_{args.texture_size}"))

    if run_all or args.command == "eval":
        # the SAVED atlas of the `uv` step: segmenting again here could
        # mismatch the baked textures
        atlas_mesh, uv = load_obj_with_uv(os.path.join(
            out_dir, f"mesh_segmentation_{args.texture_size}.obj"))
        comp = FeatureCompression(
            num_lobes=args.num_lobes,
            path=os.path.join(out_dir, f"texture_{args.texture_size}/"),
            compression_type=args.compression_type,
            lambda_thres=args.lambda_thres,
        )
        test_ds = SubjectLoader(
            subject_id=args.scene, root_fp=args.data_root, split="test",
            num_rays=None,
        )
        renderer = BakedRenderer(atlas_mesh, uv, comp, sg_cfg,
                                 max_hits=args.max_hits, device=device)
        results = evaluate_baked(
            renderer, test_ds,
            out_path=os.path.join(
                out_dir,
                f"results_baking_textureimage_{args.texture_size}.json",
            ),
        )
        print("baked eval:", results)
        return results


if __name__ == "__main__":
    main()
