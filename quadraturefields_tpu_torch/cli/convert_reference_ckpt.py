"""CLI: import reference (ubc-vision/quadraturefields) torch checkpoints.

The port's counterpart of tools/convert_reference_ckpt.py, with the same
flags and the same refusals. The reference saves per-stage `torch.save`
dicts of bare state_dicts (train_ngp_nerf_sg_occ.py:357-364,
train_field.py:411-419, train_finetune.py:561-570,
train_fit_sg.py:484-492):

    {"estimator": OccGridEstimator.state_dict(),
     "model" | "field_model" | "radiance_field": module.state_dict()}

This maps them straight onto the port's checkpoints (utils/checkpoint.py),
the files that `Stage{1,2,4,5}Trainer.load` and the next stage's
`--ckpt_path` read: stage 1 -> {"params", "occs", "binaries", "step"}
(stage 2's and 4's --ckpt_path), stage 2 -> {"field_params", ...},
stage 4 -> {"radiance_field", "field_model", ...} (stage 5's and the
bake's --ckpt_path), stage 5 -> {"radiance_field", ...} (the bake's
--sg_ckpt_path). A converted checkpoint holds no optimizer state; a
trainer that loads it starts a fresh Adam at step 0.

Why the mapping is exact: the corner-layout `interp="cube"` encoder
replicates tcnn's HashGrid (level scale base*growth^l - 1, resolution
ceil(scale)+1, dense-when-it-fits sizing padded to 8 entries, x-fastest
strides and the xor-prime hash, pos = x*scale + 0.5), so the tcnn grid
blob reshapes directly into the [total_entries, F] table.
FullyFusedMLP weight matrices are row-major [out, in_padded] slabs
concatenated input->hidden->output, torch nn.Linear weights [out, in];
both transpose into the port's {"w": [in, out], "b": [out]} layers.

tcnn packs `NetworkWithInputEncoding.params` as ONE flat tensor, the
network's weights first, then the encoding table (an upstream detail),
so `--blob_order auto` (default) checks it per checkpoint: the grid of a
trained NGP is mostly near-zero entries (U(-1e-4, 1e-4) init, most hash
rows never touched) while MLP slabs are O(1e-1) dense; the split whose
grid part is sparser wins. `--blob_order network_first|encoding_first`
pins it.

  python -m quadraturefields_tpu_torch.cli.convert_reference_ckpt \\
      --stage 1 --in ckpts/lego/nerf/ngp.pth --out runs/ckpts/lego/nerf/ngp.pt \\
      --num_lobes 6 --log2_hashmap_size 19 --grid_resolution 128

Runs on the CPU anywhere torch is installed; imports nothing of JAX.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..models.field import FieldConfig
from ..models.ngp import NGPConfig
from ..utils.checkpoint import save_checkpoint
from ..utils.convert import params_from_jax


def _np(t):
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach")
                      else t)


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def fused_mlp_widths(n_in: int, n_out: int, n_neurons: int = 64,
                     n_hidden_layers: int = 1):
    """FullyFusedMLP weight-matrix shapes [out, in], in tcnn order: the
    input and output widths padded to multiples of 16, n_hidden_layers
    (tcnn's meaning: layers between input and output) n_neurons wide."""
    shapes = [(n_neurons, _round16(n_in))]
    for _ in range(n_hidden_layers - 1):
        shapes.append((n_neurons, n_neurons))
    shapes.append((_round16(n_out), n_neurons))
    return shapes


def split_blob(blob: np.ndarray, grid_count: int, mlp_shapes,
               order: str = "auto"):
    """Split a tcnn NetworkWithInputEncoding params blob into
    (grid_params, [weight matrices])."""
    blob = blob.reshape(-1).astype(np.float32)
    net_count = int(sum(o * i for o, i in mlp_shapes))
    if blob.size != grid_count + net_count:
        raise ValueError(
            f"params blob has {blob.size} entries; expected grid "
            f"{grid_count} + network {net_count} = "
            f"{grid_count + net_count}. Check --n_levels/"
            f"--log2_hashmap_size/--max_resolution against the "
            f"training flags."
        )
    cands = {
        "network_first": (blob[net_count:], blob[:net_count]),
        "encoding_first": (blob[:grid_count], blob[grid_count:]),
    }
    if order == "auto":
        def sparsity(c):
            return float(np.mean(np.abs(cands[c][0]) < 1e-3))

        order = max(cands, key=sparsity)
        s_win = {c: round(sparsity(c), 3) for c in cands}
        print(f"blob_order auto -> {order} (grid near-zero fraction: "
              f"{s_win})")
    grid, net = cands[order]
    mats, off = [], 0
    for (o, i) in mlp_shapes:
        mats.append(net[off:off + o * i].reshape(o, i))
        off += o * i
    return grid, mats


def fused_mlp_to_layers(mats, n_in: int, n_out: int):
    """tcnn [out, in_padded] slabs -> {"layers": [{"w": [in, out]}]}.

    tcnn pads encoding outputs to the padded input width with ONES, so a
    trained checkpoint's pad-column weights act as a bias; the bias-free
    mapping needs n_in % 16 == 0 (every reference config: L*F = 32). The
    last slab's pad rows are dead outputs and are dropped."""
    if n_in % 16 != 0:
        raise ValueError(
            f"fused-MLP input width {n_in} is not 16-aligned; tcnn's "
            f"one-padding would need a bias fold this converter does "
            f"not implement"
        )
    layers = []
    for k, m in enumerate(mats):
        if k == len(mats) - 1:
            m = m[:n_out]
        layers.append({"w": m.T.astype(np.float32)})
    return {"layers": layers}


def linear_stack_to_layers(sd, prefix: str, num_layers: int):
    """BasicDecoder state_dict (layers.{i} + lout) -> mlp params."""
    layers = []
    for name in [f"{prefix}.layers.{i}" for i in range(num_layers)] \
            + [f"{prefix}.lout"]:
        layer = {"w": _np(sd[f"{name}.weight"]).astype(np.float32).T}
        b = sd.get(f"{name}.bias")
        if b is not None:
            layer["b"] = _np(b).astype(np.float32)
        layers.append(layer)
    return {"layers": layers}


def convert_ngp(sd, cfg: NGPConfig, blob_order: str = "auto"):
    """NGPRadianceField{,SGNew} state_dict -> the ngp params tree
    (numpy leaves)."""
    if cfg.layout != "corner" or cfg.interp != "cube":
        raise ValueError(
            "reference checkpoints carry tcnn corner-layout tables; "
            "convert with layout='corner', interp='cube' (retrain or "
            "distill to move to the cell/tet encodings)"
        )
    hg = cfg.hashgrid
    n_in = hg.output_dim
    n_out = 1 + cfg.geo_feat_dim
    grid, mats = split_blob(
        _np(sd["mlp_base.params"]), hg.total_entries * hg.n_features,
        fused_mlp_widths(n_in, n_out), blob_order,
    )
    params = {
        "table": grid.reshape(hg.total_entries, hg.n_features).astype(
            np.dtype(cfg.table_dtype)),
        "mlp_base": fused_mlp_to_layers(mats, n_in, n_out),
    }
    if cfg.head in ("sg", "sg_old"):
        # both SG variants use a torch BasicDecoder head (reference
        # ngp.py:365-383 new / ngp.py:546-556 old); only the output
        # width differs (7 vs 15 a lobe, cfg.head_output_dim)
        params["mlp_head"] = linear_stack_to_layers(
            sd, "mlp_head", cfg.num_layers)
    elif cfg.head == "mlp":
        # NGPRadianceField's head is a tcnn.Network (reference
        # ngp.py:729-746): a second fused blob, bias-free
        n_in_h = cfg.dir_enc_dim + cfg.geo_feat_dim
        _, mats_h = split_blob(
            _np(sd["mlp_head.params"]), 0,
            fused_mlp_widths(n_in_h, 3, n_hidden_layers=2), "encoding_first")
        params["mlp_head"] = fused_mlp_to_layers(mats_h, n_in_h, 3)
    return params


def convert_field(sd, cfg: FieldConfig):
    """Reference Field state_dict (tcnn.Encoding + BasicDecoder,
    field.py:157-185) -> the field params tree (numpy leaves). The
    encoding-only blob is the grid."""
    hg = cfg.hashgrid
    grid_count = hg.total_entries * hg.n_features
    blob = _np(sd["xyz_encoder.params"]).reshape(-1).astype(np.float32)
    if blob.size != grid_count:
        raise ValueError(
            f"xyz_encoder blob {blob.size} != expected {grid_count}; "
            f"check --field_log2_hashmap_size/--field_max_res/--scale"
        )
    return {
        "table": blob.reshape(hg.total_entries, hg.n_features),
        "decoder": linear_stack_to_layers(sd, "decoder_field", 2),
    }


def convert_estimator(sd, grid_resolution: int):
    """nerfacc OccGridEstimator buffers -> (occs [res^3] f32, binaries
    [res, res, res] bool). Single-level grids only (the pipeline's)."""
    occs = _np(sd["occs"]).reshape(-1).astype(np.float32)
    if occs.size != grid_resolution**3:
        raise ValueError(
            f"estimator occs has {occs.size} cells, expected "
            f"{grid_resolution ** 3}; pass --grid_resolution"
        )
    binaries = _np(sd["binaries"]).astype(bool).reshape(
        grid_resolution, grid_resolution, grid_resolution)
    return occs, binaries


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--stage", type=int, required=True, choices=[1, 2, 4, 5])
    p.add_argument("--in", dest="inp", type=str, required=True)
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--blob_order", type=str, default="auto",
                   choices=["auto", "network_first", "encoding_first"])
    # reference model flags (same names and defaults as the trainers)
    p.add_argument("--num_lobes", type=int, default=3)
    p.add_argument("--log2_hashmap_size", type=int, default=19)
    p.add_argument("--n_levels", type=int, default=16)
    p.add_argument("--max_resolution", type=int, default=4096)
    p.add_argument("--hidden_size", type=int, default=64)
    p.add_argument("--num_layers", type=int, default=2)
    p.add_argument("--head", type=str, default="sg",
                   choices=["sg", "sg_old", "mlp", "none"])
    p.add_argument("--grid_resolution", type=int, default=128)
    p.add_argument("--unbounded", action="store_true")
    # field flags (stages 2 and 4: reference train_field.py / finetune)
    p.add_argument("--scale", type=float, default=0.5)
    p.add_argument("--field_log2_hashmap_size", type=int, default=24)
    p.add_argument("--field_max_res", type=int, default=512)
    p.add_argument("--field_hidden_size", type=int, default=32)
    return p


def convert_checkpoint(ckpt, args):
    """A reference checkpoint dict -> the port's checkpoint tree
    (tensors) for stage args.stage."""
    occs, binaries = convert_estimator(ckpt["estimator"],
                                       args.grid_resolution)
    ngp_cfg = NGPConfig(
        head=args.head, num_g_lobes=args.num_lobes,
        log2_hashmap_size=args.log2_hashmap_size,
        n_levels=args.n_levels, max_resolution=args.max_resolution,
        hidden_size=args.hidden_size, num_layers=args.num_layers,
        unbounded=args.unbounded,
    )
    field_cfg = FieldConfig(
        scale=args.scale, log2_hashmap_size=args.field_log2_hashmap_size,
        max_resolution=args.field_max_res,
        hidden_size=args.field_hidden_size,
    )
    if args.stage == 1:
        tree = {"params": convert_ngp(ckpt["model"], ngp_cfg,
                                      args.blob_order)}
    elif args.stage == 2:
        tree = {"field_params": convert_field(ckpt["model"], field_cfg)}
    elif args.stage == 4:
        tree = {
            "radiance_field": convert_ngp(ckpt["radiance_field"], ngp_cfg,
                                          args.blob_order),
            "field_model": convert_field(ckpt["field_model"], field_cfg),
        }
    else:
        tree = {"radiance_field": convert_ngp(ckpt["radiance_field"],
                                              ngp_cfg, args.blob_order)}
    tree = params_from_jax(tree)
    tree.update(occs=torch.from_numpy(occs),
                binaries=torch.from_numpy(binaries), step=0)
    return tree


def main(argv=None):
    args = build_parser().parse_args(argv)
    ckpt = torch.load(args.inp, map_location="cpu", weights_only=True)
    tree = convert_checkpoint(ckpt, args)
    save_checkpoint(args.out, tree)
    n = sum(t.numel() for t in _leaves(tree))
    print(f"wrote {args.out} ({n} params)")
    return tree


def _leaves(tree):
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return []


if __name__ == "__main__":
    main()
