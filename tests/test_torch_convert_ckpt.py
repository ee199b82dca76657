"""Checkpoint import into the port: the port's reference-checkpoint
converter (quadraturefields_tpu_torch/cli/convert_reference_ckpt.py)
against the JAX package's tool (tools/convert_reference_ckpt.py) plus
the port's carry-over (utils/convert.py), bit for bit, on the synthetic
reference state dicts that tests/test_convert_ckpt.py builds; and
tools/jax_ckpt_to_torch.py on a JAX stage-1 trainer saved with orbax,
whose converted checkpoint the port's trainer loads and renders as JAX
renders it."""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_convert_ckpt as jtool_test
from quadraturefields_tpu.data.fixture import FixtureScene, write_fixture_dataset
from quadraturefields_tpu.models.field import FieldConfig, field_init
from quadraturefields_tpu.models.ngp import NGPConfig, ngp_init
from quadraturefields_tpu.train import stage1_ngp as jst
from quadraturefields_tpu_torch.cli import convert_reference_ckpt as pcc
from quadraturefields_tpu_torch.train import stage1_ngp as tst
from quadraturefields_tpu_torch.utils.checkpoint import load_checkpoint
from quadraturefields_tpu_torch.utils.convert import (
    field_params_from_jax,
    params_from_jax,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
crc = jtool_test.crc   # the JAX package's tool, loaded by its own test

# the converter flags of the synthetic model: a small NGP (corner cube,
# 8 levels, 2^8 rows a level, resolution 64; the heads 64 wide, the
# width of the reference's tcnn "mlp" head) and a small field
NGP_FLAGS = dict(n_levels=8, log2_hashmap_size=8, max_resolution=64,
                 num_lobes=2, hidden_size=64, num_layers=2)
FIELD_FLAGS = dict(scale=0.5, field_log2_hashmap_size=8, field_max_res=64,
                   field_hidden_size=16)
GRID_RES = 16


def _ngp_cfg(head):
    f = NGP_FLAGS
    return NGPConfig(head=head, num_g_lobes=f["num_lobes"],
                     log2_hashmap_size=f["log2_hashmap_size"],
                     n_levels=f["n_levels"],
                     max_resolution=f["max_resolution"],
                     hidden_size=f["hidden_size"],
                     num_layers=f["num_layers"])


def _field_cfg():
    f = FIELD_FLAGS
    return FieldConfig(scale=f["scale"],
                       log2_hashmap_size=f["field_log2_hashmap_size"],
                       max_resolution=f["field_max_res"],
                       hidden_size=f["field_hidden_size"])


def _t(a):
    return torch.from_numpy(np.array(a))


def _linear_stack(sd, prefix, layers):
    for i, layer in enumerate(layers):
        name = (f"{prefix}.layers.{i}" if i < len(layers) - 1
                else f"{prefix}.lout")
        sd[f"{name}.weight"] = _t(np.asarray(layer["w"]).T)
        sd[f"{name}.bias"] = _t(np.asarray(layer["b"]))


def ngp_state_dict(head, seed, order):
    """A reference NGP state dict (the tcnn blob in `order`, the SG head
    as a BasicDecoder) of JAX's ngp_init at seed."""
    cfg = _ngp_cfg(head)
    params = jax.tree_util.tree_map(
        np.asarray, ngp_init(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    hg = cfg.hashgrid
    net = jtool_test._fused_blob(params["mlp_base"], hg.output_dim,
                                 1 + cfg.geo_feat_dim, rng)
    grid = params["table"].reshape(-1).astype(np.float32)
    blob = (np.concatenate([net, grid]) if order == "network_first"
            else np.concatenate([grid, net]))
    sd = {"mlp_base.params": _t(blob)}
    _linear_stack(sd, "mlp_head", params["mlp_head"]["layers"])
    return sd


def field_state_dict(seed):
    params = jax.tree_util.tree_map(
        np.asarray, field_init(jax.random.PRNGKey(seed), _field_cfg()))
    sd = {"xyz_encoder.params": _t(params["table"].reshape(-1))}
    _linear_stack(sd, "decoder_field", params["decoder"]["layers"])
    return sd


def estimator_state_dict(seed):
    occs = np.random.default_rng(seed).random(GRID_RES**3) \
        .astype(np.float32)
    return {"occs": _t(occs),
            "binaries": _t((occs > 0.5).reshape((GRID_RES,) * 3))}


def _argv(stage, inp, out, head, order):
    argv = ["--stage", str(stage), "--in", inp, "--out", out,
            "--head", head, "--grid_resolution", str(GRID_RES)]
    if order is not None:
        argv += ["--blob_order", order]
    for k, v in {**NGP_FLAGS, **FIELD_FLAGS}.items():
        argv += [f"--{k}", str(v)]
    return argv


def _assert_trees_equal(got, want, path="tree"):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_equal(g, w, f"{path}[{i}]")
    elif torch.is_tensor(want):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert torch.equal(got, want), path
    else:
        assert got == want, path


@pytest.mark.parametrize("stage,head,blob,order", [
    (1, "sg", "network_first", None), (1, "sg", "encoding_first", None),
    (1, "sg", "encoding_first", "encoding_first"),
    (1, "sg_old", "network_first", None), (2, "sg", "network_first", None),
    (4, "sg", "encoding_first", None),
    (5, "sg", "network_first", "network_first"),
])
def test_converter_matches_the_jax_tool(tmp_path, stage, head, blob, order):
    """A reference .pth of each stage through the port's converter CLI
    equals the JAX tool's conversion carried over with
    params_from_jax / field_params_from_jax, bit for bit, leaf for leaf:
    the tcnn blob in either order, autodetected (`order` None) or
    pinned; the table is the one the blob holds."""
    model = ngp_state_dict(head, stage, blob)
    ckpt = {"estimator": estimator_state_dict(stage)}
    if stage == 1:
        ckpt["model"] = model
    elif stage == 2:
        ckpt["model"] = field_state_dict(stage)
    elif stage == 4:
        ckpt.update(radiance_field=model, field_model=field_state_dict(7))
    else:
        ckpt["radiance_field"] = model
    inp, out = str(tmp_path / "ref.pth"), str(tmp_path / "port.pt")
    torch.save(ckpt, inp)
    pcc.main(_argv(stage, inp, out, head, order))
    got = load_checkpoint(out)

    blob_order = order or "auto"
    occs, binaries = crc.convert_estimator(ckpt["estimator"], GRID_RES)
    want = {"occs": _t(occs), "binaries": _t(binaries), "step": 0}
    cfg = _ngp_cfg(head)
    if stage == 1:
        want["params"] = params_from_jax(
            crc.convert_ngp(ckpt["model"], cfg, blob_order))
    elif stage == 2:
        want["field_params"] = field_params_from_jax(
            crc.convert_field(ckpt["model"], _field_cfg()))
    else:
        want["radiance_field"] = params_from_jax(
            crc.convert_ngp(ckpt["radiance_field"], cfg, blob_order))
        if stage == 4:
            want["field_model"] = field_params_from_jax(
                crc.convert_field(ckpt["field_model"], _field_cfg()))
    _assert_trees_equal(got, want)
    if stage != 2:
        # the table the reference blob holds, whatever its order
        key = "params" if stage == 1 else "radiance_field"
        jparams = jax.tree_util.tree_map(
            np.asarray, ngp_init(jax.random.PRNGKey(stage), cfg))
        np.testing.assert_array_equal(got[key]["table"].numpy(),
                                      jparams["table"])


def test_converter_refuses_what_the_jax_tool_refuses():
    """The cell layout and a blob of the wrong size raise, with the JAX
    tool's messages."""
    from quadraturefields_tpu_torch.models.ngp import NGPConfig as TNGP

    cfg = TNGP(layout="cell", n_levels=8, log2_hashmap_size=8,
               max_resolution=64)
    with pytest.raises(ValueError, match="corner"):
        pcc.convert_ngp({}, cfg)
    with pytest.raises(ValueError, match="corner"):
        pcc.convert_ngp({}, TNGP(interp="tet"))
    with pytest.raises(ValueError, match="params blob"):
        pcc.split_blob(np.zeros(100, np.float32), 64,
                       pcc.fused_mlp_widths(16, 13), "auto")
    with pytest.raises(ValueError, match="occs"):
        pcc.convert_estimator(estimator_state_dict(0), GRID_RES + 1)
    assert pcc.fused_mlp_widths(32, 16, n_hidden_layers=2) \
        == crc.fused_mlp_widths(32, 16, n_hidden_layers=2)
    # an "mlp" head reads geo_feat_dim = 15 features, not 16-aligned:
    # both tools refuse the tcnn head blob
    sd = ngp_state_dict("sg", 0, "network_first")
    widths = crc.fused_mlp_widths(15, 3, n_hidden_layers=2)
    sd["mlp_head.params"] = torch.zeros(sum(o * i for o, i in widths))
    for tool in (pcc, crc):
        with pytest.raises(ValueError, match="16-aligned"):
            tool.convert_ngp(sd, _ngp_cfg("mlp"))


def test_converted_stage1_checkpoint_loads_in_the_trainer(tmp_path):
    """Stage1Trainer.load takes a converted reference checkpoint (no
    Adam state: a fresh optimizer at step 0) at the matching config
    (corner cube, the converter's widths)."""
    sd = ngp_state_dict("sg", 3, "network_first")
    inp, out = str(tmp_path / "ngp.pth"), str(tmp_path / "ngp.pt")
    torch.save({"estimator": estimator_state_dict(3), "model": sd}, inp)
    pcc.main(["--stage", "1", "--in", inp, "--out", out,
              "--grid_resolution", str(GRID_RES), "--n_levels", "8",
              "--log2_hashmap_size", "8", "--num_lobes", "2"])
    cfg = tst.Stage1Config(n_levels=8, log2_hashmap_size=8, num_lobes=2,
                           interp="cube", grid_resolution=GRID_RES)

    class NoData:
        HEIGHT = WIDTH = 4

    tr = tst.Stage1Trainer(cfg, train_dataset=NoData(),
                           test_dataset=NoData(), device="cpu")
    tr.load(out)
    state = load_checkpoint(out)
    assert tr.step == 0
    assert torch.equal(tr.params["table"], state["params"]["table"])
    assert tr.params["table"].shape == (tr.ngp_cfg.hashgrid.total_entries,
                                        2)
    assert torch.equal(tr.occ_state.binaries, state["binaries"])


def _load_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_ckpt_to_torch", os.path.join(REPO, "tools",
                                          "jax_ckpt_to_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_jax_orbax_checkpoint_renders_the_same_in_the_port(tmp_path):
    """A tiny JAX stage-1 trainer (f32 MLPs, its table lifted off the
    init, the fixture sphere's occupancy, two training steps) saved with
    orbax, converted by tools/jax_ckpt_to_torch.py and loaded by the
    port's Stage1Trainer: the port renders a view within 1e-5 of JAX's,
    and holds JAX's weights, grid and step exactly."""
    data = str(tmp_path / "data")
    write_fixture_dataset(data, res=24, n_train=2, n_test=1)
    kw = dict(scene="fixture", data_root=data, n_levels=4,
              log2_hashmap_size=10, grid_resolution=32, batch_size_log2=12,
              eval_chunk=1024, eval_renderer="oneshot",
              compute_dtype="float32", root=str(tmp_path / "runs"))
    jtr = jst.Stage1Trainer(jst.Stage1Config(**kw))
    jtr.params["table"] = jtr.params["table"] * 1e4
    for _ in range(2):
        jtr.train_one_step()
    res = jtr.occ_cfg.resolution
    lin = np.linspace(-1.5, 1.5, res)
    grid = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1)
    occs = (FixtureScene().sigma(grid.reshape(-1, 3)) * 5e-3) \
        .astype(np.float32)
    jtr.occ_state = jtr.occ_state._replace(
        occs=jnp.asarray(occs),
        binaries=jnp.asarray((occs > 0.01).reshape(res, res, res)))
    ckpt = str(tmp_path / "jax_ckpt")
    jtr.save(ckpt)
    out = str(tmp_path / "ngp.pt")
    _load_tool().main(["--in", ckpt, "--out", out])

    ttr = tst.Stage1Trainer(tst.Stage1Config(**kw), device="cpu")
    ttr.load(out)
    assert ttr.step == jtr.step == 2
    _assert_trees_equal(
        jax.tree_util.tree_map(lambda t: t.detach(), ttr.params),
        params_from_jax(jax.tree_util.tree_map(np.asarray, jtr.params)))
    np.testing.assert_array_equal(ttr.occ_state.binaries.numpy(),
                                  np.asarray(jtr.occ_state.binaries))
    view = ttr.test_dataset.fetch_eval_view(0)
    want = np.asarray(jtr.render_view(view))
    got = ttr.render_view(view).numpy()
    assert got.min() < 0.9   # the sphere shows against white
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _port_trainer(stage):
    """A small port trainer of stage 2, 4 or 5 on the CPU (stage 4's and
    5's prefetchers stopped) and the key of its model tree in a
    checkpoint."""
    from quadraturefields_tpu_torch.geometry.meshio import Mesh
    from quadraturefields_tpu_torch.models.ngp import ngp_init
    from quadraturefields_tpu_torch.train import stage2_field as tst2
    from quadraturefields_tpu_torch.train import stage4_finetune as tst4
    from quadraturefields_tpu_torch.utils.convert import occ_state_from_jax
    from test_torch_quadrature import SMALL, sphere_mesh
    from test_torch_render_field import occupancy
    from test_torch_stage4 import _Views

    if stage == 5:
        from test_torch_stage5 import trainers

        return trainers(1.25)[1], "radiance_field"
    gen = torch.Generator().manual_seed(0)
    if stage == 2:
        cfg = tst2.Stage2Config(
            n_levels=4, log2_hashmap_size=12, num_lobes=0,
            field_log2_hashmap_size=12, field_max_res=64, scene="fixture")
    else:
        cfg = tst4.Stage4Config(**SMALL, scene="fixture", max_hits=6)
    occ = occ_state_from_jax(*occupancy("synthetic", cfg.grid_resolution,
                                        cfg.render_step_size), cfg.aabb)
    ngp = ngp_init(gen, cfg.ngp_config())
    if stage == 2:
        return tst2.Stage2Trainer(cfg, ngp_params=ngp, occ_state=occ,
                                  train_dataset=_Views(),
                                  device="cpu"), "field_params"
    tr = tst4.Stage4Trainer(cfg, ngp_params=ngp, mesh=Mesh(*sphere_mesh()),
                            occ_state=occ, train_dataset=_Views(),
                            device="cpu")
    tr.prefetcher.stop()
    return tr, "field_model"


@pytest.mark.parametrize("stage", [2, 4, 5])
def test_trainers_load_checkpoints_without_adam_state(tmp_path, stage):
    """Stage{2,4,5}Trainer.load takes a checkpoint without "opt_state",
    as both converters write them: the weights and the step arrive, and
    Adam starts fresh."""
    tr, key = _port_trainer(stage)
    path = str(tmp_path / "ckpt.pt")
    tr.step = 7
    tr.save(path)
    state = load_checkpoint(path)
    del state["opt_state"]
    torch.save(state, path)
    tr.step = 0
    tr.load(path)
    assert tr.step == 7
    assert not tr.optimizer.state_dict()["state"]
    params = (tr.field_params if stage == 2 else tr.params["field"]
              if stage == 4 else tr.sg_params)
    assert torch.equal(params["table"], state[key]["table"])
