"""The port's data parallelism (parallel/dp.py, parallel/multihost.py)
on the CPU: two gloo ranks on 127.0.0.1, spawned once for the module
(tests/torch_dp_ranks.py), run the stage-1 and stage-2 CLIs with
--num_devices 2, Stage1Trainer's DP step, the DP occupancy refresh and
Stage2Trainer's DP step on inputs this module wrote; the checks below
hold their readings against the port's single-device trainers and the
JAX package's on the same inputs. World size 1 runs in this process and
equals the single-device trainers bit for bit.

The DP steps run at unsaturated budgets (no rank truncates its samples,
as in tests/test_multichip.py), so the ranks' sample sets are the
single-device run's; one stage-2 case overruns a rank's budget and reads
how the dynamic batch moves. The stage-1 parity case runs its MLPs in float32:
in bfloat16 each rank rounds its partial weight gradient to bf16 before
the sum (the cast's transpose, in JAX as in the port), which is the
design's rounding and not a fault of the sum."""
import dataclasses
import multiprocessing
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import __graft_entry__ as ge
import torch_dp_ranks as ranks
from quadraturefields_tpu.data.fixture import (
    write_fixture_dataset as jax_write_fixture,
)
from quadraturefields_tpu.models.ngp import ngp_query_density as jax_density
from quadraturefields_tpu.ops import grid as jgrid
from quadraturefields_tpu_torch.data.fixture import write_fixture_dataset
from quadraturefields_tpu_torch.models.ngp import NGPConfig, ngp_query_density
from quadraturefields_tpu_torch.ops.grid import (
    OccGridConfig,
    OccGridState,
    occ_grid_update,
)
from quadraturefields_tpu_torch.parallel import dp, multihost
from quadraturefields_tpu_torch.render.renderer import render_rays_field
from quadraturefields_tpu_torch.train import stage1_ngp as tst1
from quadraturefields_tpu_torch.train import stage2_field as tst2
from quadraturefields_tpu_torch.utils.batching import bucket_num_rays
from quadraturefields_tpu_torch.utils.convert import params_from_jax
from test_torch_stage1_train import _trainers as stage1_trainers
from test_torch_stage2 import _field_leaves, _jax_loss_fn
from test_torch_stage2 import _trainers as stage2_trainers

torch.set_num_threads(1)

# a hang fails in bounded time: the ranks' whole run takes ~20 s on the CPU
JOIN_TIMEOUT_S = 240
# the truncating stage-2 case: a 2^12 budget (2^11 a rank), which rank
# 0's rays overrun (~3,090 samples) and rank 1's do not (~1,540), the
# dataset at 4,096 rays, the jitter from the generator at seed 7
TRUNCATING_RAYS, TRUNCATING_SEED, TRUNCATING_LOG2 = 4096, 7, 12
OCC_STEPS = (0, 512, 528)  # warm-up, partition 0, partition 1


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    """A params tree's leaves (torch or JAX) in sorted-key order, so that
    the two packages' trees line up."""
    return jax.tree_util.tree_leaves(tree)


def _stage1_inputs(root):
    """JAX's and the port's stage-1 trainers on the same weights,
    occupancy (the fixture sphere) and 256-ray batch, MLPs in float32, a
    2^14-sample budget (2^13 a rank); the jitter is JAX's draw."""
    jtr, ttr, (o, d, px, bkgd) = stage1_trainers(
        "synthetic", root, compute_dtype="float32")
    key = jax.random.PRNGKey(5)
    u = np.array(jax.random.uniform(key, (o.shape[0],)))
    config = {k: v for k, v in dataclasses.asdict(ttr.cfg).items()
              if k not in ("data_sharding", "num_devices")}
    batch = [torch.tensor(np.asarray(a, np.float32))
             for a in (o, d, px, bkgd, u)]
    inp = {"config": config, "params": _detached(ttr.params),
           "occs": ttr.occ_state.occs.clone(),
           "binaries": ttr.occ_state.binaries.clone(), "batch": batch}
    return {"jtr": jtr, "ttr": ttr, "key": key, "batch": batch}, inp


def _stage1_jax(s1):
    """JAX's single-device loss, num_valid and gradients on s1's inputs."""
    jtr = s1["jtr"]
    o, d, px, bkgd, _ = (jnp.asarray(a.numpy()) for a in s1["batch"])
    (lj, auxj), gj = jax.jit(jax.value_and_grad(jtr._loss_fn, has_aux=True))(
        jtr.params, jtr.occ_state, o, d, px, bkgd, s1["key"])
    return float(lj), int(auxj["num_valid"]), _np(gj)


def _detached(tree):
    return ranks.tree_map(lambda t: t.detach().clone(), tree)


def _occ_inputs():
    """tests/test_multichip.py's occupancy case: __graft_entry__'s tiny
    NGP (JAX's init), a 16^3 grid in 4 partitions with a 256-step
    warm-up, from an empty grid; each step's input state is JAX's output
    of the previous one, its jitter JAX's draw from PRNGKey(step). The
    table is scaled by 1e4, as the other tests of the port against JAX
    scale it: at JAX's init every density is exp(-1) within 6e-6, the
    threshold is their mean, and the two packages' f32 ulps flip cells
    (the port's DP refresh equals its single-device one bit for bit at
    that init too)."""
    aabb, jcfg, rcfg, _, params, _ = ge._tiny_setup()
    params = {**params, "table": params["table"] * 1e4}
    occ_cfg = jgrid.OccGridConfig(resolution=16, partitions=4,
                                  warmup_steps=256)
    res, step_size = occ_cfg.resolution, rcfg.render_step_size
    state = jgrid.OccGridState(
        occs=jnp.zeros((res**3,), jnp.float32),
        binaries=jnp.ones((res,) * 3, bool), aabb=jnp.asarray(aabb))

    def occ_eval_fn(x):
        return jax_density(params, x, jnp.asarray(aabb), jcfg)[..., 0] \
            * step_size

    cases, refs = [], []
    part = res**3 // occ_cfg.partitions
    for step in OCC_STEPS:
        key = jax.random.PRNGKey(step)
        jitter = jax.random.uniform(key, (part, 3))
        cases.append((step, torch.tensor(np.asarray(state.occs)),
                      torch.tensor(np.asarray(state.binaries)),
                      torch.tensor(np.asarray(jitter))))
        # eagerly, as tests/test_multichip.py runs it: jitted XLA fuses
        # the bf16 density MLP and moves a few cells by ~4e-4 relative
        state = jgrid.occ_grid_update(state, jnp.int32(step), key,
                                      occ_eval_fn, occ_cfg)
        refs.append((np.asarray(state.occs), np.asarray(state.binaries)))
    inp = {"aabb": torch.tensor(np.asarray(aabb), dtype=torch.float32),
           "ngp_cfg": dataclasses.asdict(jcfg),
           "occ_cfg": dataclasses.asdict(occ_cfg), "step_size": step_size,
           "params": params_from_jax(_np(params)), "cases": cases}
    return refs, inp


def _field_inputs():
    """tests/test_torch_stage2.py's stage-2 trainers (the fixture
    sphere's occupancy, 96 rays), with the last 24 rays turned away from
    the box: rank 1 (rays 48-95) composites fewer valid samples than
    rank 0. The budget is 2^13, 2^12 a rank."""
    jtr, ttr, (o, d, px, bkgd) = stage2_trainers("synthetic")
    d = d.copy()
    d[72:] *= -1.0
    key = jax.random.PRNGKey(5)
    u = np.array(jax.random.uniform(key, (o.shape[0],)))
    config = {k: v for k, v in dataclasses.asdict(ttr.cfg).items()
              if k != "num_devices"}
    inp = {"config": config, "ngp_params": _detached(ttr.ngp_params),
           "field_params": _detached(ttr.field_params),
           "occs": ttr.occ_state.occs.clone(),
           "binaries": ttr.occ_state.binaries.clone(),
           "batch": [torch.as_tensor(a) for a in (o, d, px, bkgd, u)],
           "num_rays": TRUNCATING_RAYS, "seed": TRUNCATING_SEED,
           "batch_size_log2": TRUNCATING_LOG2}
    return {"jtr": jtr, "ttr": ttr, "key": key,
            "batch": (o, d, px, bkgd), "u": u}, inp


def _field_jax(s2):
    """JAX's single-device stage-2 loss, n_valid and field gradients on
    s2's inputs, and its field after one full step (Adam)."""
    jtr = s2["jtr"]
    (lj, nvj), gj = jax.jit(jax.value_and_grad(
        _jax_loss_fn(jtr, s2["batch"], s2["key"]), has_aux=True))(
        jtr.field_params)
    jfp, _, _, _, _ = jtr._train_step(
        jtr.field_params, jtr.opt_state, jtr.ngp_params, jtr.occ_state,
        *(jnp.asarray(a) for a in s2["batch"]), s2["key"])
    return float(lj), int(nvj), _np(gj), _np(jfp)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Writes the inputs, runs the two ranks (each join with a timeout),
    and returns the test side's trainers and references beside the
    ranks' readings."""
    work = str(tmp_path_factory.mktemp("dp"))
    write_fixture_dataset(os.path.join(work, "data"), res=16, n_train=2,
                          n_test=1)
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=ranks.rank_main, args=(r, 2, port, work))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        # the ranks run the CLIs meanwhile, then wait for the inputs
        root = os.path.join(work, "jax_fixture")
        jax_write_fixture(root, res=32, n_train=2, n_test=1)
        s1, in1 = _stage1_inputs(root)
        occ_refs, in_occ = _occ_inputs()
        s2, in2 = _field_inputs()
        tmp = os.path.join(work, "inputs.tmp")
        torch.save({"stage1": in1, "occ": in_occ, "field": in2}, tmp)
        os.replace(tmp, os.path.join(work, ranks.INPUTS))
        s1["jax"] = _stage1_jax(s1)
        s2["jax"] = _field_jax(s2)
        for p in procs:
            p.join(JOIN_TIMEOUT_S)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        assert not hung, f"ranks {hung} did not finish in {JOIN_TIMEOUT_S} s"
        assert [p.exitcode for p in procs] == [0, 0], \
            [p.exitcode for p in procs]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    outs = [torch.load(os.path.join(work, f"out{r}.pt"), weights_only=False)
            for r in range(2)]
    return {"work": work, "outs": outs, "stage1": s1, "occ_refs": occ_refs,
            "occ_in": in_occ, "field": s2, "field_in": in2}


# (a) the batch slice of each rank

@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_process_local_slice_tiles_the_batch(world):
    """Each rank's slice is contiguous, the same size, and the ranks'
    slices in order tile the batch; shard_batch cuts every array so."""
    n = 2048
    got = [multihost.process_local_slice(n, world, r) for r in range(world)]
    assert got == [(r * n // world, n // world) for r in range(world)]
    a, b = torch.arange(n), torch.arange(3 * n).reshape(n, 3)
    parts = [multihost.shard_batch((a, b), world, r) for r in range(world)]
    assert torch.equal(torch.cat([p[0] for p in parts]), a)
    assert torch.equal(torch.cat([p[1] for p in parts]), b)


def test_process_local_slice_refuses_a_ragged_batch():
    with pytest.raises(ValueError, match="not divisible"):
        multihost.process_local_slice(1000, 3, 0)
    with pytest.raises(ValueError, match="not divisible"):
        multihost.shard_batch((torch.zeros(7, 3),), 2, 1)


# (b) the stage-1 step over two ranks

def _single_stage1(s1):
    """The port's single-device step (Stage1Trainer._train_step_impl) on
    the global batch: (loss, num_valid, grads, params after, lr)."""
    ttr = s1["ttr"]
    lr = float(ttr.optimizer.param_groups[0]["lr"])
    loss, aux = ttr._train_step_impl(*s1["batch"])
    return (float(loss), int(aux["num_valid"]),
            _leaves(ranks.tree_map(ranks.grad, ttr.params)),
            _leaves(ranks.tree_map(torch.Tensor.detach, ttr.params)), lr)


def test_dp_stage1_step_matches_the_single_device_step(spawned):
    """Two ranks against the single-device step on the global batch: the
    loss within 1e-6 relative, num_valid equal, every gradient within
    1e-5 of its max, every weight after Adam within 2 lr (its first
    step moves each entry by lr * sign(g)); both ranks' weights equal
    bit for bit. No rank truncated its samples."""
    r0, r1 = (o["stage1"] for o in spawned["outs"])
    s1 = spawned["stage1"]
    if "single" not in s1:
        s1["single"] = _single_stage1(s1)
    loss, nv, grads, params, lr = s1["single"]
    assert r0["digest"] == r1["digest"]
    assert r0["num_valid"] == nv > 0
    assert nv <= r0["budget"], "a rank truncated its samples"
    np.testing.assert_allclose(r0["loss"], loss, rtol=1e-6)
    for g_dp, g in zip(_leaves(r0["grads"]), grads, strict=True):
        assert float((g_dp - g).abs().max()) <= 1e-5 * float(g.abs().max())
    for p_dp, p in zip(_leaves(r0["params"]), params, strict=True):
        assert float((p_dp - p).abs().max()) <= 2.0001 * lr


def test_dp_stage1_step_matches_jax(spawned):
    """Two ranks against JAX's single-device step on the same weights,
    batch and jitter, at the single-device tests' tolerances: num_valid
    equal, the loss within 1e-3 relative, each gradient with cosine >=
    0.999 and norm within 1%."""
    r0 = spawned["outs"][0]["stage1"]
    lj, nvj, gj = spawned["stage1"]["jax"]
    assert r0["num_valid"] == nvj
    np.testing.assert_allclose(r0["loss"], lj, rtol=1e-3)
    for a, b in zip(_leaves(r0["grads"]), _leaves(gj), strict=True):
        a, b = a.numpy().ravel(), np.asarray(b).ravel()
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        assert nb > 0
        assert a @ b / (na * nb) >= 0.999
        assert abs(na / nb - 1.0) <= 0.01


# (c) the occupancy refresh over two ranks

@pytest.mark.parametrize("case", range(len(OCC_STEPS)),
                         ids=[f"step{s}" for s in OCC_STEPS])
def test_dp_occ_update_matches_single_device_and_jax(spawned, case):
    """make_dp_occ_eval over two ranks against the port's
    occ_grid_update and JAX's on the same state and jitter (warm-up,
    then partitions 0 and 1): binaries equal, occs within 1e-5 relative
    and 1e-6 absolute, as tests/test_multichip.py holds JAX's; both ranks
    return the same state."""
    inp = spawned["occ_in"]
    step, occs, binaries, jitter = inp["cases"][case]
    (o0, b0), (o1, b1) = (o["occ"][case] for o in spawned["outs"])
    assert torch.equal(o0, o1) and torch.equal(b0, b1)
    cfg = NGPConfig(**inp["ngp_cfg"])

    def fn(x):
        return ngp_query_density(inp["params"], x, inp["aabb"], cfg)[..., 0] \
            * inp["step_size"]

    with torch.no_grad():
        ref = occ_grid_update(
            OccGridState(occs=occs, binaries=binaries, aabb=inp["aabb"]),
            step, fn, OccGridConfig(**inp["occ_cfg"]), jitter=jitter)
    np.testing.assert_array_equal(b0.numpy(), ref.binaries.numpy())
    np.testing.assert_allclose(o0.numpy(), ref.occs.numpy(), rtol=1e-5,
                               atol=1e-6)
    jocc, jbin = spawned["occ_refs"][case]
    np.testing.assert_array_equal(b0.numpy(), jbin)
    np.testing.assert_allclose(o0.numpy(), jocc, rtol=1e-5, atol=1e-6)


# (d) the stage-2 step over two ranks with unequal valid counts

def _local_valid_counts(s2):
    """Each rank's valid samples, from its own slice and budget."""
    ttr = s2["ttr"]
    o, d, _, bkgd = (torch.as_tensor(a) for a in s2["batch"])
    u = torch.as_tensor(s2["u"])
    rcfg = dp.local_rcfg(ttr.rcfg, 2)
    counts = []
    with torch.no_grad():
        for r in range(2):
            ol, dl, ul = multihost.shard_batch((o, d, u), 2, r)
            res = render_rays_field(
                ttr.ngp_params, ttr.aabb, ttr.ngp_cfg, ttr.occ_state, ol, dl,
                rcfg, render_bkgd=bkgd, stratified=True, t_jitter=ul)
            counts.append(int(res.valid.sum()))
    return counts


def test_dp_field_step_matches_the_single_device_step(spawned):
    """Two ranks with unequal valid counts against Stage2Trainer's
    single-device step on the global batch (a masked mean over all valid
    samples): n_valid the single-device count, the loss within 1e-6
    relative, every gradient within 1e-5 of its max, every weight after
    Adam within 2 lr; both ranks' weights equal bit for bit."""
    s2 = spawned["field"]
    r0, r1 = (o["field"] for o in spawned["outs"])
    counts = _local_valid_counts(s2)
    assert counts[0] > counts[1] > 0, counts
    ttr = s2["ttr"]
    lr = float(ttr.optimizer.param_groups[0]["lr"])
    tb = [torch.as_tensor(a) for a in s2["batch"]]
    loss, aux = ttr._train_step_impl(*tb, torch.as_tensor(s2["u"]))
    s2["single"] = (float(loss), int(aux["num_valid"]))
    assert r0["digest"] == r1["digest"]
    assert r0["n_valid"] == int(aux["num_valid"]) == sum(counts)
    # each rank kept fewer samples than its budget: none truncated
    assert max(counts) < ttr.rcfg.max_samples_total // 2
    np.testing.assert_allclose(r0["loss"], float(loss), rtol=1e-6)
    for (name, g_dp), (_, p) in zip(_field_leaves(r0["grads"]),
                                    _field_leaves(ttr.field_params)):
        g = p.grad
        err = float((g_dp - g).abs().max())
        assert err <= 1e-5 * float(g.abs().max()), name
    for (name, p_dp), (_, p) in zip(_field_leaves(r0["params"]),
                                    _field_leaves(ttr.field_params)):
        assert float((p_dp - p.detach()).abs().max()) <= 2.0001 * lr, name


def test_dp_field_step_matches_jax(spawned):
    """Two ranks against JAX's single-device stage-2 step on the same
    NGP, field, rays and jitter: n_valid equal, the loss within 1e-4
    relative, each field gradient with cosine >= 0.999 and norm within
    1% (the output bias's is 0 in both), and every weight after Adam
    within 2 lr of JAX's, as tests/test_torch_stage2.py holds the
    single-device step."""
    r0 = spawned["outs"][0]["field"]
    lj, nvj, gj, jfp = spawned["field"]["jax"]
    assert r0["n_valid"] == nvj
    np.testing.assert_allclose(r0["loss"], lj, rtol=1e-4)
    last_b = f"{len(gj['decoder']['layers']) - 1}.b"
    for (name, g_dp), (_, g) in zip(_field_leaves(r0["grads"]),
                                    _field_leaves(gj)):
        b = np.asarray(g).ravel()
        a = g_dp.numpy().ravel()
        if name == last_b:
            assert not a.any() and not b.any()
            continue
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        assert nb > 0, name
        assert a @ b / (na * nb) >= 0.999, name
        assert abs(na / nb - 1.0) <= 0.01, name
    lr = 2e-2 * 0.01  # the schedule's first step: 1% of lr
    for (name, j), (_, p_dp) in zip(_field_leaves(jfp),
                                    _field_leaves(r0["params"])):
        assert np.abs(p_dp.numpy() - j).max() <= 2.0001 * lr, name


def test_dp_field_batch_follows_the_kept_samples(spawned):
    """One train_one_step of the DP field trainer and of the single
    device at a 2^12 budget on the same rays and jitter, rank 0 overrunning
    its 2^11 and rank 1 not. JAX's DP field step (dp.py:248) hands the
    dynamic batch the samples kept, summed over the ranks; stage 2's
    target equals its budget, so that sum never exceeds the target and
    the DP batch stays level or grows. One device hands it the rays'
    demand, and its batch shrinks. The port keeps both rules (ROADMAP
    Queue 3); this case pins them, so that a change to either is made on
    purpose."""
    t0, t1 = (o["field_truncating"] for o in spawned["outs"])
    assert t0["digest"] == t1["digest"]
    assert t0["demand"] > t0["budget"] == t0["kept"]
    assert t1["demand"] == t1["kept"] < t1["budget"]
    n_dp = t0["kept"] + t1["kept"]
    assert t0["n_valid"] == t1["n_valid"] == n_dp

    inp, ttr = spawned["field_in"], spawned["field"]["ttr"]
    cfg = dataclasses.replace(ttr.cfg, batch_size_log2=TRUNCATING_LOG2)
    single = tst2.Stage2Trainer(
        cfg, ngp_params=ttr.ngp_params, occ_state=ttr.occ_state,
        train_dataset=ranks.StandIn(inp["batch"][:4], TRUNCATING_RAYS),
        device="cpu")
    single.field_params = tst1._as_leaf_params(_detached(inp["field_params"]))
    single._make_optimizer()
    single.step = 1
    single.generator.manual_seed(TRUNCATING_SEED)
    _, n_single, _ = single.train_one_step()
    target = cfg.target_sample_batch_size
    assert n_single == t0["demand"] + t1["demand"] > target > n_dp
    assert single.train_dataset.num_rays == bucket_num_rays(
        TRUNCATING_RAYS * target / n_single, max_rays=cfg.max_num_rays)
    assert t0["num_rays"] == t1["num_rays"] == bucket_num_rays(
        TRUNCATING_RAYS * target / n_dp, max_rays=cfg.max_num_rays)
    assert single.train_dataset.num_rays < TRUNCATING_RAYS <= t0["num_rays"]


# (e) the CLIs over two ranks

def test_clis_train_over_two_ranks(spawned):
    """train_ngp and train_field with --num_devices 2 under two spawned
    ranks (each its own --root): both ranks joined a group of 2 from
    torchrun's environment, hold equal weights after each stage, and
    return the same eval metrics; rank 1 wrote no file; rank 0 wrote
    every artifact, and its checkpoints load into single-device
    trainers with the ranks' weights."""
    c0, c1 = (o["cli"] for o in spawned["outs"])
    assert (c0["world"], c0["rank"], c1["world"], c1["rank"]) == (2, 0, 2, 1)
    assert c0["ngp"] == c1["ngp"] and c0["field"] == c1["field"]
    for k in ("psnr", "ssim"):
        assert c0["metrics"][k] == c1["metrics"][k]
    assert np.isfinite(c0["metrics"]["psnr"])
    assert c1["files"] == []
    for f in ("results/fixture/nerf/args.json",
              "results/fixture/nerf/log.json", "ckpts/fixture/nerf/ngp.pt",
              "results/fixture/field/binaries.npy",
              "results/fixture/field/grids_valid.npy",
              "ckpts/fixture/field/field.pt"):
        assert f in c0["files"], f

    runs = os.path.join(spawned["work"], "runs0")
    data = os.path.join(spawned["work"], "data")
    ckpt = os.path.join(runs, "ckpts", "fixture", "nerf", "ngp.pt")
    cfg1 = tst1.Stage1Config(scene="fixture", data_root=data, num_lobes=0,
                             log2_hashmap_size=10, **ranks.CLI_STAGE1)
    t1 = tst1.Stage1Trainer(cfg1, device="cpu")
    t1.load(ckpt)
    assert t1.step == 4
    assert ranks.digest(tst1._leaves(t1.params)) == c0["ngp"]
    cfg2 = tst2.Stage2Config(scene="fixture", data_root=data, ckpt_path=ckpt,
                             num_lobes=0, log2_hashmap_size=10,
                             field_log2_hashmap_size=10, **ranks.CLI_STAGE2)
    t2 = tst2.Stage2Trainer(cfg2, device="cpu")
    t2.load(os.path.join(runs, "ckpts", "fixture", "field", "field.pt"))
    assert ranks.digest(tst1._leaves(t2.field_params)) == c0["field"]


def test_num_devices_without_a_process_group_is_refused(tmp_path):
    """--num_devices 2 outside a torchrun launch (no WORLD_SIZE) raises
    and trains nothing; so does a group of another size."""
    assert "WORLD_SIZE" not in os.environ
    assert not multihost.maybe_initialize_distributed("gloo")
    with pytest.raises(RuntimeError, match="torchrun"):
        multihost.world_and_rank(2)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(ValueError, match="nproc_per_node"):
            multihost.world_and_rank(2)
    finally:
        dist.destroy_process_group()


# (f) world size 1 is the single-device trainer

class _Views:
    """A fixed batch of the fixture's rays for both trainers."""
    HEIGHT = WIDTH = 8

    def __init__(self, batch, n):
        self.batch, self.num_rays = batch, n

    def __len__(self):
        return 1

    def update_num_rays(self, n):
        self.num_rays = n

    def fetch_train_batch(self):
        return self.batch


def _as_world_one(trainer):
    """A single-device trainer switched onto its DP path over the
    current group of one rank."""
    trainer._dp, trainer.world, trainer.rank = True, 1, 0
    return trainer


def test_world_size_one_is_the_single_device_trainer(tmp_path):
    """Over a gloo group of one rank, Stage1Trainer's DP path (the DP
    step and the DP occupancy refresh, two steps from step 0) and
    Stage2Trainer's DP step give the single-device trainers' losses,
    occupancy grid and weights bit for bit."""
    from quadraturefields_tpu_torch.data.nerf_synthetic import Rays

    write_fixture_dataset(str(tmp_path / "data"), res=16, n_train=2,
                          n_test=1)
    kw = dict(scene="fixture", data_root=str(tmp_path / "data"),
              n_levels=4, log2_hashmap_size=10, grid_resolution=32,
              init_batch_size=256, batch_size_log2=14)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        a = tst1.Stage1Trainer(tst1.Stage1Config(**kw), device="cpu")
        b = tst1.Stage1Trainer(tst1.Stage1Config(**kw), device="cpu")
        _as_world_one(b)
        for _ in range(2):
            la, _ = a.train_one_step()
            lb, _ = b.train_one_step()
            assert float(la) == float(lb)
        assert torch.equal(a.occ_state.occs, b.occ_state.occs)
        assert torch.equal(a.occ_state.binaries, b.occ_state.binaries)
        assert ranks.digest(tst1._leaves(a.params)) == \
            ranks.digest(tst1._leaves(b.params))

        kw2 = dict(scene="fixture", n_levels=4, log2_hashmap_size=10,
                   num_lobes=0, field_log2_hashmap_size=10,
                   field_max_res=64, grid_resolution=32, batch_size_log2=16)
        data = a.train_dataset.fetch_train_batch()
        data = {**data, "rays": Rays(data["rays"].origins[:32],
                                     data["rays"].viewdirs[:32]),
                "pixels": data["pixels"][:32]}
        ngp = tst1.Stage1Trainer(tst1.Stage1Config(
            **{**kw, "num_lobes": 0}), device="cpu")
        trainers = []
        for _ in range(2):
            t = tst2.Stage2Trainer(
                tst2.Stage2Config(**kw2), ngp_params=ngp.params,
                occ_state=a.occ_state, train_dataset=_Views(data, 32),
                device="cpu")
            trainers.append(t)
        c, e = trainers
        _as_world_one(e)
        for _ in range(2):
            lc, nc, mc = c.train_one_step()
            le, ne, me = e.train_one_step()
            assert float(lc) == float(le) and nc == ne > 0
            assert float(mc) == float(me)
        assert ranks.digest(tst1._leaves(c.field_params)) == \
            ranks.digest(tst1._leaves(e.field_params))
    finally:
        dist.destroy_process_group()
