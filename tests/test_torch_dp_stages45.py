"""Data parallelism of stages 4 and 5 (Stage4Trainer and Stage5Trainer
with num_devices 2, their CLIs, and the hit prefetcher that follows the
step) on the CPU: two gloo ranks on 127.0.0.1, spawned once for the
module (tests/torch_dp45_ranks.py), run the stage-4 and stage-5 CLIs
with --num_devices 2, the DP steps on inputs this module wrote, and a
stage-4 run through the live prefetcher with the dynamic batch moving
and a mesh update. The checks below hold their readings against the
port's single-device trainers and the JAX package's single-device
trainers on the same weights, hits and noise (JAX's own DP steps for
these stages fail on jax 0.9's shard_map check, ROADMAP Queue 3). World
size 1 runs in this process and equals the single-device trainers bit
for bit.

The steps run with f32 MLPs and at caps no rank overruns (the sample
sets are then the single device's), except the one case that overruns
a rank's cap on purpose."""
import dataclasses
import multiprocessing
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_dp45_ranks as ranks
import torch_dp_ranks
from quadraturefields_tpu_torch.data.fixture import write_fixture_dataset
from quadraturefields_tpu_torch.geometry.meshio import Mesh as TMesh
from quadraturefields_tpu_torch.geometry.meshio import save_ply
from quadraturefields_tpu_torch.parallel.multihost import shard_batch
from quadraturefields_tpu_torch.train import stage1_ngp as tst1
from quadraturefields_tpu_torch.train import stage4_finetune as tst4
from quadraturefields_tpu_torch.train import stage5_fit_sg as tst5
from test_torch_dp import _free_port
from test_torch_quadrature import leaves, sphere_mesh
from test_torch_stage4 import _Views
from test_torch_stage4 import hit_args as stage4_hit_args
from test_torch_stage4 import trainers as stage4_trainers
from test_torch_stage5 import step_inputs as stage5_inputs
from test_torch_stage5 import trainers as stage5_trainers

torch.set_num_threads(1)

# a hang fails in bounded time: the ranks' whole run takes ~30 s
JOIN_TIMEOUT_S = 240
SLACKS = (1.25, 0.0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _detached(tree):
    return torch_dp_ranks.tree_map(lambda t: t.detach().clone(), tree)


def _config(trainer) -> dict:
    return {k: v for k, v in dataclasses.asdict(trainer.cfg).items()
            if k not in ("num_devices", "pack_slack")}


def _restart(ttr, params):
    """A single-device stage-4 trainer set back to `params` (a fresh
    Adam, zero caches) for another step from the same state."""
    ttr.params = {k: tst1._as_leaf_params(_detached(v))
                  for k, v in params.items()}
    ttr._make_optimizer()
    n = ttr.mesh_intersect.n_faces
    ttr.cache_d = torch.zeros((n, 3))
    ttr.cache_w = torch.full((n,), 1e-8)


def _stage4_inputs():
    """Both packages' stage-4 trainers (tests/test_torch_stage4.py's,
    f32 MLPs) for each transport, one 96-ray batch, its hits and JAX's
    noise; the single-device port steps (frozen and joint, each from
    the same state) and JAX's loss and gradients at that state (eager,
    as the lockstep test holds them)."""
    refs = {}
    for slack in SLACKS:
        jtr, ttr, batch = stage4_trainers(slack)
        total, (jhit, thit) = stage4_hit_args(jtr, ttr, batch)
        o, d = batch["rays"]
        R, H = o.shape[0], jtr.cfg.max_hits
        key = jax.random.PRNGKey(100)
        noise = (torch.as_tensor(np.array(jax.random.uniform(key, (R,)))),
                 torch.as_tensor(np.array(
                     jax.random.uniform(key, (R, H, 3)))))
        args = (o, d, batch["pixels"], batch["color_bkgd"])
        start = {k: _detached(v) for k, v in ttr.params.items()}
        for freeze in (True, False):
            _restart(ttr, start)
            loss, nh, mse = ttr._train_step_impl(
                *(torch.as_tensor(a) for a in args), thit, *noise,
                freeze_rf=freeze)
            refs[slack, freeze] = dict(
                loss=float(loss), n_hits=int(nh), mse=float(mse),
                grads=[p.grad.clone() for _, p in leaves(ttr.params)],
                cache_d=ttr.cache_d.clone(), cache_w=ttr.cache_w.clone())
            if slack == SLACKS[0]:
                (jl, _), jg = jax.value_and_grad(jtr._loss_fn, has_aux=True)(
                    jtr.params, jtr.occ_state,
                    *(jnp.asarray(a) for a in args), jhit, key, freeze)
                refs[slack, freeze]["jax"] = (float(jl), _np(jg), total)
    inp = {"config": _config(ttr), "rf": _detached(start["rf"]),
           "field": _detached(start["field"]),
           "occs": ttr.occ_state.occs.clone(),
           "binaries": ttr.occ_state.binaries.clone(),
           "mesh": sphere_mesh(), "batch": args, "noise": noise,
           "pack_slacks": SLACKS,
           "prefetch": dict(batch_size_log2=10, init_batch_size=256,
                            max_num_rays=1 << 12)}
    return refs, ttr, inp


def _truncating_inputs(inp, ttr):
    """The packed stage-4 inputs with rays 72-95 turned away from the
    mesh: rank 0 (rays 0-47) casts more hits than rank 1 (48-95), and a
    per-rank cap between the two counts truncates rank 0's stream
    alone."""
    o, d, px, bkgd = inp["batch"]
    d = d.copy()
    d[72:] *= -1.0
    totals = [ttr.mesh_intersect.intersect_packed(ol, dl, 4096)[3]
              for ol, dl in (shard_batch((o, d), 2, r) for r in range(2))]
    assert totals[0] > totals[1] + 2, totals
    return {**inp, "batch": (o, d, px, bkgd),
            "config": {**inp["config"], "pack_slack": 1.25},
            "cap": (totals[0] + totals[1]) // 2, "totals": totals}


def _stage5_inputs():
    """Both packages' stage-5 trainers (tests/test_torch_stage5.py's,
    packed, f32 MLPs) and one 64-ray batch; the single-device port step
    and JAX's loss and gradients on it."""
    jtr, ttr = stage5_trainers(1.25)
    total, jargs, jhit, targs, thit = stage5_inputs(jtr, ttr, 0)
    (jl, _), jg = jax.value_and_grad(jtr._loss_fn, has_aux=True)(
        jtr.sg_params, *jargs, jhit)
    sg = _detached(ttr.sg_params)
    loss, nh, mse = ttr._train_step_impl(*targs, thit)
    ref = dict(loss=float(loss), n_hits=int(nh), mse=float(mse),
               grads=[p.grad.clone() for _, p in leaves(ttr.sg_params)],
               jax=(float(jl), _np(jg), total))
    inp = {"config": _config(ttr), "teacher": _detached(ttr.teacher_params),
           "sg": sg, "occs": ttr.occ_state.occs.clone(),
           "binaries": ttr.occ_state.binaries.clone(),
           "mesh": sphere_mesh(),
           "batch": tuple(a.numpy() for a in targs)}
    return ref, inp


def _write_cli_inputs(work):
    """The fixture dataset, an untrained stage-1 checkpoint (its table
    scaled by 1e4) and a sphere as stage 3's smp_mesh.ply, as
    tests/test_torch_stage5.py's chain starts."""
    data = os.path.join(work, "data")
    write_fixture_dataset(data, res=16, n_train=2, n_test=1)
    t1 = tst1.Stage1Trainer(tst1.Stage1Config(
        scene="fixture", data_root=data, root=work, num_lobes=0,
        log2_hashmap_size=10, grid_resolution=32), device="cpu")
    with torch.no_grad():
        t1.params["table"].mul_(1e4)
    t1.save(os.path.join(work, "ngp.pt"))
    verts, faces = sphere_mesh(16)
    save_ply(os.path.join(work, "smp_mesh.ply"), TMesh(verts * 1.5, faces))


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Writes the CLIs' inputs, starts the two ranks, writes the steps'
    inputs while they run the CLIs, computes the references, and joins
    the ranks (with a timeout); returns the references beside the
    ranks' readings."""
    work = str(tmp_path_factory.mktemp("dp45"))
    _write_cli_inputs(work)
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=ranks.rank_main, args=(r, 2, port, work))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        refs4, ttr4, in4 = _stage4_inputs()
        in4["truncating"] = _truncating_inputs(in4, ttr4)
        ref5, in5 = _stage5_inputs()
        tmp = os.path.join(work, "inputs.tmp")
        torch.save({"stage4": in4, "stage5": in5}, tmp)
        os.replace(tmp, os.path.join(work, torch_dp_ranks.INPUTS))
        # the single-device run through the prefetcher, meanwhile
        single = ranks.prefetched_run(work, in4, 0)
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
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
    return {"work": work, "outs": outs, "refs4": refs4, "in4": in4,
            "ref5": ref5, "single_prefetched": single}


def _grads_match_jax(grads, jgrads, rtol=1e-4):
    """Every leaf of a torch gradient tree within rtol of max |JAX grad|
    of JAX's (test_torch_quadrature.assert_grads_match's rule)."""
    for (name, g), (jname, j) in zip(leaves(grads), leaves(jgrads),
                                     strict=True):
        assert name == jname
        j = np.asarray(j)
        assert np.abs(j).max() > 0, name
        assert np.abs(g.numpy() - j).max() <= rtol * np.abs(j).max(), name


def _max_rel(got, want) -> float:
    """max |got - want| over max |want| (0 where both are 0)."""
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    return err / scale if scale > 0 else err


# (a) the stage-4 step over two ranks

@pytest.mark.parametrize("slack", SLACKS, ids=["packed", "dense"])
@pytest.mark.parametrize("freeze", [True, False], ids=["frozen", "joint"])
def test_dp_stage4_step_matches_the_single_device_step(spawned, slack,
                                                       freeze):
    """Two ranks against Stage4Trainer's single-device step on the same
    state, global batch, hits and noise: the loss and the rgb MSE within
    1e-5 relative, the hit count equal, every gradient within 1e-5 of
    its max (zero where the single device's is: the frozen rf), the
    per-face caches within 1e-6 of max; both ranks' weights and caches
    equal bit for bit after the step."""
    r0, r1 = (o["stage4"][slack, freeze] for o in spawned["outs"])
    ref = spawned["refs4"][slack, freeze]
    assert r0["digest"] == r1["digest"]
    assert r0["n_hits"] == ref["n_hits"] > 100
    np.testing.assert_allclose(r0["loss"], ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(r0["mse"], ref["mse"], rtol=1e-5)
    for (name, g), want in zip(leaves(r0["grads"]), ref["grads"],
                               strict=True):
        assert _max_rel(g, want) <= 1e-5, name
    for k in ("cache_d", "cache_w"):
        assert _max_rel(r0[k], ref[k]) <= 1e-6, k
    assert float(ref["cache_w"].max()) > 1e-2


@pytest.mark.parametrize("freeze", [True, False], ids=["frozen", "joint"])
def test_dp_stage4_step_matches_jax(spawned, freeze):
    """Two ranks against JAX's single-device stage-4 loss and gradients
    (eager, on the same state, batch, hits and noise: JAX's draws of the
    twin's jitter and the barycentric uniforms), at
    tests/test_torch_stage4.py's lockstep tolerances: the loss within
    1e-5 relative, the hit count equal, every field gradient (and rf
    gradient, joint) within 1e-4 of max."""
    r0 = spawned["outs"][0]["stage4"][SLACKS[0], freeze]
    jl, jg, total = spawned["refs4"][SLACKS[0], freeze]["jax"]
    assert r0["n_hits"] == total
    np.testing.assert_allclose(r0["loss"], jl, rtol=1e-5)
    for part in ("field",) if freeze else ("field", "rf"):
        _grads_match_jax(r0["grads"][part], jg[part])


def test_dense_rows_gather_face_vertices_on_the_device():
    """The dense transport's face vertices come from the trainer's face
    table on its device (Stage4Trainer._hit_args): equal to the rows
    JAX's dense path ships from the host (MeshIntersection.face_vertices)
    for the same cast, -1 pads included."""
    jtr, ttr, batch = stage4_trainers(0.0)
    o, d = batch["rays"]
    tri, ts, valid = jtr.mesh_intersect.intersect_rows(o, d)
    assert (tri < 0).any() and (tri >= 0).any()
    _, (tri_t, _, _, fv) = ttr._hit_args((batch, tri, ts, valid))
    np.testing.assert_array_equal(tri_t.numpy(), tri)
    np.testing.assert_array_equal(
        fv.numpy(), np.asarray(jtr.mesh_intersect.face_vertices(tri)))


def test_dp_stage4_rank_that_overruns_its_cap(spawned):
    """A per-rank cap between the two ranks' hit counts: rank 0's stream
    truncates, rank 1's does not. The rank that truncates leaves the
    rays its stream cut out of its quadrature term (packed_ray_mask); its
    twin stays whole. The DP loss is then the plain mean of the two
    ranks' own losses (JAX's equal-shard weight: the truncating rank's
    fewer kept rays weigh as much as the other rank's), each the loss
    one device computes on that rank's slice and stream, except that
    each rank's hit mean of the regularizer weighs by its share of the
    rendered hits (2 n_r / N), so that the regularizer stays the mean
    over all rendered hits. The DP loss lies within 1e-6 of that; the
    hit count is the true demand, summed."""
    t0, t1 = (o["truncating"] for o in spawned["outs"])
    cap = spawned["in4"]["truncating"]["cap"]
    totals = spawned["in4"]["truncating"]["totals"]
    assert [t0["total"], t1["total"]] == totals
    assert t0["rendered"] == cap < t0["total"]
    assert t1["rendered"] == t1["total"] < cap
    assert t0["loss"] == t1["loss"]
    assert t0["n_hits"] == t1["n_hits"] == sum(totals)
    n = t0["rendered"] + t1["rendered"]
    want = sum(t["own_loss"] + t["reg"] * (2 * t["rendered"] / n - 1)
               for t in (t0, t1)) / 2
    np.testing.assert_allclose(t0["loss"], want, rtol=1e-6)


# (b) the stage-5 step over two ranks

def test_dp_stage5_step_matches_the_single_device_step_and_jax(spawned):
    """Two ranks against Stage5Trainer's single-device step on the same
    SG model, batch and hits: the loss and the rgb MSE within 1e-5
    relative, the hit count equal, every gradient within 1e-5 of its
    max, both ranks' weights equal bit for bit; and against JAX's
    single-device loss and gradients on the same inputs: the loss within
    1e-4 relative (tests/test_torch_stage5.py's lockstep tolerance), the
    hit count equal, every gradient within 1e-4 of max."""
    r0, r1 = (o["stage5"] for o in spawned["outs"])
    ref = spawned["ref5"]
    assert r0["digest"] == r1["digest"]
    assert r0["n_hits"] == ref["n_hits"] > 50
    np.testing.assert_allclose(r0["loss"], ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(r0["mse"], ref["mse"], rtol=1e-5)
    for (name, g), want in zip(leaves(r0["grads"]), ref["grads"],
                               strict=True):
        assert _max_rel(g, want) <= 1e-5, name
    jl, jg, total = ref["jax"]
    assert r0["n_hits"] == total
    np.testing.assert_allclose(r0["loss"], jl, rtol=1e-4)
    _grads_match_jax(r0["grads"], jg)


# (c) the prefetchers under ranks

def test_prefetchers_draw_the_same_batches_on_both_ranks(spawned):
    """A stage-4 run of PREFETCH_STEPS steps through each rank's own
    prefetch thread, with the dynamic batch moving and a mesh update
    after step PREFETCH_UPDATE_AT: at every step both ranks took a
    global batch of the same size and the same rays (sha256), and so
    did a single-device run of the same trainer; the batch size moved.
    The ranks' losses are equal."""
    a, b = (o["prefetched"] for o in spawned["outs"])
    single = spawned["single_prefetched"]
    assert len(a) == len(b) == len(single) == ranks.PREFETCH_STEPS
    assert [s[:2] for s in a] == [s[:2] for s in b]
    assert [s[:2] for s in a] == [s[:2] for s in single]
    assert [s[2] for s in a] == [s[2] for s in b]
    sizes = [s[0] for s in a]
    assert len(set(sizes)) >= 2, sizes
    assert all(n % 2 == 0 for n in sizes)


def _wait_for(cond, timeout_s=30.0):
    import time

    deadline = time.monotonic() + timeout_s
    while not cond():
        assert time.monotonic() < deadline, "the prefetch thread stalled"
        time.sleep(0.01)


def test_prefetcher_recasts_batches_drawn_before_a_mesh_update():
    """The prefetch thread draws ahead; after update_vertices, a batch it
    cast against the old mesh is cast again against the new one when
    next() takes it (its rays unchanged), and the batch sizes follow the
    requests in order: the first `depth` at num_rays, then one a
    next()."""
    from quadraturefields_tpu_torch.geometry.intersect import (
        HitPrefetcher,
        MeshIntersection,
    )

    verts, faces = sphere_mesh()
    mi = MeshIntersection(mesh=TMesh(verts, faces), simplify_mesh=False,
                          num_intersections=6)
    views = _Views(96)
    o, d = views.batch["rays"]
    sizes = []

    def make_batch(n):
        sizes.append(n)
        return views.batch

    pf = HitPrefetcher(make_batch, mi, depth=2, num_rays=64)
    try:
        first = pf.next(32)
        # let the thread cast the next two batches against the old mesh
        _wait_for(lambda: pf.q.qsize() >= 2)
        pf.update_vertices((verts * 1.5).astype(np.float32))
        second = pf.next(16)
        _wait_for(lambda: len(sizes) >= 4)
    finally:
        pf.stop()
    old = MeshIntersection(mesh=TMesh(verts, faces), simplify_mesh=False,
                           num_intersections=6).intersect_rows(o, d)
    new = mi.intersect_rows(o, d)
    assert not np.array_equal(old[1], new[1])
    np.testing.assert_array_equal(first[2], old[1])
    np.testing.assert_array_equal(second[2], new[1])
    assert sizes[:4] == [64, 64, 32, 16]


# (d) the CLIs over two ranks

def test_clis_train_over_two_ranks(spawned):
    """train_finetune and train_fit_sg with --num_devices 2 under two
    spawned ranks (each its own --root): both ranks joined a group of 2
    from torchrun's environment and hold equal weights and mesh after
    each stage; rank 1 wrote no file; rank 0 wrote one finetune.pt,
    mesh.ply and fit_sg.pt, and the checkpoints load into single-device
    trainers with the ranks' weights."""
    c0, c1 = (o["cli"] for o in spawned["outs"])
    assert (c0["world"], c0["rank"], c1["world"], c1["rank"]) == \
        ((2, 2), (0, 0), (2, 2), (1, 1))
    for k in ("finetune", "vertices", "fit_sg"):
        assert c0[k] == c1[k], k
    assert c1["files"] == []
    assert c0["files"] == ["ckpts/fixture/finetune/finetune.pt",
                           "ckpts/fixture/finetune_sg/fit_sg.pt",
                           "results/fixture/finetune/mesh.ply"]
    runs = os.path.join(spawned["work"], "runs0")
    state4 = torch.load(os.path.join(runs, c0["files"][0]),
                        weights_only=True)
    assert state4["step"] == 4
    assert torch_dp_ranks.digest(tst1._leaves(
        {"rf": state4["radiance_field"],
         "field": state4["field_model"]})) == c0["finetune"]
    state5 = torch.load(os.path.join(runs, c0["files"][1]),
                        weights_only=True)
    assert torch_dp_ranks.digest(tst1._leaves(
        state5["radiance_field"])) == c0["fit_sg"]


# (e) world size 1 is the single-device trainer

def _as_world_one(trainer):
    """A single-device trainer switched onto its DP path over the
    current group of one rank."""
    trainer._dp, trainer.world, trainer.rank = True, 1, 0
    return trainer


def test_world_size_one_is_the_single_device_trainer(spawned):
    """Over a gloo group of one rank, Stage4Trainer's DP path (its step
    and its DP occupancy refresh, 3 steps through the live prefetcher
    across the freeze) and Stage5Trainer's (2 steps) give the
    single-device trainers' losses, hit counts, weights and caches bit
    for bit."""
    work = spawned["work"]
    data = os.path.join(work, "data")
    kw = dict(scene="fixture", data_root=data, ckpt_path=os.path.join(
        work, "ngp.pt"), num_lobes=0, log2_hashmap_size=10,
        grid_resolution=32, field_log2_hashmap_size=10, field_max_res=32,
        batch_size_log2=10, init_batch_size=256, max_hits=8,
        freeze_rf_steps=1)
    verts, faces = sphere_mesh(16)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        t4 = []
        for _ in range(2):
            t4.append(tst4.Stage4Trainer(
                tst4.Stage4Config(**kw), mesh=TMesh(verts * 1.5, faces),
                device="cpu"))
        a, b = t4[0], _as_world_one(t4[1])
        try:
            for _ in range(3):
                la, na, ma = a.train_one_step()
                lb, nb, mb = b.train_one_step()
                assert (float(la), na, float(ma)) == (float(lb), nb,
                                                      float(mb))
        finally:
            a.prefetcher.stop()
            b.prefetcher.stop()
        assert torch_dp_ranks.digest(
            tst1._leaves(a.params) + [a.cache_d, a.cache_w]) == \
            torch_dp_ranks.digest(
                tst1._leaves(b.params) + [b.cache_d, b.cache_w])

        t5 = []
        for _ in range(2):
            t5.append(tst5.Stage5Trainer(
                tst5.Stage5Config(scene="fixture", data_root=data,
                                  num_lobes=2, log2_hashmap_size=10,
                                  grid_resolution=32, batch_size_log2=10,
                                  init_batch_size=256, max_hits=8),
                teacher_params=a.params["rf"], occ_state=a.occ_state,
                mesh=a.mesh_intersect.mesh, device="cpu"))
        c, e = t5[0], _as_world_one(t5[1])
        try:
            for _ in range(2):
                lc, nc, mc = c.train_one_step()
                le, ne, me = e.train_one_step()
                assert (float(lc), nc, float(mc)) == (float(le), ne,
                                                      float(me))
                assert nc > 0
        finally:
            c.prefetcher.stop()
            e.prefetcher.stop()
        assert torch_dp_ranks.digest(tst1._leaves(c.sg_params)) == \
            torch_dp_ranks.digest(tst1._leaves(e.sg_params))
    finally:
        dist.destroy_process_group()
