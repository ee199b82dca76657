"""The sample-axis render (parallel/sp.py: make_sp_render and
make_dp_sp_render) and the 2-D rank layout (multihost.make_rank_grid)
on the CPU: four gloo ranks on 127.0.0.1, spawned once for the module
(tests/torch_sp_ranks.py), render the cases below over groups of 1, 2
and 4 ranks and over a 2 x 2 grid; the checks hold their renders
against the port's single-device one-shot render and against JAX's
make_sp_render and make_dp_sp_render on the conftest's 8-device CPU
mesh, on the same rays and carried-across weights, at JAX's own test
tolerances (tests/test_multichip.py: rgb and opacity within 2e-4, depth
within 1e-3 where the opacity passes 1e-3, num_valid equal).

The cases, each at a budget no window overruns: "uniform" is
tests/test_multichip.py's _unsaturated_setup (every cell occupied, one
march level); "two_level" the fixture sphere's occupancy on a 128^3
grid with the two-level march (coarse factor 4), whose windows start
at per-ray planes; "early_stop" a dense field whose light is spent in
the first window, with early_stop_eps 1e-2."""
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
from jax.sharding import Mesh

import __graft_entry__ as ge
import torch_dp_ranks
import torch_sp_ranks as ranks
from quadraturefields_tpu.ops import grid as jgrid
from quadraturefields_tpu.parallel.dp import make_mesh
from quadraturefields_tpu.parallel.sp import make_dp_sp_render as jax_dp_sp
from quadraturefields_tpu.parallel.sp import make_sp_render as jax_sp
from quadraturefields_tpu_torch.models.ngp import NGPConfig
from quadraturefields_tpu_torch.ops.grid import (
    OccGridState,
    occ_grid_sampling,
)
from quadraturefields_tpu_torch.parallel import multihost
from quadraturefields_tpu_torch.render.renderer import (
    RenderConfig,
    render_rays_occgrid,
)
from quadraturefields_tpu_torch.utils.convert import params_from_jax
from test_torch_dp import _free_port
from test_torch_render_field import occupancy, rays

torch.set_num_threads(1)

JOIN_TIMEOUT_S = 240
CASES = ("uniform", "two_level", "early_stop")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cases():
    """Each case's JAX inputs (params, config, render config, occupancy,
    rays) and the port's copy of them."""
    aabb, jcfg, rcfg, _, params, occ = ge._tiny_setup()
    jcfg = dataclasses.replace(jcfg, compute_dtype="float32")
    rcfg = dataclasses.replace(rcfg, max_samples_total=1 << 15)
    o, d = ge._tiny_rays(24)
    out = {"uniform": (params, rcfg, occ.occs, occ.binaries, o, d)}
    occs, binaries = occupancy("synthetic", 128, rcfg.render_step_size)
    stride, dil = jgrid.resolve_coarse_stride(
        -1, np.asarray(aabb), 128, 4, rcfg.render_step_size)
    out["two_level"] = (
        params, dataclasses.replace(rcfg, coarse_factor=4,
                                    coarse_stride=stride,
                                    coarse_dilation=dil),
        occs, binaries, *rays("synthetic", 24))
    # a density that reaches opacity ~0.996 within ~0.6 of the box
    dense = _np(params)
    dense["table"] = dense["table"] * 1e3
    w = dense["mlp_base"]["layers"][1]["w"].copy()
    w[:, 0] = np.abs(w[:, 0]) * 50
    dense["mlp_base"]["layers"][1]["w"] = w
    out["early_stop"] = (dense, dataclasses.replace(rcfg,
                                                    early_stop_eps=1e-2),
                         occ.occs, occ.binaries, o, d)
    jax_in, port_in = {}, {}
    for name, (p, rc, occs, binaries, o, d) in out.items():
        jax_in[name] = dict(
            params=jax.tree_util.tree_map(jnp.asarray, p), rcfg=rc,
            occ=jgrid.OccGridState(jnp.asarray(occs), jnp.asarray(binaries),
                                   aabb),
            origins=jnp.asarray(o), viewdirs=jnp.asarray(d))
        port_in[name] = dict(
            aabb=torch.tensor(np.asarray(aabb), dtype=torch.float32),
            ngp_cfg=dataclasses.asdict(jcfg),
            rcfg=dataclasses.asdict(rc), params=params_from_jax(_np(p)),
            occs=torch.tensor(np.asarray(occs), dtype=torch.float32),
            binaries=torch.tensor(np.asarray(binaries)),
            origins=torch.tensor(np.asarray(o)),
            viewdirs=torch.tensor(np.asarray(d)))
    return aabb, jcfg, jax_in, port_in


def _single(case: dict):
    """The port's single-device one-shot render of a case on white."""
    occ = OccGridState(occs=case["occs"], binaries=case["binaries"],
                       aabb=case["aabb"])
    with torch.no_grad():
        r = render_rays_occgrid(
            case["params"], case["aabb"], NGPConfig(**case["ngp_cfg"]), occ,
            case["origins"], case["viewdirs"], RenderConfig(**case["rcfg"]),
            render_bkgd=torch.ones(3))
    return r.rgb, r.opacity, r.depth, int(r.num_valid)


def _jax_renders(aabb, jcfg, jax_in):
    """JAX's sharded renders of each case on 1, 2 and 4 devices and on a
    (2, 2) (data, sample) mesh."""
    out = {}
    devs = np.asarray(jax.devices()[:4]).reshape(2, 2)
    for name, c in jax_in.items():
        args = (c["params"], c["occ"], c["origins"], c["viewdirs"])
        for n in (1, 2, 4):
            r = jax_sp(make_mesh(n), aabb, jcfg, c["rcfg"])(
                *args, render_bkgd=jnp.ones(3))
            out[name, n] = tuple(np.asarray(a) for a in r)
        r = jax_dp_sp(Mesh(devs, ("data", "sample")), aabb, jcfg,
                      c["rcfg"])(*args, render_bkgd=jnp.ones(3))
        out[name, "dp_sp"] = tuple(np.asarray(a) for a in r)
    return out


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Starts the four ranks, writes the cases, computes the references
    meanwhile and joins the ranks (with a timeout)."""
    work = str(tmp_path_factory.mktemp("sp"))
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=ranks.rank_main,
                         args=(r, ranks.WORLD, port, work))
             for r in range(ranks.WORLD)]
    for p in procs:
        p.start()
    try:
        aabb, jcfg, jax_in, port_in = _cases()
        tmp = os.path.join(work, "inputs.tmp")
        torch.save(port_in, tmp)
        os.replace(tmp, os.path.join(work, torch_dp_ranks.INPUTS))
        single = {name: _single(c) for name, c in port_in.items()}
        jax_out = _jax_renders(aabb, jcfg, jax_in)
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        assert not hung, f"ranks {hung} did not finish in {JOIN_TIMEOUT_S} s"
        assert [p.exitcode for p in procs] == [0] * ranks.WORLD, \
            [p.exitcode for p in procs]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    outs = [torch.load(os.path.join(work, f"out{r}.pt"), weights_only=False)
            for r in range(ranks.WORLD)]
    return {"outs": outs, "single": single, "jax": jax_out,
            "inputs": port_in}


def _assert_render_close(got, want, label):
    """rgb and opacity within 2e-4, depth within 1e-3 where the opacity
    passes 1e-3, num_valid equal (JAX's tolerances)."""
    rgb, opacity, depth = (np.asarray(a) for a in got[:3])
    nv = got[3]
    w_rgb, w_op, w_depth = (np.asarray(a) for a in want[:3])
    np.testing.assert_allclose(rgb, w_rgb, atol=2e-4, err_msg=label)
    np.testing.assert_allclose(opacity, w_op, atol=2e-4, err_msg=label)
    hit = w_op[:, 0] > 1e-3
    np.testing.assert_allclose(depth[hit], w_depth[hit], rtol=1e-3,
                               atol=1e-3, err_msg=label)
    assert nv == int(want[3]), (label, nv, int(want[3]))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("world", [1, 2, 4])
def test_sp_render_matches_single_device_and_jax(spawned, case, world):
    """make_sp_render over `world` ranks against the port's one-shot
    render and against JAX's make_sp_render on `world` devices; every
    rank of the group returns the same render."""
    got = spawned["outs"][0][case, world]
    _assert_render_close(got, spawned["single"][case], f"{case} vs port")
    _assert_render_close(got, spawned["jax"][case, world], f"{case} vs jax")
    assert spawned["single"][case][3] > 0
    for r in range(1, world):
        other = spawned["outs"][r][case, world]
        assert all(torch.equal(a, b) for a, b in zip(got[:3], other[:3]))
        assert other[3] == got[3]


@pytest.mark.parametrize("case", CASES)
def test_dp_sp_render_matches_single_device_and_jax(spawned, case):
    """make_dp_sp_render on a 2 x 2 grid (rays over the columns, windows
    over the rows) against the one-shot render and JAX's
    make_dp_sp_render on a (2, 2) mesh; all four ranks return the same
    global render."""
    got = spawned["outs"][0][case, "dp_sp"]
    _assert_render_close(got, spawned["single"][case], f"{case} vs port")
    _assert_render_close(got, spawned["jax"][case, "dp_sp"],
                         f"{case} vs jax")
    for r in range(1, 4):
        other = spawned["outs"][r][case, "dp_sp"]
        assert all(torch.equal(a, b) for a, b in zip(got[:3], other[:3]))
        assert other[3] == got[3]


def test_sp_render_stratified_alignment(spawned):
    """With the stratified jitter on (one draw of u from the same
    generator state on every rank), the shift enters each window's near
    plane and the windows' knots stay on one global grid: the render
    over 2 ranks equals the render over 1, as JAX's test holds its
    own."""
    one = spawned["outs"][0]["stratified", 1]
    two = spawned["outs"][0]["stratified", 2]
    for a, b in zip(one[:2], two[:2]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-4)
    assert one[3] == two[3] > 0
    assert not torch.allclose(one[1], spawned["outs"][0]["uniform", 1][1],
                              atol=1e-6)


def test_early_stop_zeroes_the_later_window(spawned):
    """The early stop holds the global transmittance: on every ray whose
    light window 0 spends below early_stop_eps (exp(-tau_0) < 1e-2) and
    that goes on into window 1 (its optical depth there positive),
    window 1 contributes exactly nothing (its local transmittance starts
    at 1, so a local test would keep its weights); where window 0 leaves
    more light, window 1 adds to the opacity."""
    taus, part = spawned["outs"][1]["taus"], spawned["outs"][1]["part"]
    spent = torch.exp(-taus[0]) < 1e-2
    behind = spent & (taus[1] > 0)
    assert int(behind.sum()) >= 10
    assert bool((part[behind] == 0).all())
    assert bool((part[~spent, 3] > 0).any())


def test_rank_grid_layout(spawned):
    """make_rank_grid(2, 2): rank d * 2 + s sits in row d and place s;
    its sp group is its row (consecutive ranks), its dp group its
    column."""
    for rank, out in enumerate(spawned["outs"]):
        d, s = divmod(rank, 2)
        assert out["grid"] == (d, s, [s, s + 2], [2 * d, 2 * d + 1])


def test_rank_grid_refuses_another_world_size():
    """A grid whose size is not the group's raises."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(ValueError, match="2 x 2 grid"):
            multihost.make_rank_grid(2, 2)
    finally:
        dist.destroy_process_group()


def test_windows_tile_the_two_level_march():
    """occ_grid_sampling at per-ray near and far planes (the windows of
    make_sp_render), with the two-level march on the fixture sphere's
    128^3 grid: the samples of windows 0-3 of W = ceil(max_steps / 4)
    steps, taken together, are the one-shot march's sample set (each
    sample's ray and start within 1e-5), with a shared stratified shift
    u in the near plane as in the one-shot march's t_jitter."""
    aabb, _, rcfg, _, _, _ = ge._tiny_setup()
    dt = rcfg.render_step_size
    occs, binaries = occupancy("synthetic", 128, dt)
    stride, dil = jgrid.resolve_coarse_stride(-1, np.asarray(aabb), 128, 4,
                                              dt)
    aabb_t = torch.tensor(np.asarray(aabb), dtype=torch.float32)
    state = OccGridState(occs=torch.tensor(occs),
                         binaries=torch.tensor(binaries), aabb=aabb_t)
    o, d = (torch.tensor(a) for a in rays("synthetic", 64))
    u = torch.rand(64, generator=torch.Generator().manual_seed(3))
    kw = dict(max_samples_total=1 << 15, coarse_factor=4,
              coarse_stride=stride, coarse_dilation=dil,
              render_step_size=dt)
    full = occ_grid_sampling(state, o, d, max_steps=rcfg.max_steps,
                             stratified=True, t_jitter=u, **kw)
    from quadraturefields_tpu_torch.ops.grid import ray_aabb_intersect

    t_entry, _, _ = ray_aabb_intersect(o, d, aabb_t)
    base = t_entry + u * dt
    n, w = 4, -(-rcfg.max_steps // 4)
    parts = []
    for k in range(n):
        s = occ_grid_sampling(state, o, d, max_steps=w,
                              near_plane=base + k * w * dt,
                              far_plane=base + (k + 1) * w * dt, **kw)
        assert int(s.num_valid) == int(s.valid.sum())
        parts.append(s)
    assert sum(int(s.num_valid) for s in parts) == int(full.num_valid) > 0
    # more than one window holds samples
    assert sum(int(s.num_valid) > 0 for s in parts) >= 2

    def keyed(*samples):
        """Each valid sample's ray * 100 + start, sorted."""
        return torch.sort(torch.cat([
            s.ray_indices[s.valid].double() * 100.0
            + s.t_starts[s.valid].double() for s in samples])).values

    np.testing.assert_allclose(keyed(*parts).numpy(), keyed(full).numpy(),
                               rtol=0, atol=1e-5)
