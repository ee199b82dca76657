"""The port's occupancy grid and ray march against the JAX package.

The march compares packed sample buffers: ray indices and validity
exactly, t within 1e-6 (the same f32 knot arithmetic; 1e-6 absorbs a
contracted multiply-add on either side at t ~ 5).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from quadraturefields_tpu.data.fixture import FixtureScene
from quadraturefields_tpu.ops import grid as jg
from quadraturefields_tpu_torch.ops import grid as tg

torch.set_num_threads(1)

AABB = np.array([-1.5, -1.5, -1.5, 1.5, 1.5, 1.5], np.float32)
DT = 5e-3


def _fixture_binaries(res):
    """The fixture sphere's occupancy, filled as bench.py fills it."""
    lin = np.linspace(-1.5, 1.5, res)
    grid = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1)
    occs = FixtureScene().sigma(grid.reshape(-1, 3)) * DT
    return (occs > 0.01).reshape(res, res, res)


def _rays(n, seed=0):
    """Rays from a sphere of cameras toward the scene centre, plus a
    few that miss the box."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, 2 * np.pi, n)
    phi = rng.uniform(0.5, 2.6, n)
    eye = 4 * np.stack([np.cos(theta) * np.sin(phi),
                        np.sin(theta) * np.sin(phi), np.cos(phi)], -1)
    target = rng.uniform(-0.6, 0.6, (n, 3))
    target[: n // 16] = eye[: n // 16] * 2.0        # pointing away: miss
    d = target - eye
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return eye.astype(np.float32), d.astype(np.float32)


def _assert_same_samples(t, j):
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    np.testing.assert_array_equal(t.ray_indices.numpy(),
                                  np.asarray(j.ray_indices))
    np.testing.assert_allclose(t.t_starts.numpy(), np.asarray(j.t_starts),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(t.t_ends.numpy(), np.asarray(j.t_ends),
                               rtol=0, atol=1e-6)
    assert int(t.num_valid) == int(j.num_valid)


def test_ray_aabb_intersect_and_lookup_match_jax():
    o, d = _rays(512, 1)
    d[:4] = [[1, 0, 0], [0, 1, 0], [0, 0, -1], [0, 0, 1]]   # zero components
    jt = jg.ray_aabb_intersect(jnp.asarray(o), jnp.asarray(d),
                               jnp.asarray(AABB))
    tt = tg.ray_aabb_intersect(torch.as_tensor(o), torch.as_tensor(d),
                               torch.as_tensor(AABB))
    for a, b in zip(tt, jt):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    b = _fixture_binaries(64)
    x = np.random.default_rng(2).uniform(-2, 2, (4000, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tg.occupancy_lookup(torch.as_tensor(b), torch.as_tensor(AABB),
                            torch.as_tensor(x)).numpy(),
        np.asarray(jg.occupancy_lookup(jnp.asarray(b), jnp.asarray(AABB),
                                       jnp.asarray(x))))


def test_static_step_bounds_and_resolvers_match_jax():
    assert tg.max_march_steps(AABB, DT) == jg.max_march_steps(AABB, DT)
    for args in [(0.2, 1e2, 1e-3, 0.004), (0.0, 3.0, 1e-2, 0.0),
                 (2.0, 6.0, 5e-3, 0.01)]:
        assert tg.max_march_steps_cone(*args) == \
            jg.max_march_steps_cone(*args)
    for setting in (-1, 0, 6):
        for res, cf in ((128, 4), (64, 2), (128, 1)):
            assert tg.resolve_coarse_stride(setting, AABB, res, cf, DT) == \
                jg.resolve_coarse_stride(setting, AABB, res, cf, DT)


def test_cone_t_grid_matches_jax():
    """Within 1e-6 relative: f32 power and products."""
    t_min = np.random.default_rng(3).uniform(0, 2, 64).astype(np.float32)
    ref = np.asarray(jg._cone_t_grid(jnp.asarray(t_min), 1e-3, 0.004, 900))
    got = tg._cone_t_grid(torch.as_tensor(t_min), 1e-3, 0.004, 900).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_compact_indices_contract():
    m = torch.tensor([False, True, True, False, True])
    assert tg.compact_indices(m, 2).tolist() == [1, 2]
    assert tg.compact_indices(m, 6).tolist() == [1, 2, 4, 5, 5, 5]
    ref = np.asarray(jg.compact_indices(jnp.asarray(m.numpy()), 8))
    np.testing.assert_array_equal(tg.compact_indices(m, 8).numpy(), ref)


@pytest.mark.parametrize("dil", [1, 2])
def test_dilated_coarse_binaries_match_jax(dil):
    b = np.random.default_rng(dil).random((64, 64, 64)) < 0.01
    np.testing.assert_array_equal(
        tg._dilated_coarse_binaries(torch.as_tensor(b), 4, dil).numpy(),
        np.asarray(jg._dilated_coarse_binaries(jnp.asarray(b), 4, dil)))


@pytest.fixture(scope="module")
def march_inputs():
    b = _fixture_binaries(128)
    o, d = _rays(256)
    stride, dil = jg.resolve_coarse_stride(-1, AABB, 128, 4, DT)
    kw = dict(render_step_size=DT, max_steps=jg.max_march_steps(AABB, DT),
              max_samples_total=1 << 15)
    two = dict(coarse_factor=4, coarse_stride=stride, coarse_dilation=dil)
    jstate = jg.occ_grid_init(jnp.asarray(AABB), jg.OccGridConfig())
    jstate = jstate._replace(binaries=jnp.asarray(b))
    tstate = tg.occ_grid_init(AABB, tg.OccGridConfig())
    tstate = tstate._replace(binaries=torch.as_tensor(b))
    return jstate, tstate, o, d, kw, two


@pytest.mark.parametrize("two_level", [False, True])
def test_march_matches_jax(march_inputs, two_level):
    jstate, tstate, o, d, kw, two = march_inputs
    extra = two if two_level else {}
    j = jg.occ_grid_sampling(jstate, jnp.asarray(o), jnp.asarray(d),
                             **kw, **extra)
    t = tg.occ_grid_sampling(tstate, torch.as_tensor(o), torch.as_tensor(d),
                             **kw, **extra)
    assert int(t.num_valid) > 1000
    _assert_same_samples(t, j)


def test_two_level_march_equals_single_level(march_inputs):
    """Same sample set: ray indices exactly, t within 1e-6 (the two-level
    march forms t_end as t_start + dt, the single level as the next
    knot)."""
    _, tstate, o, d, kw, two = march_inputs
    o, d = torch.as_tensor(o), torch.as_tensor(d)
    a = tg.occ_grid_sampling(tstate, o, d, **kw)
    c = tg.occ_grid_sampling(tstate, o, d, **kw, **two)
    assert int(a.num_valid) == int(c.num_valid)
    assert torch.equal(a.valid, c.valid)
    assert torch.equal(a.ray_indices, c.ray_indices)
    np.testing.assert_allclose(c.t_starts.numpy(), a.t_starts.numpy(),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(c.t_ends.numpy(), a.t_ends.numpy(),
                               rtol=0, atol=1e-6)


def test_cone_and_per_ray_planes_match_jax(march_inputs):
    """The single-level cone march with per-ray near/far planes (the
    window renderer's call)."""
    jstate, tstate, o, d, kw, _ = march_inputs
    near = np.random.default_rng(5).uniform(2.0, 3.0, len(o)) \
        .astype(np.float32)
    far = near + 0.8
    args = dict(render_step_size=DT, max_steps=200,
                max_samples_total=1 << 14, cone_angle=0.004)
    j = jg.occ_grid_sampling(jstate, jnp.asarray(o), jnp.asarray(d),
                             near_plane=jnp.asarray(near),
                             far_plane=jnp.asarray(far), **args)
    t = tg.occ_grid_sampling(tstate, torch.as_tensor(o), torch.as_tensor(d),
                             near_plane=torch.as_tensor(near),
                             far_plane=torch.as_tensor(far), **args)
    _assert_same_samples(t, j)


def test_contracted_cone_march_matches_jax():
    """The unbounded (360) march: cone steps over [near, far] with the
    occupancy grid in contracted space."""
    b = np.random.default_rng(6).random((64, 64, 64)) < 0.1
    aabb = np.array([-1, -1, -1, 1, 1, 1], np.float32)
    jstate = jg.occ_grid_init(jnp.asarray(aabb), jg.OccGridConfig(64))
    jstate = jstate._replace(binaries=jnp.asarray(b))
    tstate = tg.occ_grid_init(aabb, tg.OccGridConfig(64))
    tstate = tstate._replace(binaries=torch.as_tensor(b))
    o, d = _rays(64, 8)
    o = o / 4.0                                   # cameras inside the roi
    args = dict(render_step_size=1e-3, near_plane=0.2, far_plane=1e2,
                cone_angle=0.004, max_samples_total=1 << 16,
                max_steps=jg.max_march_steps_cone(0.2, 1e2, 1e-3, 0.004))
    j = jg.occ_grid_sampling(jstate, jnp.asarray(o), jnp.asarray(d),
                             contract_aabb=jnp.asarray(aabb), **args)
    t = tg.occ_grid_sampling(tstate, torch.as_tensor(o), torch.as_tensor(d),
                             contract_aabb=torch.as_tensor(aabb), **args)
    assert int(t.num_valid) > 1000
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    np.testing.assert_array_equal(t.ray_indices.numpy(),
                                  np.asarray(j.ray_indices))
    # t grows geometrically to ~100: compare relative to t
    np.testing.assert_allclose(t.t_starts.numpy(), np.asarray(j.t_starts),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t.t_ends.numpy(), np.asarray(j.t_ends),
                               rtol=1e-5, atol=1e-6)
