"""The pieces of the port's stage-1 training step against the JAX
package's, on the same seeded numpy inputs: the trunc_exp and
contraction gradients, the distortion loss, the occupancy-grid EMA
update with JAX's jitter injected, the learning-rate schedule and the
Adam chain."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from quadraturefields_tpu.models import ngp as jngp
from quadraturefields_tpu.ops import activations as ja
from quadraturefields_tpu.ops import distortion as jd
from quadraturefields_tpu.ops import grid as jg
from quadraturefields_tpu.utils import optim as jo
from quadraturefields_tpu_torch.models import ngp as tngp
from quadraturefields_tpu_torch.ops import activations as ta
from quadraturefields_tpu_torch.ops import distortion as td
from quadraturefields_tpu_torch.ops import grid as tg
from quadraturefields_tpu_torch.utils import optim as to
from quadraturefields_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)


def _grad_t(fn, *arrays):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*ts)
    grads = torch.autograd.grad(out.sum(), ts)
    return out.detach().numpy(), [g.numpy() for g in grads]


def test_trunc_exp_gradient_matches_jax():
    """exp forward; the gradient clamps x at 15 (x = 20 gets exp(15))."""
    x = np.array([-3.0, 0.0, 1.5, 14.9, 15.0, 20.0], np.float32)
    out, (gt,) = _grad_t(ta.trunc_exp, x)
    gj = np.asarray(jax.grad(lambda v: ja.trunc_exp(v).sum())(
        jnp.asarray(x)))
    np.testing.assert_allclose(out, np.exp(x), rtol=1e-6)
    np.testing.assert_allclose(gt, gj, rtol=1e-6)
    np.testing.assert_allclose(gt[-1], np.exp(np.float32(15.0)), rtol=1e-6)


def test_contraction_gradient_and_inverses_match_jax():
    """contract_to_unisphere and its clamped radial backward, inside and
    outside the unit ball; inverse_contraction and
    inv_contract_from_unisphere, each within 1e-5 of JAX's."""
    rng = np.random.default_rng(0)
    aabb = np.array([-1, -1, -1, 1, 1, 1], np.float32)
    x = rng.normal(0, 2.0, (500, 3)).astype(np.float32)
    ta_ = torch.tensor(aabb)
    out, (gt,) = _grad_t(lambda v: ta.contract_to_unisphere(v, ta_), x)
    oj, pull = jax.vjp(lambda v: ja.contract_to_unisphere(v, aabb),
                       jnp.asarray(x))
    (gj,) = pull(jnp.ones_like(oj))
    np.testing.assert_allclose(out, np.asarray(oj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(gt, np.asarray(gj), rtol=1e-5, atol=1e-6)
    assert (np.linalg.norm(x, axis=1) > 1).any()

    y = rng.uniform(0, 1, (500, 3)).astype(np.float32)
    for tf, jf in ((ta.inverse_contraction, ja.inverse_contraction),
                   (ta.inv_contract_from_unisphere,
                    ja.inv_contract_from_unisphere)):
        got = tf(torch.tensor(y), ta_)
        want = jf(jnp.asarray(y), jnp.asarray(aabb))
        if isinstance(want, tuple):
            np.testing.assert_array_equal(got[1].numpy(),
                                          np.asarray(want[1]))
            got, want = got[0], want[0]
        ok = np.isfinite(np.asarray(want))
        np.testing.assert_allclose(got.numpy()[ok], np.asarray(want)[ok],
                                   rtol=1e-5, atol=1e-5)


def test_distortion_loss_matches_jax():
    """flatten_eff_distloss and its gradient in the weights and the
    midpoints, within 1e-5 relative."""
    rng = np.random.default_rng(1)
    n_rays = 40
    ray = np.sort(rng.integers(0, n_rays, 700))
    ray = np.concatenate([ray, np.full(50, n_rays)]).astype(np.int32)
    w = rng.uniform(0, 0.2, ray.shape[0]).astype(np.float32)
    m = np.cumsum(rng.uniform(0, 0.1, ray.shape[0])).astype(np.float32)
    dt = np.full_like(w, 5e-3)
    rt = torch.tensor(ray)
    out, gt = _grad_t(
        lambda a, b: td.flatten_eff_distloss(a, b, torch.tensor(dt), rt,
                                             n_rays), w, m)
    oj, gj = jax.jit(jax.value_and_grad(
        lambda a, b: jd.flatten_eff_distloss(a, b, jnp.asarray(dt),
                                             jnp.asarray(ray), n_rays),
        argnums=(0, 1)))(jnp.asarray(w), jnp.asarray(m))
    np.testing.assert_allclose(out, float(oj), rtol=1e-5)
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6)


def _occ_models(unbounded):
    """The same small NGP density in both packages: JAX init weights
    (table lifted off its 1e-4 init so densities vary) carried across."""
    kw = dict(n_levels=4, log2_hashmap_size=12, num_g_lobes=2,
              interp="tet", unbounded=unbounded)
    jcfg = jngp.NGPConfig(**kw)
    tcfg = tngp.NGPConfig(**kw)
    params = jngp.ngp_init(jax.random.PRNGKey(3), jcfg)
    params["table"] = params["table"] * 1e4
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    return jcfg, tcfg, params, tparams


@pytest.mark.parametrize("unbounded", [False, True])
def test_occ_grid_update_matches_jax(unbounded):
    """One warm-up update (every partition, one jitter draw shared by
    all) and two post-warm-up updates (quarters 0 and 1), each from the
    same state and with JAX's jitter injected: occs within bf16
    tolerance (bf16 MLP operands may round to the neighbouring value),
    binaries equal apart from cells whose occupancy lies within 1e-2
    relative of the threshold."""
    jcfg, tcfg, jp, tp = _occ_models(unbounded)
    res, dt = 32, 5e-3
    occ_cfg = jg.OccGridConfig(resolution=res)
    tocc_cfg = tg.OccGridConfig(resolution=res)
    aabb = np.array([-1.5, -1.5, -1.5, 1.5, 1.5, 1.5], np.float32)
    contract = aabb if unbounded else None

    def j_eval(x):
        return jngp.ngp_query_density(jp, x, jnp.asarray(aabb), jcfg)[
            ..., 0] * dt

    def t_eval(x):
        with torch.no_grad():
            return tngp.ngp_query_density(tp, x, torch.tensor(aabb),
                                          tcfg)[..., 0] * dt

    state = jg.occ_grid_init(jnp.asarray(aabb), occ_cfg)
    part = res**3 // occ_cfg.partitions
    for i, step in enumerate((0, 256, 272)):
        key = jax.random.PRNGKey(10 + i)
        want = jg.occ_grid_update(state, step, key, j_eval, occ_cfg,
                                  contract_aabb=contract)
        jitter = np.asarray(jax.random.uniform(key, (part, 3)))
        tstate = tg.OccGridState(
            occs=torch.tensor(np.asarray(state.occs)),
            binaries=torch.tensor(np.asarray(state.binaries)),
            aabb=torch.tensor(aabb))
        got = tg.occ_grid_update(
            tstate, step, t_eval, tocc_cfg,
            contract_aabb=None if contract is None else torch.tensor(aabb),
            jitter=torch.tensor(jitter))
        wo, go = np.asarray(want.occs), got.occs.numpy()
        np.testing.assert_allclose(go, wo, rtol=1e-2, atol=1e-6)
        if step >= occ_cfg.warmup_steps:
            # one quarter was refreshed, the rest kept as it was
            p = (step // occ_cfg.update_interval) % occ_cfg.partitions
            quarter = np.s_[p * part:(p + 1) * part]
            before = np.asarray(state.occs)
            kept = np.delete(np.arange(res**3), quarter)
            np.testing.assert_array_equal(go[kept], before[kept])
            assert (go[quarter] != before[quarter]).any()
        thre = min(float(wo.mean()), occ_cfg.occ_thre)
        wb = np.asarray(want.binaries).reshape(-1)
        gb = got.binaries.numpy().reshape(-1)
        near = np.abs(wo - thre) <= 1e-2 * thre
        assert np.array_equal(gb[~near], wb[~near])
        assert 0 < wb.mean() < 1
        state = want


def test_lr_schedule_matches_jax():
    """The warm-up and milestone schedule at the steps where it changes,
    within 1e-7 relative (both in float32)."""
    max_steps = 20000
    js = jo.reference_lr_schedule(1e-2, max_steps)
    ts = to.reference_lr_schedule(1e-2, max_steps)
    for step in (0, 1, 50, 99, 100, max_steps // 2, max_steps * 3 // 4,
                 max_steps * 9 // 10, max_steps):
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-7)


def test_adam_matches_optax_chain():
    """Five updates from identical gradients: torch Adam (weight decay
    added before the moments, eps 1e-15) with the LambdaLR schedule
    against the JAX optax chain, parameters within 1e-6 relative. They
    sit at the MLP weights' scale (|p| in [0.05, 0.5]); the two update
    formulas round differently in f32 by ~1e-8 absolute over 5 steps."""
    rng = np.random.default_rng(4)
    shapes = {"table": (257, 2), "w": (32, 16), "b": (16,)}
    p0 = {k: (rng.uniform(0.05, 0.5, s) * rng.choice([-1, 1], s))
          .astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(0, 1e-3, s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(5)]

    opt = jo.make_ngp_optimizer(300, lr=1e-2, weight_decay=1e-5)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = opt.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    topt, sched = to.make_ngp_optimizer(list(tp.values()), 300, lr=1e-2,
                                        weight_decay=1e-5)
    for g in grads:
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, t in tp.items():
            t.grad = torch.tensor(g[k])
        topt.step()
        sched.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6, atol=0)
