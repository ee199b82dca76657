"""The cell layout's table-gradient payloads over a training trajectory,
in the port and in the JAX package.

Both trainers train run_nerfsynthetic_tpu_fast.sh's cell configuration
(L8 F4 tet, scale 1.5, the occ regulariser, the mlp head, 2 layers) at a
small table (2^14 rows a hashed level), a 2^14-sample budget, a 32^3
occupancy grid and a 2e-2 march step on the 64^2 fixture, from the
same weights (carried across with utils/convert.py), on the same
batches (each package's own loader, same seed) and the same noise: the port's stratified jitter and occupancy
jitter are JAX's draws from the JAX trainer's key chain.

Payloads: "f32" and "bf16sim" under grad_mode "auto", which is "exact"
on the CPU in both packages (the f32 rows, bf16sim rounding each
product to bf16 outside any kernel), and the port's "bf16factor" under
"sorted" through K7's plain version (JAX's sorted bf16factor would run
its Pallas kernel in interpret mode, too slow for a trajectory).

The short case holds the port's per-step loss to JAX's. The long case
(marker `slow`) trains 300 steps per payload and package and prints
each final eval PSNR:

    python -m pytest tests/test_torch_payload_trajectory.py -m slow -s
"""
import jax
import numpy as np
import pytest
import torch

from quadraturefields_tpu.data.fixture import write_fixture_dataset
from quadraturefields_tpu.train import stage1_ngp as jst
from quadraturefields_tpu_torch.train import stage1_ngp as tst
from quadraturefields_tpu_torch.utils.convert import (
    occ_state_from_jax,
    params_from_jax,
)

torch.set_num_threads(2)

# run_nerfsynthetic_tpu_fast.sh's cell flags at a CPU size
CELL = dict(scene="fixture", layout="cell", interp="tet", n_levels=8,
            n_features=4, log2_hashmap_size=14, scale=1.5, reg_type="occ",
            occ_thres=0.01, num_lobes=0, num_layers=2, batch_size_log2=14,
            init_batch_size=512, grid_resolution=32, render_step_size=2e-2,
            max_steps=300, ckpt_every=10**9, log_every=10**9)


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    write_fixture_dataset(root, res=64, n_train=8, n_test=2)
    return root


class JaxNoise:
    """The JAX trainer's key chain (Stage1Trainer.__init__ and
    train_one_step split it the same way) and the port's torch.rand
    replaced by its draws: the occupancy refresh's cell jitter from
    k_occ, the march's stratified jitter from k_render."""

    def __init__(self, seed, occ_cfg):
        self.key = jax.random.split(jax.random.PRNGKey(seed))[0]
        self.part = occ_cfg.resolution ** 3 // occ_cfg.partitions
        self.interval = occ_cfg.update_interval
        self.queue = []

    def next_step(self, step, n_rays):
        self.key, k_occ, k_render = jax.random.split(self.key, 3)
        assert not self.queue, "the port drew less noise than JAX"
        if step % self.interval == 0:
            self.queue.append(np.asarray(
                jax.random.uniform(k_occ, (self.part, 3))))
        self.queue.append(np.asarray(jax.random.uniform(k_render,
                                                        (n_rays,))))

    def rand(self, size, *, generator=None, device=None, **kw):
        want = self.queue.pop(0)
        assert tuple(size) == want.shape, (size, want.shape)
        return torch.tensor(want, device=device)


def _trainers(root, tmp_path, payload_jax, payload_port, grad_mode_port):
    """(JAX trainer or None, port trainer) on the same weights; the JAX
    trainer is built either way, for the weights."""
    jtr = jst.Stage1Trainer(jst.Stage1Config(
        data_root=root, root=str(tmp_path / "jax"),
        grad_payload=payload_jax or "f32", **CELL))
    ttr = tst.Stage1Trainer(tst.Stage1Config(
        data_root=root, root=str(tmp_path / "port"),
        grad_payload=payload_port, grad_mode=grad_mode_port, **CELL),
        device="cpu")
    ttr.params = tst._as_leaf_params(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jtr.params)))
    ttr._make_optimizer()
    return (jtr if payload_jax else None), ttr


def _train(jtr, ttr, n_steps, monkeypatch, sync_occ=False):
    """n_steps of both trainers in lockstep (jtr None: the port alone),
    the port on JAX's noise (drawn for the port's batch size, which the
    dynamic batch sets from each package's own sample count after step
    100). With sync_occ, each occupancy refresh of the
    port must give JAX's EMA densities within 1e-4 of their max (the
    density MLP's bf16 operands round at other points), and the
    port then takes JAX's grid: at the untrained weights the densities
    are nearly uniform and the threshold is their mean, so f32 ulps
    (~1e-8 here) flip many of the grid's cells, and the two marches would
    see other samples from step 0 on. Returns [(jax loss or None, port
    loss, jax valid samples or None, port valid samples)] per step."""
    noise = JaxNoise(ttr.cfg.seed, ttr.occ_cfg)
    monkeypatch.setattr(torch, "rand", noise.rand)
    if sync_occ:
        own = ttr._occ_update_impl

        def synced(step):
            occs = np.asarray(jtr.occ_state.occs)
            got = own(step).occs.numpy()
            assert np.abs(got - occs).max() <= 1e-4 * np.abs(occs).max()
            return occ_state_from_jax(
                occs, np.asarray(jtr.occ_state.binaries), ttr.cfg.aabb)

        monkeypatch.setattr(ttr, "_occ_update_impl", synced)
    record = []
    for step in range(n_steps):
        n_rays = ttr.train_dataset.num_rays
        lj = nj = None
        if jtr is not None:
            loss, aux = jtr.train_one_step()
            lj, nj = float(loss), int(aux["num_valid"])
        noise.next_step(step, n_rays)
        loss, aux = ttr.train_one_step()
        assert not noise.queue, "the port drew less noise than JAX"
        record.append((lj, float(loss), nj, int(aux["num_valid"])))
    monkeypatch.undo()
    return record


@pytest.mark.parametrize("payload", ["f32", "bf16sim"])
def test_port_loss_follows_jax_per_step(payload, fixture_root, tmp_path,
                                        monkeypatch):
    """12 steps of the cell trainer with the payload under "auto"
    (exact rows on the CPU) in both packages, on one occupancy grid (one
    refresh, at step 0): the port's loss lies within 1e-4 relative of
    JAX's at every step (the packages' bf16 MLP operands round at other
    points and Adam's first updates are lr * sign(g): <= 9e-7 seen), and
    its march counts the same valid samples within 1e-4 (a sample on a
    cell boundary may fall either way in f32)."""
    jtr, ttr = _trainers(fixture_root, tmp_path, payload, payload, "auto")
    record = _train(jtr, ttr, 12, monkeypatch, sync_occ=True)
    for step, (lj, lt, nj, nt) in enumerate(record):
        assert nj > 0 and abs(nt - nj) <= 1e-4 * nj, (step, nj, nt)
        assert abs(lt - lj) <= 1e-4 * abs(lj), (step, lj, lt)
    # the run trains: the loss of the last steps is below the first's
    assert np.mean([r[0] for r in record[-3:]]) < record[0][0]


# (the JAX trainer's payload or None, the port's payload, its grad_mode)
LONG_RUNS = [
    ("f32", "f32", "auto"),
    ("bf16sim", "bf16sim", "auto"),
    (None, "bf16factor", "sorted"),
]


@pytest.mark.slow
@pytest.mark.parametrize("payload_jax,payload_port,mode", LONG_RUNS)
def test_payload_trajectory_long(payload_jax, payload_port, mode,
                                 fixture_root, tmp_path, monkeypatch):
    """300 steps per payload, then each trainer's eval PSNR on the two
    test views; prints one line per run. Both packages must train (the
    last 20 steps' mean loss below half the first 20's) and agree within
    1 dB at the end where both ran."""
    jtr, ttr = _trainers(fixture_root, tmp_path, payload_jax, payload_port,
                         mode)
    record = _train(jtr, ttr, 300, monkeypatch)
    port = ttr.evaluate()
    first, last = (np.mean([r[1] for r in record[s]])
                   for s in (slice(0, 20), slice(-20, None)))
    line = (f"payload port {payload_port} ({mode}): loss {first:.6f} -> "
            f"{last:.6f}, eval PSNR {port['psnr']:.4f} dB")
    if jtr is not None:
        ref = jtr.evaluate()
        jfirst, jlast = (np.mean([r[0] for r in record[s]])
                         for s in (slice(0, 20), slice(-20, None)))
        line += (f"; JAX {payload_jax}: loss {jfirst:.6f} -> {jlast:.6f}, "
                 f"eval PSNR {ref['psnr']:.4f} dB")
    print(line)
    assert last < 0.5 * first
    if jtr is not None:
        assert jlast < 0.5 * jfirst
        assert abs(port["psnr"] - ref["psnr"]) <= 1.0
