"""The port's LPIPS (utils/lpips.py) against the JAX package's and
against tests/test_lpips.py's torch mirror of the official lpips
forward, on a VGG16/LPIPS weight file made from a seed (no real weights
ship here); NaN without weights; and the `lpips` key of each evaluation
that reports it (stage 1, stage 4, the baked eval of stage 6)."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from quadraturefields_tpu.utils.lpips import LPIPS as JLPIPS
from quadraturefields_tpu_torch.utils import lpips as tl
from quadraturefields_tpu_torch.utils import metrics as tm

torch.set_num_threads(1)


def random_weights_npz(path, seed=0):
    """A weight file in the converter's npz layout, made from `seed`:
    conv weights N(0, 0.05), biases N(0, 0.01), calibration U(0, 0.1)."""
    rng = np.random.default_rng(seed)
    out = {}
    in_ch = 3
    for out_ch, idx in tl._VGG16_CONVS:
        out[f"features.{idx}.weight"] = rng.normal(
            0, 0.05, (out_ch, in_ch, 3, 3)).astype(np.float32)
        out[f"features.{idx}.bias"] = rng.normal(
            0, 0.01, (out_ch,)).astype(np.float32)
        in_ch = out_ch
    for k, ch in enumerate((64, 128, 256, 512, 512)):
        out[f"lin{k}.weight"] = rng.uniform(0, 0.1, ch).astype(np.float32)
    np.savez(path, **out)
    return str(path)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    return random_weights_npz(tmp_path_factory.mktemp("lpips") / "w.npz")


@pytest.mark.parametrize("shape", [(32, 32), (48, 64)])
def test_lpips_matches_jax(weights, shape):
    """Within 1e-5 relative of JAX's LPIPS (both full f32 convolutions on
    the CPU), on two image sizes; 0 for equal images."""
    rng = np.random.default_rng(sum(shape))
    a = rng.random((*shape, 3)).astype(np.float32)
    b = rng.random((*shape, 3)).astype(np.float32)
    want = float(JLPIPS(weights_path=weights)(a, b))
    port = tl.LPIPS(weights_path=weights)
    got = port(torch.as_tensor(a), torch.as_tensor(b))
    assert np.isfinite(got) and got > 0
    assert got == pytest.approx(want, rel=1e-5)
    assert port(a, b) == got   # numpy images give the same
    assert port(a, a) == pytest.approx(0.0, abs=1e-7)


def test_lpips_matches_the_torch_mirror(weights):
    """Within 1e-5 relative of tests/test_lpips.py's torch mirror of
    lpips.LPIPS(net='vgg').forward (ScalingLayer constants, unit
    normalisation, 1x1 calibration, spatial mean, tap sum)."""
    raw = np.load(weights)
    sd = {k: torch.as_tensor(raw[k]) for k in raw.files}

    def mirror(a, b):
        shift = torch.tensor([-0.030, -0.088, -0.188]).view(1, 3, 1, 1)
        scale = torch.tensor([0.458, 0.448, 0.450]).view(1, 3, 1, 1)

        def feats(img):
            h = (img * 2.0 - 1.0 - shift) / scale
            taps = []
            for _, idx in tl._VGG16_CONVS:
                h = F.relu(F.conv2d(h, sd[f"features.{idx}.weight"],
                                    sd[f"features.{idx}.bias"], padding=1))
                if idx in (2, 7, 14, 21, 28):
                    taps.append(h)
                if idx in (2, 7, 14, 21):
                    h = F.max_pool2d(h, 2)
            return taps

        total = 0.0
        for k, (f0, f1) in enumerate(zip(feats(a), feats(b))):
            n0 = f0 / (f0.square().sum(1, keepdim=True).sqrt() + 1e-10)
            n1 = f1 / (f1.square().sum(1, keepdim=True).sqrt() + 1e-10)
            w = sd[f"lin{k}.weight"].view(1, -1, 1, 1)
            total = total + ((n0 - n1).square() * w).sum(1).mean()
        return float(total)

    rng = np.random.default_rng(7)
    a = rng.random((36, 36, 3)).astype(np.float32)
    b = rng.random((36, 36, 3)).astype(np.float32)
    want = mirror(torch.tensor(a).permute(2, 0, 1)[None],
                  torch.tensor(b).permute(2, 0, 1)[None])
    got = tl.LPIPS(weights_path=weights)(a, b)
    assert got == pytest.approx(want, rel=1e-5)


def test_nan_without_weights(monkeypatch):
    """No weight file: NaN, and one warning per process."""
    monkeypatch.delenv("QF_LPIPS_WEIGHTS", raising=False)
    monkeypatch.setattr(tl.LPIPS, "_warned_nan", False)
    m = tl.LPIPS(weights_path="/nonexistent/lpips.npz")
    assert not m.available
    img = np.zeros((8, 8, 3), np.float32)
    with pytest.warns(UserWarning, match="LPIPS weights unavailable"):
        assert np.isnan(m(img, img))
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert np.isnan(tl.LPIPS()(img, img))


class _View:
    """One 32x32 view: pixels from a seed, no rays (render_view is
    replaced)."""
    HEIGHT = WIDTH = 32

    def __init__(self, pixels):
        self.pixels = pixels

    def __len__(self):
        return 1

    def fetch_eval_view(self, i):
        return {"pixels": self.pixels.reshape(-1, 3)}


def test_lpips_key_of_each_evaluation(weights, monkeypatch):
    """With QF_LPIPS_WEIGHTS set, the `lpips` of Stage1Trainer.evaluate,
    Stage4Trainer.evaluate and stage 6's evaluate_baked is LPIPS of the
    rendered view against its pixels (lpips_metric's lazily built
    module); without it, NaN."""
    from quadraturefields_tpu_torch.baking import stage6
    from quadraturefields_tpu_torch.train.stage1_ngp import (
        Stage1Config,
        Stage1Trainer,
    )
    from quadraturefields_tpu_torch.train.stage4_finetune import (
        Stage4Trainer,
    )

    rng = np.random.default_rng(3)
    img = rng.random((32, 32, 3)).astype(np.float32)
    pixels = rng.random((32, 32, 3)).astype(np.float32)
    want = tl.LPIPS(weights_path=weights)(img, pixels)
    view = _View(pixels)
    render = lambda data: torch.as_tensor(img.reshape(-1, 3))  # noqa: E731

    t1 = Stage1Trainer(Stage1Config(n_levels=2, log2_hashmap_size=8,
                                    grid_resolution=16),
                       train_dataset=view, test_dataset=view, device="cpu")
    t1.render_view = render

    class Stub4:
        cfg = type("Cfg", (), {"up_sample": 1})()
        device = torch.device("cpu")
        render_view = staticmethod(render)
        _to_device = Stage4Trainer._to_device

    class Renderer:
        render_view = staticmethod(render)

    def evaluations():
        return {"stage1": t1.evaluate()["lpips"],
                "stage4": Stage4Trainer.evaluate(Stub4(), view)["lpips"],
                "stage6": stage6.evaluate_baked(Renderer(), view)["lpips"]}

    monkeypatch.setattr(tm, "_LPIPS_SINGLETON", None)
    monkeypatch.setenv("QF_LPIPS_WEIGHTS", weights)
    for name, got in evaluations().items():
        assert got == pytest.approx(want, rel=1e-6), name
    monkeypatch.setattr(tm, "_LPIPS_SINGLETON", None)
    monkeypatch.delenv("QF_LPIPS_WEIGHTS")
    monkeypatch.setattr(tl.LPIPS, "_warned_nan", False)
    with pytest.warns(UserWarning):
        got = evaluations()
    assert all(np.isnan(v) for v in got.values()), got
