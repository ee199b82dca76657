#!/usr/bin/env python3
"""Lanes a segment of the port's K3 (csrc/segment_sum.cu) on one NVIDIA
card: every lane count (1-16) against index_add_ of the same rows into
zeros and the bound, on seeded run-length distributions like the main
paths' (uniform, Poisson, exponential, a budget-saturated prefix).
`segment_group` (ops/hashgrid_sorted.py) picks the lane count from M
and n alone; this shows how far its pick is from the fastest.

    python3 tools/probe_segment_sum.py    # from the repo root, on the card
"""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_segment_sum: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import bound, card_line, check, cuda_ms
    from quadraturefields_tpu_torch._cuda import ptr
    from quadraturefields_tpu_torch.ops import hashgrid_sorted as hs

    card = card_line()
    print(card)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def launch(keys, vals, n, lanes):
        out = torch.empty((n, vals.shape[1]), device=dev)
        hs.SEGMENT_SUM_KERNEL.launch(dev, ptr(keys), ptr(vals), ptr(out),
                                     keys.shape[0], n, vals.shape[1], lanes)
        return out

    def uniform(m, n, n_pad, span=None):
        """m - n_pad sorted uniform keys over [0, span or n), then pads."""
        keys = torch.randint(0, span or n, (m - n_pad,), generator=g,
                             device=dev)
        return torch.cat([keys.sort().values,
                          torch.full((n_pad,), n, device=dev)]).int(), n

    def runs(m, n, lengths):
        """Runs of the given lengths over the first segments, cut or
        padded (key n) to m rows."""
        keys = torch.repeat_interleave(
            torch.arange(lengths.shape[0], device=dev, dtype=torch.int32),
            lengths)[:m]
        return torch.cat([keys, torch.full((m - keys.shape[0],), n,
                                           dtype=torch.int32,
                                           device=dev)]), n

    def exponential(count, mean, cap):
        return (torch.empty(count, device=dev)
                .exponential_(1 / mean, generator=g).round().long()
                .clamp(max=cap))

    def chords(count, cap):
        """Rays through a ball: sqrt(1 - r^2) chord lengths, half of the
        rays missing it."""
        r = torch.rand(count, generator=g, device=dev) * 2
        return (cap * (1 - r.clamp(max=1) ** 2).sqrt()).long()

    cases = {
        "uniform, 120 a segment": uniform(1 << 20, 8192, 1 << 16),
        "uniform at the pack cap, 0.6 a segment":
            uniform(163_840, 238_933, 20_480),
        "uniform at the pack cap, 2.5 a segment":
            uniform(163_840, 57_344, 20_480),
        "uniform at the pack cap, 8 a segment":
            uniform(163_840, 17_920, 20_480),
        "stage-4 cut at the cap: the first 65,536 of 262,144 rays":
            uniform(163_840, 262_144, 0, span=65_536),
        "stage-4-like: exp(2.5) <= 25 over 46,336 rays":
            runs(131_072, 46_336, exponential(46_336, 2.5, 25)),
        "cell-step-like: exp(27) <= 370 over 32,768 rays":
            runs(1 << 20, 32_768, exponential(32_768, 27.0, 370)),
        "corner-step-like: exp(29) <= 334 over 8192 rays":
            runs(1 << 18, 8192, exponential(8192, 29.0, 334)),
        "eval-chunk-like: exp(58) <= 258 over 8192 rays":
            runs(1 << 20, 8192, exponential(8192, 58.0, 258)),
        "twin-like: chords <= 317, a 2^17 budget over 46,336 rays":
            runs(131_072, 46_336, chords(46_336, 317)),
        "one run of 10^5 rows among 1000 segments":
            runs(100_000, 1000, torch.tensor([100_000], device=dev)),
    }
    for label, (keys, n) in cases.items():
        m = keys.shape[0]
        vals = torch.randn((m, 8), generator=g, device=dev)
        rows = torch.bincount(keys.long().clamp(0, n), minlength=n + 1)[:n]
        valid = int(rows.sum())
        want = hs.segment_sum_plain(keys, vals.double(), n)
        scale = float(want.abs().max())
        times = {}
        for lanes in (1, 2, 4, 8, 16):
            got = launch(keys, vals, n, lanes)
            torch.cuda.synchronize()
            check(float((got - want).abs().max()) <= 1e-5 * scale,
                  f"{label}: {lanes} lanes disagree")
            times[lanes] = cuda_ms(lambda: launch(keys, vals, n, lanes))
        acc = torch.zeros((n + 1, 8), device=dev)
        keys_c = keys.long().clamp(0, n)
        lib_ms = cuda_ms(lambda: acc.index_add_(0, keys_c, vals))
        b = bound(valid * 36 + n * 32, valid * 8)["bound_ms"]
        pick = hs.segment_group(m, n)
        best = min(times, key=times.get)
        print(f"{label}: {m} rows ({valid} valid) into {n} segments, "
              f"{valid / n:.3f} a segment (at most {int(rows.max())}, "
              f"{int((rows > 0).sum())} segments with rows); ms by lanes "
              + ", ".join(f"{k}: {t:.4f}" for k, t in times.items())
              + f"; segment_group {pick} ({times[pick]:.4f}), fastest "
              f"{best}; index_add_ {lib_ms:.4f}, bound {b:.4f} [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
