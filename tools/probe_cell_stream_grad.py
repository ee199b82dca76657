#!/usr/bin/env python3
"""K7's and K6's stream entries (csrc/cell_factor_grad.cu
qf_cell_factor_grad, csrc/cell_table_grad.cu qf_cell_pair_grad) on one
NVIDIA card, and where their time goes.

Streams: phase 2's uniform one (2^20 uniform points, cotangent N(0, 1),
the cell grid of run_nerfsynthetic_tpu_fast.sh: K7 at F 2 (L16), 4, 8 and
16 (L8), K6 at PW 16 (L8 F4)), and a ray-ordered one: the x and g of one
step of phase 5's cell training (the same configuration, `--steps`
steps of training first), K7 at F4 and K6 at PW 16.

For each stream and entry: the entry against its plain version (in
float64, 1e-5 of max) with its time, its plain version's, index_add_
of the prepared rows and the bound (chip_smoke.cell_stream_case), as a
JSON line and in build/probe_cell_stream_grad.json; with
`--baseline DIR`, the entry as another checkout at DIR builds it (e.g.
the parent commit unpacked with `git archive`), in turns. Then the
split: a kernel that reads the stream and discards it ("read"), one
that issues the parent's float4 atomics of every contribution without
reading its values ("atomics"), the entry on the level-0 contributions
alone and on the finer levels alone, and for K6 a one-pass variant
that adds each contribution's row with one bulk reduction
(cp.reduce.async.bulk ... .add.f32) in place of its float4 atomics. The
probe's kernels are built here (nvcc, the package's flags) from the
source below, outside the package. It also prints the SASS of a shared
float atomicAdd, the add that a sum of a row range in shared memory
would need.

    python3 tools/probe_cell_stream_grad.py [--baseline DIR] [--steps N]
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

PROBE_SRC = r"""
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#define EXPORT extern "C" __attribute__((visibility("default")))

template <typename Idx>
__device__ __forceinline__ long long entry(const void* idx, long long j) {
  return static_cast<long long>(__ldg(static_cast<const Idx*>(idx) + j));
}

__device__ __forceinline__ float bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// read K7's stream (idx, wk, c1, c2, g [m, f]) once and discard it
template <typename Idx>
__global__ void read_factor(const void* idx, const float4* wk,
                            const int* c1, const int* c2, const float* g,
                            long long m, int f, float* sink) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  float acc = (float)entry<Idx>(idx, j) + (float)(__ldg(c1 + j) ^ __ldg(c2 + j));
  const float4 w = __ldg(wk + j);
  acc += w.x + w.y + w.z + w.w;
  if (f == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(g) + j);
    acc += v.x + v.y;
  } else {
    for (int q = 0; q < f / 4; ++q) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(g + j * f) + q);
      acc += v.x + v.y + v.z + v.w;
    }
  }
  if (acc == 1234.5678f) *sink = acc;
}

// read K6's stream (idx, lo, hi [m, pw]) once and discard it
template <typename Idx>
__global__ void read_pair(const void* idx, const float2* lo,
                          const float2* hi, long long m, int shift,
                          float* sink) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (m << shift)) return;
  const float2 a = __ldg(lo + t), b = __ldg(hi + t);
  const float acc = (float)entry<Idx>(idx, t >> shift) + a.x + a.y + b.x + b.y;
  if (acc == 1234.5678f) *sink = acc;
}

// K7's float4 atomics (slots 0, 1, 2, 7, F/4 float4 each; float2 at F = 2)
// of every in-range contribution, values not read
template <typename Idx>
__global__ void atomics_factor(const void* idx, float* out, long long m,
                               int f, long long n_entries) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  const long long e = entry<Idx>(idx, j);
  if (e < 0 || e >= n_entries) return;
  float* row = out + e * 8 * f;
  const int slots[4] = {0, 1, 2, 7};
  for (int t = 0; t < 4; ++t) {
    if (f == 2) {
      atomicAdd(reinterpret_cast<float2*>(row + slots[t] * 2),
                make_float2(1.0f, 1.0f));
    } else {
      for (int q = 0; q < f / 4; ++q) {
        atomicAdd(reinterpret_cast<float4*>(row + slots[t] * f) + q,
                  make_float4(1.0f, 1.0f, 1.0f, 1.0f));
      }
    }
  }
}

// K6's float4 atomics (2 PW / 4 a contribution), values not read
template <typename Idx>
__global__ void atomics_pair(const void* idx, float4* out, long long m,
                             int shift, long long n_entries) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (m << shift)) return;
  const long long e = entry<Idx>(idx, t >> shift);
  if (e < 0 || e >= n_entries) return;
  atomicAdd(out + (e << shift) + (t & ((1 << shift) - 1)),
            make_float4(1.0f, 1.0f, 1.0f, 1.0f));
}

// K6 in one pass with bulk reductions: a contribution's PW/2 threads
// stage its row (lo, hi rounded to bf16, interleaved) in shared memory;
// its first thread adds the row to out with one cp.reduce.async.bulk
template <typename Idx>
__global__ void __launch_bounds__(256)
pair_bulk(const void* idx, const float2* lo, const float2* hi, float* out,
          long long m, int shift, long long n_entries) {
  __shared__ __align__(128) float4 stage[256];
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int q = threadIdx.x & ((1 << shift) - 1);
  long long e = -1;
  if (t < (m << shift)) {
    e = entry<Idx>(idx, t >> shift);
    const float2 a = __ldg(lo + t), b = __ldg(hi + t);
    stage[threadIdx.x] = make_float4(bf(a.x), bf(b.x), bf(a.y), bf(b.y));
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  if (q == 0 && e >= 0 && e < n_entries) {
    const unsigned int src = static_cast<unsigned int>(
        __cvta_generic_to_shared(stage + threadIdx.x));
    float* dst = out + (e << shift) * 4;
    asm volatile(
        "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 "
        "[%0], [%1], %2;" :: "l"(dst), "r"(src), "r"(16 << shift)
        : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

// the SASS of a shared-memory float atomicAdd
__global__ void shared_float_add(const float* v, float* out) {
  __shared__ float s[256];
  s[threadIdx.x] = 0.0f;
  __syncthreads();
  atomicAdd(&s[(threadIdx.x * 7) & 255], v[threadIdx.x]);
  __syncthreads();
  out[threadIdx.x] = s[threadIdx.x];
}

static unsigned int blocks(long long n) { return (unsigned)((n + 255) / 256); }

EXPORT int probe_read_factor(const void* idx, int is64, const float* wk,
                             const int* c1, const int* c2, const float* g,
                             long long m, int f, float* sink, void* s) {
  cudaStream_t st = (cudaStream_t)s;
  const float4* w = reinterpret_cast<const float4*>(wk);
  if (is64) read_factor<long long><<<blocks(m), 256, 0, st>>>(idx, w, c1, c2, g, m, f, sink);
  else read_factor<int><<<blocks(m), 256, 0, st>>>(idx, w, c1, c2, g, m, f, sink);
  return (int)cudaGetLastError();
}

EXPORT int probe_read_pair(const void* idx, int is64, const float* lo,
                           const float* hi, long long m, int shift,
                           float* sink, void* s) {
  cudaStream_t st = (cudaStream_t)s;
  const float2* a = reinterpret_cast<const float2*>(lo);
  const float2* b = reinterpret_cast<const float2*>(hi);
  if (is64) read_pair<long long><<<blocks(m << shift), 256, 0, st>>>(idx, a, b, m, shift, sink);
  else read_pair<int><<<blocks(m << shift), 256, 0, st>>>(idx, a, b, m, shift, sink);
  return (int)cudaGetLastError();
}

EXPORT int probe_atomics_factor(const void* idx, int is64, float* out,
                                long long m, int f, long long n_entries,
                                void* s) {
  cudaStream_t st = (cudaStream_t)s;
  if (is64) atomics_factor<long long><<<blocks(m), 256, 0, st>>>(idx, out, m, f, n_entries);
  else atomics_factor<int><<<blocks(m), 256, 0, st>>>(idx, out, m, f, n_entries);
  return (int)cudaGetLastError();
}

EXPORT int probe_atomics_pair(const void* idx, int is64, float* out,
                              long long m, int shift, long long n_entries,
                              void* s) {
  cudaStream_t st = (cudaStream_t)s;
  float4* o = reinterpret_cast<float4*>(out);
  if (is64) atomics_pair<long long><<<blocks(m << shift), 256, 0, st>>>(idx, o, m, shift, n_entries);
  else atomics_pair<int><<<blocks(m << shift), 256, 0, st>>>(idx, o, m, shift, n_entries);
  return (int)cudaGetLastError();
}

EXPORT int probe_pair_bulk(const void* idx, int is64, const float* lo,
                           const float* hi, float* out, long long m,
                           int shift, long long n_entries, void* s) {
  cudaStream_t st = (cudaStream_t)s;
  const float2* a = reinterpret_cast<const float2*>(lo);
  const float2* b = reinterpret_cast<const float2*>(hi);
  if (is64) pair_bulk<long long><<<blocks(m << shift), 256, 0, st>>>(idx, a, b, out, m, shift, n_entries);
  else pair_bulk<int><<<blocks(m << shift), 256, 0, st>>>(idx, a, b, out, m, shift, n_entries);
  return (int)cudaGetLastError();
}
"""

P = ctypes.c_void_p
LL = ctypes.c_longlong
I = ctypes.c_int
SIGNATURES = {
    "probe_read_factor": [P, I, P, P, P, P, LL, I, P, P],
    "probe_read_pair": [P, I, P, P, LL, I, P, P],
    "probe_atomics_factor": [P, I, P, LL, I, LL, P],
    "probe_atomics_pair": [P, I, P, LL, I, LL, P],
    "probe_pair_bulk": [P, I, P, P, P, LL, I, LL, P],
}


class ProbeKernels:
    """The probe's kernels, built with the package's nvcc flags."""

    def __init__(self):
        from quadraturefields_tpu_torch._cuda import (
            BUILD_DIR,
            NVCC_FLAGS,
            find_nvcc,
        )

        out_dir = BUILD_DIR / "probe"
        out_dir.mkdir(parents=True, exist_ok=True)
        src = out_dir / "probe_cell_stream.cu"
        src.write_text(PROBE_SRC)
        lib = out_dir / "libprobe_cell_stream.so"
        nvcc = find_nvcc()
        subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(lib), str(src)],
                       check=True, capture_output=True, timeout=600)
        self.lib = ctypes.CDLL(str(lib))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        self.cuobjdump = Path(nvcc).parent / "cuobjdump"
        self.shared_add_sass = self.atomic_opcodes(lib)

    def atomic_opcodes(self, lib):
        """The distinct atomic SASS opcodes in a library (shared: ATOMS;
        global: ATOMG, RED)."""
        sass = subprocess.run([str(self.cuobjdump), "-sass", str(lib)],
                              capture_output=True, text=True, timeout=300)
        ops = set()
        for line in sass.stdout.splitlines():
            for word in line.replace(";", " ").split():
                if word.startswith(("ATOMS", "ATOMG", "RED.", "ATOM.")):
                    ops.add(word)
        return sorted(ops)

    def __call__(self, name, *args):
        import torch

        from chip_smoke import check

        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(self.lib, name)(*args, ctypes.c_void_p(stream))
        check(code == 0, f"{name} failed to launch: {code}")


def split(torch, probe, kind, args):
    """The time of reading the stream alone, of the parent's atomics
    alone, and of the entry on the level-0 contributions and on the
    finer levels (args in point-major order, L levels inner)."""
    from chip_smoke import cuda_ms
    from quadraturefields_tpu_torch._cuda import ptr

    idx, *vals, e = args
    m = idx.shape[0]
    is64 = int(idx.dtype == torch.int64)
    sink = torch.zeros(1, device=idx.device)
    out = {}
    if kind == "factor":
        wk, c1, c2, g = vals
        f = g.shape[1]
        acc = torch.zeros((e, 8 * f), device=idx.device)
        out["read_ms"] = cuda_ms(lambda: probe(
            "probe_read_factor", ptr(idx), is64, ptr(wk), ptr(c1), ptr(c2),
            ptr(g), m, f, ptr(sink)))
        out["atomics_ms"] = cuda_ms(lambda: probe(
            "probe_atomics_factor", ptr(idx), is64, ptr(acc), m, f, e))
    else:
        lo, hi = vals
        pw = lo.shape[1]
        shift = (pw // 2).bit_length() - 1
        acc = torch.zeros((e, 2 * pw), device=idx.device)
        out["read_ms"] = cuda_ms(lambda: probe(
            "probe_read_pair", ptr(idx), is64, ptr(lo), ptr(hi), m, shift,
            ptr(sink)))
        out["atomics_ms"] = cuda_ms(lambda: probe(
            "probe_atomics_pair", ptr(idx), is64, ptr(acc), m, shift, e))
    del acc
    return out


def by_level(torch, entry, args, n_levels):
    """The entry on the level-0 contributions alone and on the rest."""
    from chip_smoke import cuda_ms

    idx, *vals, e = args
    level0 = torch.arange(idx.shape[0], device=idx.device) % n_levels == 0
    out = {}
    for key, keep in (("level0_ms", level0), ("finer_ms", ~level0)):
        sub = [idx[keep].contiguous()] + [v[keep].contiguous()
                                          for v in vals] + [e]
        out[key] = cuda_ms(lambda: entry(*sub))
        out[key.replace("_ms", "_contributions")] = int(keep.sum())
        del sub
    return out


def bulk_pair(torch, probe, args):
    """K6 in one pass with bulk reductions: its output against the plain
    version in float64 and its time."""
    from chip_smoke import as_f64, cuda_ms
    from quadraturefields_tpu_torch._cuda import ptr
    from quadraturefields_tpu_torch.ops import hashgrid_sorted as hs

    idx, lo, hi, e = args
    m, pw = lo.shape
    shift = (pw // 2).bit_length() - 1
    is64 = int(idx.dtype == torch.int64)

    def run():
        out = torch.zeros((e, 2 * pw), device=idx.device)
        probe("probe_pair_bulk", ptr(idx), is64, ptr(lo), ptr(hi), ptr(out),
              m, shift, e)
        return out

    got = run()
    want = hs.pair_grad_plain(*as_f64(args))
    torch.cuda.synchronize()
    rel = float((got - want).abs().max() / want.abs().max())
    del got, want
    return dict(bulk_ms=cuda_ms(run), bulk_relative=rel)


def captured_cell_step(torch, steps, card):
    """x and g of one step of phase 5's cell configuration after `steps`
    steps of training on the smoke's fixture views."""
    import numpy as np

    from chip_smoke import FixtureViews, capture, ngp_step_grads
    from quadraturefields_tpu_torch.ops import hashgrid as hg
    from quadraturefields_tpu_torch.train.stage1_ngp import (
        Stage1Config,
        Stage1Trainer,
    )
    import tempfile

    views = FixtureViews()
    cfg = Stage1Config(
        root=tempfile.mkdtemp(prefix="qf_probe_"), layout="cell",
        grad_payload="bf16factor", n_levels=8, n_features=4, num_lobes=0,
        num_layers=2, log2_hashmap_size=19, batch_size_log2=20, scale=1.5,
        reg_type="occ", occ_thres=0.01, max_steps=steps, log_every=10**9,
        ckpt_every=10**9, scene="fixture")
    views.update_num_rays(cfg.init_batch_size)
    trainer = Stage1Trainer(cfg, train_dataset=views, test_dataset=views)
    t0 = time.perf_counter()
    for _ in range(steps):
        trainer.train_one_step()
    torch.cuda.synchronize()
    print(f"{steps} cell training steps in {time.perf_counter() - t0:.1f} s "
          f"[{card}]")
    data = views.fetch_train_batch()
    dev = trainer.device
    batch = [torch.as_tensor(np.asarray(a, np.float32), device=dev)
             for a in (data["rays"].origins, data["rays"].viewdirs,
                       data["pixels"], data["color_bkgd"])]
    batch.append(torch.rand((batch[0].shape[0],), generator=trainer.generator,
                            device=dev))
    captured = {}
    with capture(hg, "tet_factor_grad_x_kernel", captured, "cell_step"):
        ngp_step_grads(torch, trainer, batch)
    return captured["cell_step"]


def main(argv=None) -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_cell_stream_grad: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import (
        Baseline,
        card_line,
        cell_stream_case,
        factor_stream,
        pair_stream,
    )
    from quadraturefields_tpu_torch.ops import hashgrid as hg
    from quadraturefields_tpu_torch.ops import hashgrid_sorted as hs

    args = sys.argv[1:] if argv is None else argv
    baseline = (Baseline(args[args.index("--baseline") + 1])
                if "--baseline" in args else None)
    steps = int(args[args.index("--steps") + 1]) if "--steps" in args \
        else 300
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda")
    probe = ProbeKernels()
    print("SASS of a shared float atomicAdd:", probe.shared_add_sass)
    if baseline is not None:
        for k in (baseline.factor, baseline.pair):
            k.load()

    g = torch.Generator(device=dev).manual_seed(1)
    n = 1 << 20
    x = torch.rand((n, 3), generator=g, device=dev)
    streams = []
    for L, F in ((16, 2), (8, 4), (8, 8), (8, 16)):
        cfg = hg.HashGridConfig.from_max_resolution(
            4096, n_levels=L, n_features=F, log2_hashmap_size=16,
            interp="tet", layout="cell", grad_payload="bf16factor")
        cot = torch.randn((n, L * F), generator=g, device=dev)
        streams.append((f"uniform L{L} F{F}", x, cot, cfg, F == 4))
    cx, cg, ccfg = captured_cell_step(torch, steps, card)
    streams.append((f"cell step ({cx.shape[0]} points) L8 F4", cx, cg, ccfg,
                    True))

    rows = []
    for label, sx, sg, cfg, with_pair in streams:
        L = cfg.n_levels
        live = int((sg.reshape(-1, L, cfg.n_features) != 0).any(2).sum())
        args = factor_stream(sx, sg, cfg)
        entry = cell_stream_case(
            torch, f"K7 stream entry, {label}", hs.tet_factor_grad_kernel,
            hs.tet_factor_grad_plain, hs.factor_rows, args, card,
            baseline and baseline.factor_fn)
        entry.update(split(torch, probe, "factor", args))
        entry.update(by_level(torch, hs.tet_factor_grad_kernel, args, L))
        rows.append(dict(kernel="K7", stream=label, live_pairs=live,
                         **entry))
        print(json.dumps(rows[-1]))
        del args
        if with_pair:
            args = pair_stream(sx, sg, cfg)
            entry = cell_stream_case(
                torch, f"K6 stream entry, {label}", hs.pair_grad_kernel,
                hs.pair_grad_plain, hs.pair_rows, args, card,
                baseline and baseline.pair_stream_fn)
            entry.update(split(torch, probe, "pair", args))
            entry.update(by_level(torch, hs.pair_grad_kernel, args, L))
            entry.update(bulk_pair(torch, probe, args))
            rows.append(dict(kernel="K6", stream=label, live_pairs=live,
                             **entry))
            print(json.dumps(rows[-1]))
            del args
    result = {"cell_stream_grad": rows, "card": card,
              "shared_float_add_sass": probe.shared_add_sass}
    out = ROOT / "build" / "probe_cell_stream_grad.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(result))
    print(f"written to {out}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
