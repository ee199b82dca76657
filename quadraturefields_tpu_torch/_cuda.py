"""Build, load and launch the port's hand-written CUDA kernels.

Each kernel lives in `csrc/<name>.cu` behind a plain C interface. At the
first launch its source is compiled with nvcc for Hopper (sm_90a) into a
shared library under `build/kernels/` at the repo root, named by a hash
of the sources and flags so an edited kernel never loads a stale build,
and bound with ctypes. Every C entry point launches on the stream it is
given (PyTorch's current stream), allocates nothing and returns
`cudaGetLastError()`; the wrapper raises when that is not 0.

Nothing here runs at import time: the CPU tests import every module of
the port on machines without nvcc or a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

def find_nvcc() -> str:
    """nvcc from CUDA_HOME, the standard toolkit location, or PATH."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.exists(c):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
            "built from csrc/ at first use"
        )
    return found


def build(name: str) -> Path:
    """Compile csrc/<name>.cu into a shared library, unless a build of
    the same sources and flags exists. Every csrc/*.cuh header enters
    the digest, so an edited header never loads a stale library."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256()
    for p in (src, *sorted(CSRC.glob("*.cuh"))):
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a private temp name per process and thread, then an atomic rename:
    # concurrent builds of one library (or of several) never clash
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {src.name}:\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


class CudaKernel:
    """One C entry point of one csrc/ library, with a launch counter.

    `launches` counts the launches this wrapper made; nothing else
    touches it, so a caller can zero it, run a path, and read how often
    the path went through the kernel.
    """

    def __init__(self, name: str, symbol: str, argtypes: list,
                 replaces: str, library: str = ""):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.replaces = replaces  # file:line of the TPU kernel it ports
        self.library = library or name  # csrc/<library>.cu holds it
        self.source = f"quadraturefields_tpu_torch/csrc/{self.library}.cu"
        self.launches = 0
        self._fn = None
        self._lib = None
        self._lock = threading.Lock()

    def load(self):
        with self._lock:
            if self._fn is None:
                lib = ctypes.CDLL(str(build(self.library)))
                fn = getattr(lib, self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                err = lib.qf_error_string
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._lib, self._fn = lib, fn
        return self._fn

    def launch(self, device: torch.device, *args) -> None:
        fn = self.load()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            code = fn(*args, ctypes.c_void_p(stream))
        if code != 0:
            msg = self._lib.qf_error_string(code).decode()
            raise RuntimeError(
                f"CUDA kernel {self.name} failed to launch: {msg} ({code})"
            )
        self.launches += 1


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check_cuda_tensor(t: torch.Tensor, name: str, dtype: torch.dtype,
                      device: torch.device, ndim: int) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor of rank `ndim`
    on `device` — the layout the C entry points assume."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected rank {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
