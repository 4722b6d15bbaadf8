"""Build and bind the port's CUDA sources (``src/repro_torch/csrc``).

The sources are compiled by ``nvcc`` into one shared library with a plain C
interface, loaded with ``ctypes``. The build runs at first use and lands in
``build/kernels/`` at the repository root, named by a hash of the sources
and flags, so an edited source rebuilds and an unchanged one loads at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

__all__ = ["KernelCounter", "build", "library", "policy_args", "check", "ptr", "stream_of", "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("fused_pde.cu",)
HEADERS = ("r2f2_device.cuh",)
#: IEEE arithmetic as the reference runs it: no fma contraction, IEEE
#: division, subnormals kept (never --use_fast_math)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-prec-div=true", "-ftz=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_I, _F, _P = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
_SIGNATURES = {
    # u_in, u_out, ev, k_floor, rows, nx, br, steps, alpha, dtodx2, policy(8), stream
    "r2f2_heat1d_sweep": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _F] + [_I] * 8 + [_P],
    # q1, q3, out, ev, k_floor, rows, width, br, bw, c, policy(8), stream
    "r2f2_swe_flux": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F] + [_I] * 8 + [_P],
}

_lib: Optional[ctypes.CDLL] = None

#: fused-family name -> the kernels' family code (csrc/r2f2_device.cuh)
FAMILY_CODES = {"f32": 0, "bf16": 1, "fixed": 2, "rr": 3}


class KernelCounter:
    """Launch accounting beside one kernel: ``launches`` counts kernel
    launches, ``plain_calls`` counts runs of the plain PyTorch version."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        self.plain_calls = 0

    def reset(self) -> None:
        self.launches = 0
        self.plain_calls = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): cannot build the CUDA kernels")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libfused_pde_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library for this exact source hash
    exists; the compiler's register/shared-memory report lands beside it."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(CSRC / s) for s in SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed with exit code {res.returncode}:\n{res.stderr}")
    out.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def policy_args(prec, family: str):
    """The eight policy ints every kernel takes, in ``Policy`` field order."""
    fmt = prec.fmt
    fe, fm = prec.fixed_em
    return (FAMILY_CODES[family], fmt.eb, fmt.mb, fmt.fx, fe, fm, int(prec.tail_approx), int(prec.pinned))


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
