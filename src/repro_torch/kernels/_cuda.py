"""Build and bind the port's CUDA sources (``src/repro_torch/csrc``).

The sources are compiled by ``nvcc`` into one shared library with a plain C
interface, loaded with ``ctypes``: one ``nvcc -c`` per source, all started
together, then one link. The build runs at first use and lands in
``build/kernels/`` at the repository root, named by a hash of the sources
and flags, so an edited source rebuilds and an unchanged one loads at once.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple, Optional

import torch

__all__ = [
    "KernelCounter", "StorageIO", "CaptureIO", "capture_io", "MAX_BINS", "build", "library", "nvcc_version", "policy_args", "check", "ptr", "stream_of", "sm_count",
    "NVCC_FLAGS", "SMEM_LIMIT",
]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = (
    "fused_pde.cu", "mega_pde.cu", "rod_warp.cu", "rod_warp_advection.cu", "rod_warp_burgers.cu", "rod_grid.cu",
    "rod_grid_heat2d.cu", "rod_grid_periodic.cu", "pde_steps.cu", "r2f2_quantize.cu", "r2f2_matmul.cu",
    "r2f2_storage.cu", "generic_body.cu",
)
HEADERS = ("r2f2_device.cuh", "rod.cuh", "rod_warp.cuh", "rod_grid.cuh")
#: the one target, for the compile and the link
GENCODE = ("-gencode", "arch=compute_90a,code=sm_90a")
#: IEEE arithmetic as the reference runs it: no fma contraction, IEEE
#: division (never --use_fast_math), and f32 subnormal inputs and results
#: flushed to zero, as XLA runs the reference on the CPU and the TPU (every
#: kernel: the PDE kernels, K6 and K7)
NVCC_FLAGS = (
    *GENCODE, "-std=c++17", "-O3",
    "--fmad=false", "-prec-div=true", "-ftz=true",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


#: shared memory a one-CTA kernel may take for its field and scratch rows
SMEM_LIMIT = 200 * 1024


_I, _F, _P = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
_CAPTURE = [_P] + [_I] * 4  # CaptureIO.args()
_SIGNATURES = {
    # the rod bodies (K2, K4 heat1d, K5b/c/e/f, K5a/d's grid): body, u_in, u_out, snaps, ev, work,
    # maxes, count, trk k/hi/lo/ov/sh, site_cfg, evolve, blocks, members, n, row, steps, every,
    # shape, threads, cells, ctas, c0, c1, ema, 1 - ema, headroom, policy(8), storage(6),
    # capture(5), stream
    "r2f2_rod": [_I] + [_P] * 13 + [_I] * 11 + [_F] * 4 + [_I] + [_I] * 8 + [_P] * 4 + [_I] * 2 + _CAPTURE + [_P],
    # q1, q3, out, ev, k_floor, members, rows, width, br, bw, cluster, band, c, policy(8),
    # capture(5), stream
    "r2f2_swe_flux": [_P] * 5 + [_I] * 7 + [_F] + [_I] * 8 + _CAPTURE + [_P],
    # u_in, u_out, snaps, ev, ux, bands, words, count, ka, trk k/hi/lo/ov/sh, site_cfg, evolve,
    # members, wave, nx, ny, steps, every, ctas, threads, rows, smem, dt/(2dx), dt/(2dy), dt/dx,
    # dt/dy, g/2, ema, 1 - ema, headroom, policy(8), stream
    "r2f2_swe2d_mega": [_P] * 15 + [_I] * 11 + [_F] * 7 + [_I] + [_I] * 8 + [_P],
    # threads, band-array bytes, histogram bins: the CTAs one cooperative grid holds
    "r2f2_swe2d_capacity": [_I] * 3,
    # x, y, k_tiles, m, n, bm, bn, eb, mb, fx, cluster (0: the two-pass shape), rows, stream
    "r2f2_quantize": [_P] * 3 + [_I] * 9 + [_P],
    # a, b, c, scratch, m, n, kdim, bm, bn, bk, splits, slots, eb, mb, fx, round_products,
    # tail_approx, stream
    "r2f2_matmul": [_P] * 4 + [_I] * 13 + [_P],
}
# heat2d's cluster kernels (csrc/pde_steps.cu): sweep u_in, u_out, ev, k_floor, members, nx, ny,
# steps, c0, c1, the cluster's CTAs and band rows, policy(8), storage(6), capture(5), stream; mega
# u_in, u_out, snaps, ev, trk k/hi/lo/ov/sh, site_cfg, evolve, members, nx, ny, steps, every, c0,
# c1, CTAs, band, ema, 1 - ema, headroom, policy(8), storage(6), capture(5), stream; swe2d's
# megakernel takes storage(6) and capture(5) before its stream too
_STORAGE = [_P] * 4 + [_I] * 2  # StorageIO.args()
_SIGNATURES["r2f2_heat2d_sweep"] = [_P] * 4 + [_I] * 4 + [_F] * 2 + [_I] * 2 + [_I] * 8 + _STORAGE + _CAPTURE + [_P]
_SIGNATURES["r2f2_heat2d_mega"] = (
    [_P] * 10 + [_I] * 6 + [_F] * 2 + [_I] * 2 + [_F] * 2 + [_I] + [_I] * 8 + _STORAGE + _CAPTURE + [_P]
)
_SIGNATURES["r2f2_swe2d_mega"] = _SIGNATURES["r2f2_swe2d_mega"][:-1] + _STORAGE + _CAPTURE + [_P]

# K1's storage harness (csrc/r2f2_storage.cu): mode, x, payload, k_in, k_out, y, rows, width, br,
# bw, k_min, payload bytes, eb, mb, fx, stream
_SIGNATURES["r2f2_storage"] = [_I] + [_P] * 5 + [_I] * 9 + [_P]

# K8 and K9, the generic sweep and megakernel (csrc/generic_body.cu): the tape (code, rows, out code, rows,
# constants), the work buffer, its floats a CTA, the state's and the scratch's floats, then
# K8: in and out leaf pointers (host arrays), n_state, n_out, k_in, k_out, payload bytes, packed, ev,
#     k_floor, members, rows, width, br, bw, gi, gj, steps, n_sites, threads, policy(8), capture(5), stream;
# K9: in, out and snapshot pointers and the leaves' offsets and sizes (host arrays), n_state, k_in, kst,
#     payload bytes, packed, round, ev, trk k/hi/lo/ov/sh, site_cfg, evolve, has_floor, members, steps, every,
#     n_sites, threads, ema, 1 - ema, headroom, policy(8), capture(5), stream
_LL = ctypes.c_longlong
_TAPE = [_P, _I, _P, _I, _P, _P, _LL, _I, _I]
_SIGNATURES["r2f2_generic_sweep"] = _TAPE + [_P] * 2 + [_I] * 2 + [_P] * 2 + [_I] * 2 + [_P] * 2 + [_I] * 10 + [_I] * 8 + _CAPTURE + [_P]
# K1's harness of its add and rsqrt (csrc/generic_body.cu): op, a, b, out, n, k, policy(8), stream
_SIGNATURES["r2f2_family_op"] = [_I] + [_P] * 3 + [_I] * 2 + [_I] * 8 + [_P]
_SIGNATURES["r2f2_generic_mega"] = (
    _TAPE + [_P] * 5 + [_I] + [_P] * 2 + [_I] * 3 + [_P] * 7 + [_I] * 7 + [_F] * 2 + [_I] + [_I] * 8 + _CAPTURE + [_P]
)

_lib: Optional[ctypes.CDLL] = None

#: fused-family name -> the kernels' family code (csrc/r2f2_device.cuh)
FAMILY_CODES = {"f32": 0, "bf16": 1, "fixed": 2, "rr": 3}


class KernelCounter:
    """Launch accounting beside one kernel: ``launches`` counts kernel
    launches, ``plain_calls`` counts runs of the plain PyTorch version,
    ``storage`` the launches of each storage variant among the launches, and
    ``captured`` the launches that binned their operands."""

    def __init__(self, name: str):
        self.name = name
        self.reset()

    def reset(self) -> None:
        self.launches = 0
        self.plain_calls = 0
        self.storage = {"packed": 0, "quantized": 0}
        self.captured = 0

    def count(self, storage: str = "f32", capture: bool = False) -> None:
        """One launch, of the storage variant ``storage``, capturing or not."""
        self.launches += 1
        if storage in self.storage:
            self.storage[storage] += 1
        self.captured += bool(capture)


class StorageIO(NamedTuple):
    """A launch's storage arguments (``csrc/r2f2_device.cuh::Storage``): a
    packed input (payload and its split) in place of f32, a packed output,
    the megakernels' rounding at snapshot boundaries, and the output split
    (a packed output's, or a megakernel's carried split ``kst``)."""

    pay_in: Optional[torch.Tensor] = None
    k_in: Optional[torch.Tensor] = None
    pay_out: Optional[torch.Tensor] = None
    k_out: Optional[torch.Tensor] = None
    round: bool = False

    def args(self):
        """The six C arguments: the four pointers, payload bytes, round."""
        pay = self.pay_in if self.pay_in is not None else self.pay_out
        width = 4 if pay is None else pay.element_size()
        return (ptr(self.pay_in), ptr(self.k_in), ptr(self.pay_out), ptr(self.k_out), width, int(self.round))


#: most exponent bins a kernel's histogram takes (csrc/r2f2_device.cuh::kMaxBins)
MAX_BINS = 512


class CaptureIO(NamedTuple):
    """A launch's capture arguments (``csrc/r2f2_device.cuh::Capture``): the
    zeroed ``(slots, n_sites, 2, n_bins)`` int32 histogram buffer (None:
    capture off), the spec's low exponent, and the valid extent of a padded
    field (K3; the others take the field whole)."""

    out: Optional[torch.Tensor] = None
    e_lo: int = 0
    rows: int = 0
    cols: int = 0

    def args(self):
        """The five C arguments: the buffer, e_lo, n_bins, rows, cols."""
        n_bins = 0 if self.out is None else int(self.out.shape[-1])
        return (ptr(self.out), int(self.e_lo), n_bins, int(self.rows), int(self.cols))


def capture_io(spec, slots: int, n_sites: int, device, rows: int = 0, cols: int = 0, members: int = 1) -> CaptureIO:
    """A zeroed histogram buffer of ``slots`` slots a member (``(members,
    slots, n_sites, 2, n_bins)``) for a CaptureSpec (an empty CaptureIO for
    None). Raises where the spec has more bins than the kernels'
    histograms take."""
    if spec is None:
        return CaptureIO()
    if spec.n_bins > MAX_BINS:
        raise ValueError(f"the kernels' histograms take at most {MAX_BINS} bins; the spec has {spec.n_bins}")
    out = torch.zeros((members, slots, n_sites, 2, spec.n_bins), dtype=torch.int32, device=device)
    return CaptureIO(out, spec.e_lo, rows, cols)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): cannot build the CUDA kernels")


def nvcc_version() -> str:
    """The last line of ``nvcc --version`` (the toolkit's release and build)."""
    res = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True)
    return res.stdout.strip().splitlines()[-1] if res.returncode == 0 and res.stdout.strip() else "unknown"


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library for this exact source hash
    exists: every source at once, then one link. The compiler's
    register/shared-memory report lands beside the library."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(src).stem}.o" for src in SOURCES]
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(SOURCES, objs)
    ]
    # each source's wall time, read as it finishes (the slowest sets the build's)
    with concurrent.futures.ThreadPoolExecutor(len(procs)) as pool:
        done = list(pool.map(lambda p: (p.communicate()[0], time.perf_counter() - t0), procs))
    logs = [f"== {src} ({seconds:.1f} s)\n{text}" for src, (text, seconds) in zip(SOURCES, done)]
    failed = [src for src, proc in zip(SOURCES, procs) if proc.returncode != 0]
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = out.with_name(f"{tag}.tmp")
    res = subprocess.run(
        [nvcc, *GENCODE, "-shared", "-o", str(tmp), *map(str, objs)],
        capture_output=True, text=True,
    )
    for obj in objs:
        obj.unlink()
    if res.returncode != 0:
        raise RuntimeError(f"linking the kernels failed with exit code {res.returncode}:\n{res.stderr}")
    out.with_suffix(".log").write_text("\n".join(logs) + res.stdout + res.stderr)
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


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(torch.device(device)).multi_processor_count
