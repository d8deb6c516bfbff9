"""Build the port's CUDA sources with ``nvcc`` at first use and load them
with ``ctypes``.

Each ``kernels/<name>/csrc/<name>.cu`` exposes a plain C interface and is
compiled on its own into ``build/repro_torch_kernels/<name>-<hash>.so`` at
the repository root (``build/`` is git-ignored); the hash covers the
source, the shared headers it can include (``kernels/csrc/*.cuh``, on the
include path) and the kernel's own flags, so an edited source, header or
flag rebuilds. Nothing is compiled or loaded when a module is imported:
``load`` runs inside the wrappers, on the first launch. ``build_all``
starts one ``nvcc`` per source at once, so a fresh checkout builds in the
time of its slowest file.

Flags, per kernel (``flags``): all but ``flash_attention`` are built with
``-fmad=false`` and no ``--use_fast_math`` (IEEE division stays the
default). The simulator and ML-state kernels must give their plain
versions' f32 bits in the latency, fraction and gate expressions, where a
fused multiply-add would round once where the plain version rounds twice
(``trace_window``'s one float subtract is exact, but it keeps the flags of
the bit-exact kernels);
``flash_decode`` keeps the flags it was measured with. ``flash_attention``
is held to a tolerance, not to bits, and its online softmax is
multiply-adds (``s * scale * log2(e) - m``, ``l * alpha + sum``, the
``acc * alpha`` rescale beside PV), so it keeps nvcc's default
contraction, which halves those instructions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["KERNEL_SOURCES", "BUILD_DIR", "flags", "build_all", "load", "check", "check_input"]

_KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS_DIR.parents[2] / "build" / "repro_torch_kernels"
KERNEL_SOURCES = {
    name: _KERNELS_DIR / name / "csrc" / f"{name}.cu"
    for name in (
        "chunk_replay", "ownership_sweep", "latency_histogram", "moe_router", "hot_gather",
        "flash_attention", "flash_decode", "trace_window",
    )
}
INCLUDE_DIR = _KERNELS_DIR / "csrc"  # headers shared between kernels
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BIT_EXACT = ("-fmad=false",)  # the plain versions' f32 rounding, operation by operation
KERNEL_FLAGS = {name: BIT_EXACT for name in KERNEL_SOURCES}
KERNEL_FLAGS["flash_attention"] = ()

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def flags(name: str) -> tuple[str, ...]:
    """The ``nvcc`` flags that build kernel ``name``."""
    return NVCC_FLAGS + KERNEL_FLAGS[name]


def _target(name: str) -> Path:
    h = hashlib.sha256(KERNEL_SOURCES[name].read_bytes())
    for header in sorted(INCLUDE_DIR.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(flags(name)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    """Start ``nvcc`` for ``name`` unless its library is already built."""
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    log = target.with_suffix(".log")
    proc = subprocess.Popen(
        [_nvcc(), *flags(name), "-I", str(INCLUDE_DIR), "-o", str(tmp),
         str(KERNEL_SOURCES[name])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return proc, tmp, log


def _finish(name: str, job: tuple[subprocess.Popen, Path, Path]) -> None:
    proc, tmp, log = job
    out, _ = proc.communicate()
    log.write_text(out)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}:\n{out}")
    os.replace(tmp, _target(name))  # atomic: concurrent builds agree


def build_all() -> dict[str, str]:
    """Build every kernel library, all ``nvcc`` runs in parallel. Returns
    the ``ptxas -v`` report of each source that was built now."""
    jobs = {name: _start(name) for name in KERNEL_SOURCES}
    reports = {}
    for name, job in jobs.items():
        if job is not None:
            _finish(name, job)
            reports[name] = job[2].read_text()
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built first if needed)."""
    lib = _loaded.get(name)
    if lib is None:
        job = _start(name)
        if job is not None:
            _finish(name, job)
        lib = ctypes.CDLL(str(_target(name)))
        getattr(lib, f"{name}_error_string").restype = ctypes.c_char_p
        getattr(lib, f"{name}_error_string").argtypes = [ctypes.c_int]
        getattr(lib, f"{name}_threads").restype = ctypes.c_int
        getattr(lib, f"{name}_threads").argtypes = []
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise when a launch function returned a CUDA error."""
    if code != 0:
        msg = getattr(lib, f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({code})")


def check_input(kernel: str, name: str, t: torch.Tensor, dtype: torch.dtype,
                shape: tuple, device: torch.device) -> None:
    """Raise unless ``t`` has the device, dtype, shape and contiguity the
    kernel reads its pointer with."""
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{kernel}: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")
