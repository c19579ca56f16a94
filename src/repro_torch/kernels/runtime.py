"""Kernel runtime of the port: device resolution, the nvcc build of the
hand-written CUDA kernels, and their launch counters.

Device policy (no environment switch):

* an entry point given ``device=`` uses it;
* otherwise it runs on ``cuda`` and raises when no GPU is present —
  the CPU is only ever used when the caller asks for it;
* a kernel wrapper decides by its input tensor alone: a CPU tensor takes
  the plain PyTorch version, a CUDA tensor launches the kernel or raises.

Build: every ``csrc/*.cu`` is compiled on first use by
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false -shared``
into ``build/repro_torch_kernels/`` at the root of the checkout (an
installed package uses ``~/.cache/repro_torch_kernels/``) and loaded
with ``ctypes`` (plain C entry points, no PyTorch headers, so a build
takes seconds).  ``--fmad=false`` keeps nvcc from contracting a
multiply-add into one rounding anywhere the kernel does not ask for it
explicitly — the elimination kernel must be bit-identical to its plain
version.  Library names carry a hash of the source and of the shared
headers (``csrc/*.cuh``), so an edited kernel is rebuilt and a stale one
is never loaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
_CHECKOUT = Path(__file__).resolve().parents[3]
# inside a checkout (src/ layout) the kernels build into its git-ignored
# build/; an installed package builds into the user's cache instead
BUILD_DIR = (_CHECKOUT / "build" / "repro_torch_kernels"
             if (_CHECKOUT / "pyproject.toml").is_file()
             and CSRC.parents[1].name == "src"
             else Path.home() / ".cache" / "repro_torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

# launches per kernel since the last reset; a wrapper adds one exactly
# where it launches its kernel.  Serving threads (a cluster's replica
# drivers and factor workers) launch concurrently, so every update holds
# _COUNT_LOCK: a read-modify-write of the dict is not atomic.
LAUNCHES: Dict[str, int] = {}
_COUNT_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else the
    GPU.  Raises when no GPU is present and none was asked for."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to "
                           "run the plain PyTorch path")
    return torch.device("cuda")


def count_launch(name: str, n: int = 1) -> None:
    """Add ``n`` launches of ``name`` (a C entry point that loops over
    levels reports how many it made)."""
    with _COUNT_LOCK:
        LAUNCHES[name] = LAUNCHES.get(name, 0) + n


def reset_launches() -> None:
    with _COUNT_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def nvcc() -> str:
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(exe).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source on the machine that runs them")
    return exe


def _lib_path(name: str) -> Path:
    # the shared headers are hashed too: an edited header rebuilds every
    # kernel that may include it
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu",
                                            *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile the named ``csrc/<name>.cu`` sources that are not built yet,
    one ``nvcc`` process per source, all started together.  Returns the
    compiler's report (registers, shared memory, spills) per source."""
    todo = {n: _lib_path(n) for n in names if not _lib_path(n).exists()}
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports = {}
    for name, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, out)
        reports[name] = log
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                build([name])
                lib = ctypes.CDLL(str(_lib_path(name)))
                _LIBS[name] = lib
    return lib


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def require(t: torch.Tensor, what: str, dtype: torch.dtype,
            ndim: Optional[int] = None, device: Optional[torch.device] = None
            ) -> None:
    """Wrapper-side argument check (device, dtype, rank, contiguity)."""
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{what}: expected {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")
    if device is not None and t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")


def _next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


def pad_k(k: int) -> int:
    """Panel-width tier of the fleet buckets: the next power of two."""
    return _next_pow2(max(int(k), 1))
