"""Build, load and launch the hand-written CUDA kernels in ``csrc/``.

Every ``csrc/*.cu`` is compiled on first use with ``nvcc`` for ``sm_90a``
into one shared library under ``_build/`` (git-ignored), named by a hash of
the sources and flags so an edited source rebuilds.  The library has a plain
C interface and is loaded with ``ctypes``: every pointer and the stream are
``c_void_p``, every size or score is ``c_int``, and every entry point
returns ``cudaGetLastError()`` after its launch, which the wrapper turns
into an exception.

Each entry point is a ``Kernel`` with a plain integer launch counter that
counts only launches made through it.  Nothing here runs at import: the
CPU tests import every module of the package, and a CPU-only host has
neither ``nvcc`` nor a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

_DIR = Path(__file__).resolve().parent
CSRC = _DIR / "csrc"
BUILD_DIR = _DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_log = ""          # nvcc's stderr (ptxas register/smem report)
build_seconds = 0.0     # 0.0 when the library was already built


def require_cuda() -> None:
    """Raise unless PyTorch sees a CUDA card."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def build() -> Path:
    """Compile csrc/ into _build/ unless the hashed library exists."""
    global build_log, build_seconds
    import time

    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    lib = BUILD_DIR / f"libth_kernels_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in _sources() if s.suffix == ".cu"]]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = res.stderr
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with code {res.returncode}:\n{res.stderr}")
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            require_cuda()
            lib = ctypes.CDLL(str(build()))
            lib.th_error_string.argtypes = [ctypes.c_int]
            lib.th_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


P = ctypes.c_void_p
I = ctypes.c_int


class Kernel:
    """One C entry point of the library and its launch count."""

    def __init__(self, name: str, argtypes: list):
        self.name = name
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        import torch

        if self._fn is None:
            lib = load()
            fn = getattr(lib, self.name)
            fn.argtypes = [*self.argtypes, P]
            fn.restype = ctypes.c_int
            self._fn = fn
        rc = self._fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            msg = load().th_error_string(rc).decode()
            raise RuntimeError(f"{self.name}: CUDA error {rc} ({msg})")
        self.launches += 1


# csrc/wavefront.cu
WF_GLOBAL = Kernel("wf_global", [P, I, P, I, P, P, P, I, I, I, I, I, I,
                                 P, P, P])
WF_EXT = Kernel("wf_ext", [P, I, P, I, P, P, I, I, I, I, I, P, P, P, P])
# csrc/profile_dp.cu
PROFILE_DP = Kernel("profile_dp", [P, I, P, P, P, P, P, P, P, I, I, I,
                                   I, I, I, I, I, I, P])
# csrc/profile_bt.cu
PROFILE_BT = Kernel("profile_bt", [P, I, I, I, P, P, I, P, P, P])

KERNELS = (WF_GLOBAL, WF_EXT, PROFILE_DP, PROFILE_BT)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launches() -> dict:
    return {k.name: k.launches for k in KERNELS}
