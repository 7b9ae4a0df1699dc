"""Build, load and launch the hand-written CUDA kernels in ``csrc/``.

Every ``csrc/*.cu`` is compiled on first use with ``nvcc`` for ``sm_90a``,
one ``nvcc`` per source, all started together, and linked into one shared
library under ``_build/`` (git-ignored), named by a hash of the sources and
flags so an edited source rebuilds.  The library has a plain
C interface and is loaded with ``ctypes``: every pointer and the stream are
``c_void_p``, every size or score is ``c_int``, and every entry point
returns ``cudaGetLastError()`` after its launch, which the wrapper turns
into an exception.

Each entry point is a ``Kernel``: a call names the device to launch on
(the card of its tensors, which need not be the thread's current device
under a mesh) and runs on that device's current stream.  A plain integer
launch counter, global to the process, counts only launches made through
it (under a lock: the seeding kernels
launch from the runner's prefetch thread while the consensus kernels
launch from the drive thread).  Nothing here runs at import: the
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
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v"]

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
    srcs = [s for s in _sources() if s.suffix == ".cu"]
    objs = [tmp.with_name(f"{tmp.name}.{s.stem}.o") for s in srcs]
    logs = [o.with_suffix(".log") for o in objs]
    t0 = time.perf_counter()
    procs = []
    for src, obj, log in zip(srcs, objs, logs):
        with open(log, "w") as err:
            procs.append(subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.DEVNULL, stderr=err))
    codes = [p.wait() for p in procs]
    build_log = "".join(log.read_text() for log in logs)
    res = None
    if not any(codes):
        res = subprocess.run([_nvcc(), *ARCH, "-shared", "-o", str(tmp),
                              *map(str, objs)], capture_output=True,
                             text=True)
        build_log += res.stderr
    build_seconds = time.perf_counter() - t0
    for f in (*objs, *logs):
        f.unlink(missing_ok=True)
    if any(codes) or res.returncode != 0:
        failed = [s.name for s, c in zip(srcs, codes) if c] or ["link"]
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n"
                           f"{build_log}")
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
        self.routes = {}        # launches by route, where the caller names it
        self._fn = None
        self._count = threading.Lock()

    def __call__(self, device, *args, route: Optional[str] = None) -> None:
        """Launch on `device` (the card of the pointer arguments, which the
        wrapper has checked share one device) with that device's current
        stream: the thread's current device may be another card.  `route`
        names the kernel an entry point that picks one by shape launched,
        and counts the launch under it too."""
        import torch

        if self._fn is None:
            lib = load()
            fn = getattr(lib, self.name)
            fn.argtypes = [*self.argtypes, P]
            fn.restype = ctypes.c_int
            self._fn = fn
        with torch.cuda.device(device):
            rc = self._fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            msg = load().th_error_string(rc).decode()
            raise RuntimeError(f"{self.name}: CUDA error {rc} ({msg})")
        with self._count:
            self.launches += 1
            if route is not None:
                self.routes[route] = self.routes.get(route, 0) + 1


def host_call(name: str, argtypes: list, restype, *args):
    """A plain host function of the library (no launch, not counted)."""
    fn = getattr(load(), name)
    fn.argtypes = argtypes
    fn.restype = restype
    return fn(*args)


# csrc/wavefront.cu
WF_GLOBAL = Kernel("wf_global", [P, I, P, I, P, P, P, I, I, I, I, I, I,
                                 P, P, P])
WF_EXT = Kernel("wf_ext", [P, I, P, I, P, P, I, I, I, I, I, I, P])
# csrc/profile_dp.cu
PROFILE_DP = Kernel("profile_dp", [P, I, P, P, P, P, P, P, P, I, I, I,
                                   I, I, I, I, I, I, P])
# the first version, and a route's kernel at any shape it takes: the
# yardsticks the routes are timed against
PROFILE_DP_FIRST = Kernel("profile_dp_first", PROFILE_DP.argtypes)
PROFILE_DP_ON = Kernel("profile_dp_on", [I, *PROFILE_DP.argtypes])
# csrc/profile_bt.cu
PROFILE_BT = Kernel("profile_bt", [P, I, I, I, P, P, I, P, P, P])
# csrc/wf_dtype_probe.cu
WF_DTYPE_PROBE = Kernel("wf_dtype_probe", [P, P, I, I, I, I])
# csrc/myers_hw.cu
MYERS_HW = Kernel("myers_hw", [P, P, I, I, P])
# csrc/seed_hits.cu
SEED_HITS = Kernel("seed_hits", [P, P, I, I, I, I, I, I, I, I, I, I, I, P,
                                 P, P, P, P])
# csrc/chain_dp.cu
CHAIN_DP = Kernel("chain_dp", [P, P, P, I, I, I, I, P, P, P])
# csrc/dtype_micro.cu
DTYPE_MICRO = Kernel("dtype_micro", [P, P, P, P, P, I, I, I])

KERNELS = (WF_GLOBAL, WF_EXT, PROFILE_DP, PROFILE_DP_FIRST,
           PROFILE_DP_ON, PROFILE_BT,
           WF_DTYPE_PROBE, MYERS_HW, SEED_HITS, CHAIN_DP, DTYPE_MICRO)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0
        k.routes = {}


def launches() -> dict:
    return {k.name: k.launches for k in KERNELS}
