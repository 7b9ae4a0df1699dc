"""The port's CUDA sources for the redesigned kernels, run on the CPU.

csrc/wavefront.cu (``wf_global``) and csrc/profile_dp.cu (``profile_dp``,
both its warp kernel and its first version) are compiled with the host's
C++ compiler over tests/cuda_shim.h, which emulates the CUDA subset they
use (threads, warp shuffles, barriers, shared memory, the DPX
intrinsics), and called through the same C entry points and argument
lists that _kernels.py binds.  Every output must equal the port's plain
version exactly.  This runs the kernels' own index arithmetic, shuffles
and edge-column hand-off here; the card's compiler, timing and memory
model are only checked on the card (chip_smoke.py).
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from tidehunter_tpu_torch import _kernels as K
from tidehunter_tpu_torch.ops import msa_device as TMD
from tidehunter_tpu_torch.ops import wavefront as TW

torch.set_num_threads(1)

SOURCES = ("wavefront.cu", "profile_dp.cu")


def _translate(src: str) -> str:
    """CUDA C++ -> C++ over cuda_shim.h: the include, dynamic shared
    memory and the <<<...>>> launches."""
    src = src.replace("#include <cuda_runtime.h>", '#include "cuda_shim.h"')
    src = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                 r"\1* \2 = (\1*)shim_smem;", src)
    return re.sub(r"([\w:]+(?:<[\w, ]+>)?)\s*<<<(.*?)>>>\s*\(",
                  r"shim_launch(\1, \2, ", src, flags=re.S)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler on this host")
    out = tmp_path_factory.mktemp("csrc_shim")
    shutil.copy(Path(__file__).with_name("cuda_shim.h"), out)
    cpps = []
    for name in SOURCES:
        cpp = out / f"{name}.cpp"
        cpp.write_text(_translate((K.CSRC / name).read_text()))
        cpps.append(str(cpp))
    so = out / "libshim.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
                    "-I", str(out), "-o", str(so), *cpps], check=True)
    dll = ctypes.CDLL(str(so))
    fns = {}
    for k in (K.WF_GLOBAL, K.PROFILE_DP):
        fn = getattr(dll, k.name)
        fn.argtypes = [*k.argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[k.name] = fn
    return fns


def _p(a):
    return None if a is None else a.ctypes.data


def _pairs(rng, B, LQ, T):
    q = np.full((B, LQ), 4, np.uint8)
    t = np.full((B, T), 4, np.uint8)
    qlen = np.zeros(B, np.int32)
    tlen = np.zeros(B, np.int32)
    for b in range(B):
        m, n = [(1, 1), (LQ, T), (1, T), (LQ, 1)][b] if b < 4 else (
            int(rng.integers(1, LQ + 1)), int(rng.integers(1, T + 1)))
        base = rng.integers(0, 5, max(m, n)).astype(np.uint8)
        q[b, :m] = np.where(rng.random(m) < 0.8, base[:m],
                            rng.integers(0, 5, m))
        t[b, :n] = np.where(rng.random(n) < 0.8, base[:n],
                            rng.integers(0, 5, n))
        qlen[b], tlen[b] = m, n
    qle = np.array([int(rng.integers(0, qlen[b] + 2)) for b in range(B)],
                   np.int32)
    return q, qlen, t, tlen, qle


# (B, LQ, T, global scratch): strips of 4, 8 and 16 columns; two and three
# column tiles with the edge column in shared memory or global scratch
@pytest.mark.parametrize("B,LQ,T,scratch", [
    (8, 40, 40, False), (8, 30, 200, False), (4, 20, 700, False),
    (4, 20, 700, True), (5, 9, 1100, True)])
def test_wf_global_source_matches_plain(lib, B, LQ, T, scratch):
    q, qlen, t, tlen, qle = _pairs(np.random.default_rng(T + B), B, LQ, T)
    for iden_only in (True, False):
        iden = np.zeros(B, np.int32)
        tleft = np.zeros(B, np.int32)
        scr = np.zeros(B * LQ * 4, np.int32) if scratch else None
        rc = lib["wf_global"](_p(q), LQ, _p(t), T, _p(qlen), _p(tlen),
                              _p(qle), B, *TW.DEFAULT_SCORES, int(iden_only),
                              _p(iden), _p(tleft), _p(scr), None)
        assert rc == 0
        wi, wt = TW.global_plain(
            *map(torch.from_numpy, (q, qlen, t, tlen, qle)),
            TW.DEFAULT_SCORES, not iden_only)
        np.testing.assert_array_equal(iden, wi.numpy())
        np.testing.assert_array_equal(tleft, wt.numpy())


# (T, W, B, unit length): the warp kernel on each band rung, the first
# version at full width and at a band width the rungs do not use
@pytest.mark.parametrize("T,W,B,L", [
    (200, 128, 5, 150), (300, 256, 3, 220), (640, 512, 2, 450),
    (160, None, 2, 120), (192, 136, 2, 150)])
def test_profile_dp_source_matches_plain(lib, T, W, B, L):
    rng = np.random.default_rng(T)
    units = np.full((B, 2, T), 4, np.uint8)
    ulen = np.zeros((B, 2), np.int32)
    for b in range(B):
        base = rng.integers(0, 4, L).astype(np.uint8)
        for k in range(2):
            n = L if b else L // 2 + 7 * k     # one uneven pair
            u = np.where(rng.random(n) < 0.9, base[:n], rng.integers(0, 4, n))
            units[b, k, :n] = u
            ulen[b, k] = n
    msa = TMD.DeviceMSA(2, 4, 4, 2, device="cpu", gap_open2=24, gap_ext2=1)
    st = msa.init_state(torch.from_numpy(units), torch.from_numpy(ulen))
    sub, wdel, wl, wdel2, wl2 = msa.scores_step(st)
    args = [torch.from_numpy(units[:, 1].copy()),
            torch.from_numpy(ulen[:, 1].copy()), st.ncol, sub, wl, wdel,
            wl2, wdel2]
    want = TMD.profile_dp_plain(*args, msa.costs, W).numpy()
    unit, qlen, ncol, sub, wl, wdel, wl2, wdel2 = (
        a.contiguous().numpy() for a in args)
    dirs = np.full((2 * T - 1, B, W or T), 0x77, np.uint8)
    rc = lib["profile_dp"](_p(unit), T, _p(sub), _p(wl), _p(wdel), _p(wl2),
                           _p(wdel2), _p(qlen), _p(ncol), B, T, W or 0,
                           *msa.costs, _p(dirs), None)
    assert rc == 0
    live = np.arange(2 * T - 1)[:, None] < (qlen + ncol - 1)[None, :]
    np.testing.assert_array_equal(dirs[live], want[live])
