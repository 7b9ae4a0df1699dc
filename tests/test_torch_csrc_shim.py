"""The port's CUDA sources for the redesigned kernels, run on the CPU.

csrc/wavefront.cu (``wf_global``, ``wf_ext``), csrc/profile_dp.cu
(``profile_dp``: its warp kernel, its band kernel and its strips, one CTA
or a cluster a region; ``profile_dp_first``, the first version;
``profile_dp_on``, a route's kernel at any shape), csrc/profile_bt.cu
(``profile_bt``), csrc/myers_hw.cu (``myers_hw``), csrc/seed_hits.cu
(``seed_hits``: shared-memory and global-scratch routes, 32- and 64-bit
seed words), csrc/chain_dp.cu (``chain_dp``) and csrc/dtype_micro.cu
(``dtype_micro``, the element-type rate tool's step at every type) are
compiled with the host's C++ compiler over tests/cuda_shim.h, which
emulates the CUDA subset they use (threads, warp shuffles and ballots,
barriers, shared memory, cp.async copies, Hopper's bulk copies and their
mbarriers, thread-block clusters and their distributed shared memory, the
DPX intrinsics; bfloat16 arithmetic comes from BF16_SHIM below), and
called
through the same C entry points and argument lists that _kernels.py
binds.  Every output must equal the port's plain version exactly.  This
runs the kernels' own index arithmetic, shuffles, tiles and epilogues
here; the card's compiler, timing and memory model are only checked on
the card (chip_smoke.py).
"""

import ctypes
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import test_torch_kernel_order as KO
import test_torch_myers as TM
import torch
from test_chaining_jax import _random_read
from test_offload import _random_reads

from tidehunter_tpu.ops.seeding import collect_tandem_repeat_hits
from tidehunter_tpu_torch import _kernels as K
from tidehunter_tpu_torch.evals import dtype_micro as DM
from tidehunter_tpu_torch.ops import chaining_device as CD
from tidehunter_tpu_torch.ops import msa_device as TMD
from tidehunter_tpu_torch.ops import seeding_device as SD
from tidehunter_tpu_torch.ops import myers_device as MY
from tidehunter_tpu_torch.ops import wavefront as TW

torch.set_num_threads(1)

SOURCES = ("wavefront.cu", "profile_dp.cu", "profile_bt.cu", "myers_hw.cu",
           "seed_hits.cu", "chain_dp.cu", "dtype_micro.cu")


# cuda_bf16.h's bfloat16 for the shim: each op in float, rounded to
# nearest even, as the card's bf16 add, subtract and max round (NaN is not
# modelled)
BF16_SHIM = """
#include "cuda_shim.h"
#include <cmath>
struct __nv_bfloat16 { uint16_t bits; };
inline float shim_bf2f(__nv_bfloat16 h) {
  const uint32_t u = (uint32_t)h.bits << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 shim_f2bf(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  u += 0x7FFFu + ((u >> 16) & 1u);
  return {(uint16_t)(u >> 16)};
}
inline __nv_bfloat16 __hadd(__nv_bfloat16 a, __nv_bfloat16 b) {
  return shim_f2bf(shim_bf2f(a) + shim_bf2f(b));
}
inline __nv_bfloat16 __hsub(__nv_bfloat16 a, __nv_bfloat16 b) {
  return shim_f2bf(shim_bf2f(a) - shim_bf2f(b));
}
inline __nv_bfloat16 __hmax(__nv_bfloat16 a, __nv_bfloat16 b) {
  return shim_bf2f(a) >= shim_bf2f(b) ? a : b;
}
inline bool __hgt(__nv_bfloat16 a, __nv_bfloat16 b) {
  return shim_bf2f(a) > shim_bf2f(b);
}
"""


def _translate(src: str) -> str:
    """CUDA C++ -> C++ over cuda_shim.h: the includes (cuda_bf16.h becomes
    BF16_SHIM), dynamic shared memory and the <<<...>>> launches."""
    src = src.replace("#include <cuda_runtime.h>", '#include "cuda_shim.h"')
    src = src.replace("#include <cuda_pipeline.h>", "")
    src = src.replace("#include <cuda_bf16.h>", BF16_SHIM)
    src = src.replace("#include <cooperative_groups.h>", "")
    src = src.replace('#include "bulk_copy.cuh"', "")
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
    probe = out / "shim_probe.cpp"
    probe.write_text('#include "cuda_shim.h"\n'
                     'extern "C" int shim_last_cluster() '
                     '{ return shim_cluster_size; }\n'
                     'extern "C" int shim_take_mbars() { std::lock_guard<'
                     'std::mutex> g(shim_mbar_mu); const int n = '
                     'shim_mbar_inits; shim_mbar_inits = 0; '
                     'return n; }\n')
    cpps = [str(probe)]
    for name in SOURCES:
        cpp = out / f"{name}.cpp"
        cpp.write_text(_translate((K.CSRC / name).read_text()))
        cpps.append(str(cpp))
    so = out / "libshim.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
                    "-I", str(out), "-o", str(so), *cpps], check=True)
    dll = ctypes.CDLL(str(so))
    fns = {}
    for k in (K.WF_GLOBAL, K.WF_EXT, K.PROFILE_DP, K.PROFILE_DP_FIRST,
              K.PROFILE_DP_ON, K.PROFILE_BT, K.MYERS_HW, K.SEED_HITS,
              K.CHAIN_DP, K.DTYPE_MICRO):
        fn = getattr(dll, k.name)
        fn.argtypes = [*k.argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[k.name] = fn
    for name in ("seed_hits_row_bytes", "seed_hits_scratch_bytes"):
        fn = getattr(dll, name)
        fn.argtypes = [ctypes.c_int] * (4 if "row" in name else 5)
        fn.restype = ctypes.c_longlong
        fns[name] = fn
    fns["seed_hits_route"] = dll.seed_hits_route
    fns["seed_hits_route"].argtypes = [ctypes.c_int] * 4
    fns["myers_hw_lanes"] = dll.myers_hw_lanes
    fns["myers_hw_lanes"].argtypes = [ctypes.c_int]
    fns["shim_last_cluster"] = dll.shim_last_cluster
    fns["shim_take_mbars"] = dll.shim_take_mbars
    fns["profile_dp_route"] = dll.profile_dp_route
    fns["profile_dp_route"].argtypes = [ctypes.c_int] * 2
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


def _dp_round(rng, T, B, lens):
    """One unit round (unit 1 against the profile of unit 0) of B regions
    with unit lengths lens[b] = (n0, n1): the NumPy arguments of the entry
    point, the costs and the plain version's plane."""
    units = np.full((B, 2, T), 4, np.uint8)
    ulen = np.zeros((B, 2), np.int32)
    for b, (n0, n1) in enumerate(lens):
        base = rng.integers(0, 4, max(n0, n1)).astype(np.uint8)
        for k, n in enumerate((n0, n1)):
            u = np.where(rng.random(n) < 0.9, base[:n], rng.integers(0, 4, n))
            units[b, k, :n] = u
            ulen[b, k] = n
    msa = TMD.DeviceMSA(2, 4, 4, 2, device="cpu", gap_open2=24, gap_ext2=1)
    st = msa.init_state(torch.from_numpy(units), torch.from_numpy(ulen))
    sub, wdel, wl, wdel2, wl2 = msa.scores_step(st)
    args = [torch.from_numpy(units[:, 1].copy()),
            torch.from_numpy(ulen[:, 1].copy()), st.ncol, sub, wl, wdel,
            wl2, wdel2]
    return [a.contiguous().numpy() for a in args], msa.costs, args


def _dp_check(lib, entry, T, W, B, lens, seed, *extra, route=None):
    """The entry point's plane (profile_dp_on's with a route) equals
    profile_dp_plain's on every row a region writes (dead lanes 0), and
    rows past qlen + ncol - 1 stay untouched."""
    (unit, qlen, ncol, sub, wl, wdel, wl2, wdel2), costs, targs = _dp_round(
        np.random.default_rng(seed), T, B, lens)
    want = TMD.profile_dp_plain(*targs, costs, W).numpy()
    dirs = np.full((2 * T - 1, B, W or T), 0x77, np.uint8)
    head = () if route is None else (TMD.DP_ROUTES.index(route),)
    rc = lib[entry](*head, _p(unit), T, _p(sub), _p(wl), _p(wdel), _p(wl2),
                    _p(wdel2), _p(qlen), _p(ncol), B, T, W or 0, *costs,
                    _p(dirs), *extra, None)
    assert rc == 0
    live = np.arange(2 * T - 1)[:, None] < (qlen + ncol - 1)[None, :]
    np.testing.assert_array_equal(dirs[live], want[live])
    assert (dirs[~live] == 0x77).all()


# (T, W, B, unit length): the warp kernel on each band rung; the strips
# at full width (one warp a region) and at a band width the rungs do not
# use
@pytest.mark.parametrize("T,W,B,L", [
    (200, 128, 5, 150), (300, 256, 3, 220), (640, 512, 2, 450),
    (160, None, 2, 120), (192, 136, 2, 150)])
def test_profile_dp_source_matches_plain(lib, T, W, B, L):
    lens = [(L // 2, L // 2 + 7)] + [(L, L)] * (B - 1)    # one uneven pair
    _dp_check(lib, "profile_dp", T, W, B, lens, T)


# (T, W, B, SMs the launcher sees): a region a warp (T <= 128, a partial
# last CTA, banded too), two to eight skewed warps in one CTA (1 SM, or few
# warps) or over a cluster of 2 or 4 CTAs (132 SMs), banded with warps that
# skip most rows or whole rounds; uneven pairs, a unit longer than the
# profile, a one-base unit
@pytest.mark.parametrize("T,W,B,sms", [
    (128, None, 6, 132), (256, None, 3, 132), (384, 200, 2, 132),
    (512, None, 2, 132), (640, None, 3, 1), (640, None, 3, 132),
    (768, 136, 2, 1), (1024, 264, 2, 132), (1280, None, 1, 132),
    (32, None, 5, 132), (64, 40, 3, 132), (160, None, 3, 1),
    (256, 72, 2, 132), (384, None, 2, 132), (640, 136, 2, 1)],
    ids=["T128", "T256", "T384_W200", "T512", "T640_cta", "T640_cluster2",
         "T768_W136_cta", "T1024_W264_cluster2", "T1280_cluster4",
         "T32_solo", "T64_W40_solo", "T160_cta", "T256_W72_cluster",
         "T384_cluster", "T640_W136_cta"])
def test_profile_dp_strips_match_plain(lib, monkeypatch, T, W, B, sms):
    monkeypatch.setenv("CUDA_SHIM_SMS", str(sms))
    n = T * 3 // 4
    lens = [(n, max(n - 40, 1)), (max(n - 30, 1), n), (T // 3, 1), (n, n),
            (n // 2, n), (1, n)][:B]
    _dp_check(lib, "profile_dp", T, W, B, lens, T + (W or 0) + sms)


def test_profile_dp_first_version_matches_plain(lib):
    for T, W in ((160, None), (192, 136)):
        _dp_check(lib, "profile_dp_first", T, W, 2, [(70, 77), (150, 150)],
                  T)


# (T, W): the band kernel on 4, 8 and 16 warps at every width the profile
# allows; T = 298 is not whole 16-byte pieces a plane, so its profile
# comes by plain loads, not bulk copies
@pytest.mark.parametrize("T,W", [
    (300, 128), (300, 256), (640, 128), (640, 256), (640, 512),
    (1024, 128), (1024, 256), (1024, 512), (298, 128)])
def test_profile_dp_band_source_matches_plain(lib, T, W):
    """The band kernel (one band lane a thread over W / 32 warps, edge
    words through shared memory, the profile by bulk copies) equals the
    plain version on every live row: uneven pairs, a unit longer than the
    profile, a one-base unit, and long pairs (qlen + ncol > 2W) whose
    window slides across every warp edge, up to T = 640 to the T - W
    clamp (at T = 1024 the shim's run of ~2000 rows would take most of
    the file's time)."""
    n = T - 3 if T < 1024 else 5 * T // 8
    # a long pair, then by turns a unit longer than the profile, a
    # one-base unit and an uneven short pair
    lens = [(n + 3, n) if W % 256 else (n, n + 3),
            [(n // 2, T), (1, T // 2),
             (T // 2, T // 2 + 9)][(T // 100 + W // 128) % 3]]
    B = len(lens)
    rows = max(a + b for a, b in lens) - 1
    assert rows > 2 * W + 8
    if T < 1024:
        assert rows - 1 >= 2 * (T - W) + W - 8 + 4
    lib["shim_take_mbars"]()
    _dp_check(lib, "profile_dp_on", T, W, B, lens, T + W, route="band")
    # the bulk route initialises one mbarrier a chunk of 256 columns
    assert lib["shim_take_mbars"]() == (0 if T % 4 else -(-T // 256) * B)


def test_profile_dp_routes_match_python(lib):
    """The entry point's dp_route (the host query profile_dp_route) is
    msa_device.dp_route on every bucket and band width."""
    for T in TMD.BUCKETS:
        for W in (None, 128, 136, 256, 512):
            got = TMD.DP_ROUTES[lib["profile_dp_route"](T, W or 0)]
            assert got == TMD.dp_route(T, W), (T, W)


@pytest.mark.parametrize("route", ["strips", "warp", "band"])
def test_profile_dp_on_runs_each_route(lib, route):
    """profile_dp_on runs the named route's kernel wherever the route does
    not take the shape: all three equal the plain version at T = 640, W =
    256 (the warp kernel's rung) and at the 4096 bucket's W = 128."""
    _dp_check(lib, "profile_dp_on", 640, 256, 2, [(300, 310), (5, 200)], 3,
              route=route)
    _dp_check(lib, "profile_dp_on", 4096, 128, 1, [(70, 90)], 4,
              route=route)


def test_profile_dp_on_refuses_what_no_kernel_takes(lib):
    """A band width the warp and band kernels lack, a window as wide as
    the profile, a wide profile and an unknown route: refused before any
    access."""
    one = np.ones(1, np.int32)
    args = (_p(np.zeros(1, np.uint8)), 1, *(_p(one),) * 7, 1)
    for route, T, W in ((1, 640, 136), (2, 640, 136), (2, 256, 256),
                        (0, 4097, 0), (3, 640, 256)):
        assert lib["profile_dp_on"](route, *args, T, W, 4, 2, 4, 24, 1, 24,
                                    _p(np.zeros(1, np.uint8)), None) == 1


def test_profile_dp_band_route_at_4096(lib):
    """profile_dp at the 4096 bucket's W = 256 launches the band kernel
    (its bulk copies initialise 16 mbarriers a region) and equals the
    plain version; short units keep the shim's run short."""
    assert TMD.dp_route(4096, 256) == "band"
    lib["shim_take_mbars"]()
    _dp_check(lib, "profile_dp", 4096, 256, 2, [(150, 160), (90, 60)], 11)
    assert lib["shim_take_mbars"]() == 2 * 16


@pytest.mark.parametrize("entry", ["profile_dp", "profile_dp_first"])
def test_profile_dp_source_refuses_wide_profile(lib, entry):
    """Past the largest MSA bucket (T > 4096) both entry points refuse the
    shape before any access."""
    one = np.ones(1, np.int32)
    rc = lib[entry](_p(np.zeros(1, np.uint8)), 1, *(_p(one),) * 7, 1, 4097,
                    0, 4, 2, 4, 24, 1, 24, _p(np.zeros(1, np.uint8)), None)
    assert rc == 1                            # cudaErrorInvalidValue


# (B, LQ, T, lanes a thread): one and several warps, a partial last warp,
# every L the wrapper may choose, lanes past T in the last thread, ten
# warps around a band of at most 12 lanes (most warps skip most rows),
# queries longer than a warp's lanes (whole warps inside the band);
# then the tie cases of test_torch_kernel_order (many-way ties at the max,
# found false, en0 == tlen - 1) under its TIE_SCORES
@pytest.mark.parametrize("B,LQ,T,L", [
    (6, 24, 40, 1), (4, 40, 100, 2), (3, 30, 72, 4), (3, 50, 300, 4),
    (2, 60, 700, 16), (5, 12, 300, 1), (3, 100, 100, 1),
    (2, 140, 150, 2), (8, 16, 24, 1), (8, 16, 24, 4)])
def test_wf_ext_source_matches_plain(lib, B, LQ, T, L):
    if T == 24:
        q, qlen, t, tlen = KO._ext_tie_cases(L, LQ, T)
        scores = KO.TIE_SCORES
    else:
        q, qlen, t, tlen = _pairs(np.random.default_rng(T * 10 + L), B, LQ,
                                  T)[:4]
        scores = TW.DEFAULT_SCORES
    out = np.full((4, B), 0x55, np.int32)
    rc = lib["wf_ext"](_p(q), LQ, _p(t), T, _p(qlen), _p(tlen), B, *scores,
                       L, _p(out), None)
    assert rc == 0
    want = TW.ext_batch(*map(torch.from_numpy, (q, qlen, t, tlen)), scores)
    np.testing.assert_array_equal(out, np.stack([w.numpy() for w in want]))


@pytest.mark.parametrize("L", [1, 2])
def test_wf_ext_source_best_at_warp_end(lib, L):
    """The best cell is the last live cell of a warp and the last row of
    its round (the query is the target segment ending at the warp's last
    lane, qlen = 1 mod S), so the warp records it in a round it skips."""
    whi = 32 * L - 1
    B, LQ, T = 2, 48, 300
    rng = np.random.default_rng(L)
    t = rng.integers(0, 4, (B, T)).astype(np.uint8)
    q = np.full((B, LQ), 4, np.uint8)
    qlen = np.array([25 if L == 1 else 41, 9], np.int32)
    tlen = np.array([T, T], np.int32)
    for b in range(B):
        q[b, :qlen[b]] = t[b, whi - qlen[b] + 1:whi + 1]
    out = np.full((4, B), 0x55, np.int32)
    rc = lib["wf_ext"](_p(q), LQ, _p(t), T, _p(qlen), _p(tlen), B,
                       *TW.DEFAULT_SCORES, L, _p(out), None)
    assert rc == 0
    want = TW.ext_batch(*map(torch.from_numpy, (q, qlen, t, tlen)))
    assert int(want[1][0]) == whi
    np.testing.assert_array_equal(out, np.stack([w.numpy() for w in want]))


def _plane(rng, T, W, B):
    """A random direction plane: every byte a valid direction (sel 0..2)
    with random continuation and track bits."""
    raw = rng.integers(0, 256, (2 * T - 1, B, W or T))
    return ((raw & 0xFC) | (raw % 3)).astype(np.uint8)


# (T, W, B): every band rung, full width at the smallest bucket and past
# one 128-lane window, a partial last CTA
@pytest.mark.parametrize("T,W,B", [
    (256, 128, 5), (320, 256, 3), (640, 512, 2), (128, None, 4),
    (336, None, 5)])
def test_profile_bt_source_matches_plain(lib, T, W, B):
    rng = np.random.default_rng(T + (W or 0))
    dirs = _plane(rng, T, W, B)
    qlen = np.array([T, 1, T, T // 2, 7][:B], np.int32)
    ncol = np.array([T, T, 1, T // 3, T - 5][:B], np.int32)
    want = TMD.profile_bt_plain(*map(torch.from_numpy, (dirs, qlen, ncol)),
                                T, W)
    NL = TMD.n_levels(T)
    ops = np.full((B, NL), 0x55, np.int8)
    nst = np.full(B, -7, np.int32)
    tch = np.full(B, -7, np.int32)
    rc = lib["profile_bt"](_p(dirs), B, T, W or 0, _p(qlen), _p(ncol), NL,
                           _p(ops), _p(nst), _p(tch), None)
    assert rc == 0
    np.testing.assert_array_equal(ops, want[0].numpy())
    np.testing.assert_array_equal(nst, want[1].numpy())
    np.testing.assert_array_equal(tch, want[2].numpy())


def _at(n, misalign):
    """n bytes whose address is 1 mod 16 (misalign) or 0 mod 16."""
    buf = np.zeros(n + 16, np.uint8)
    off = ((1 if misalign else 0) - buf.ctypes.data) % 16
    return buf[off:off + n]


# (T, W, NL change, dirs misaligned, ops misaligned): each breaks one rule
# of the 16-byte copies; the entry point must refuse it before any write
@pytest.mark.parametrize("T,W,dNL,mis_dirs,mis_ops", [
    (200, 128, 0, False, False), (256, 120, 0, False, False),
    (112, None, 0, False, False), (256, 128, -8, False, False),
    (256, 128, 0, True, False), (256, None, 0, False, True)],
    ids=["T", "W", "full_T", "NL", "dirs_ptr", "ops_ptr"])
def test_profile_bt_source_refuses_unaligned(lib, T, W, dNL, mis_dirs,
                                            mis_ops):
    B = 2
    dirs = _at((2 * T - 1) * B * (W or T), mis_dirs)
    dirs[:] = _plane(np.random.default_rng(T), T, W, B).ravel()
    qlen = np.array([T, T // 2], np.int32)
    ncol = np.array([T // 2, T], np.int32)
    NL = TMD.n_levels(T) + dNL
    ops = _at(B * NL, mis_ops)
    ops[:] = 0x55
    nst = np.full(B, -7, np.int32)
    tch = np.full(B, -7, np.int32)
    rc = lib["profile_bt"](_p(dirs), B, T, W or 0, _p(qlen), _p(ncol), NL,
                           _p(ops), _p(nst), _p(tch), None)
    assert rc == 1                            # cudaErrorInvalidValue
    assert (ops == 0x55).all() and (nst == -7).all() and (tch == -7).all()


def _myers_run(lib, seq, meta, W):
    B = meta.shape[1]
    out = np.zeros((3, B), np.int32)
    rc = lib["myers_hw"](_p(seq), _p(meta), B, W, _p(out), None)
    assert rc == 0
    return out


@pytest.mark.parametrize("case", list(TM.CASES))
def test_myers_hw_source_matches_plain(lib, case):
    """Every case of test_torch_myers (queries of 5-128 bp across the
    word boundaries, k caps, ties, the reference's adapters) at the
    launcher's W and, for queries of at most 64 bp, also at W = 2 (a
    launch whose longest query needs two words)."""
    seq, meta = TM._tensors(*TM.CASES[case]())
    want = MY.hw_batch_plain(seq, meta).numpy()
    seq_np, meta_np = seq.numpy(), meta.numpy()
    W = 1 if meta_np[1].max() <= 64 else 2
    for w in sorted({W, 2}):
        np.testing.assert_array_equal(_myers_run(lib, seq_np, meta_np, w),
                                      want)


def test_myers_hw_source_shared_targets_and_blocks(lib):
    """Problems that share one target and query in the byte buffer
    (packed by hw_batch's pack), over three blocks of threads."""
    rng = np.random.default_rng(5)
    qs = [TM.FIVE, TM.THREE, TM._rand_seq(rng, 33), TM._rand_seq(rng, 64)]
    targets = [TM._rand_seq(rng, int(rng.integers(100, 600)))
               for _ in range(80)]
    targets = [t[:50] + TM._mutseq(rng, qs[i % 4], 0.1) + t[50:]
               for i, t in enumerate(targets)]
    trips = [(qs[(i + j) % 4], t, [-1, 20, 3][j])
             for i, t in enumerate(targets) for j in range(3)]
    seq, meta, rows = MY.pack(*zip(*trips))
    assert len(rows) == len(trips)
    want = MY.hw_batch_plain(torch.from_numpy(seq), torch.from_numpy(meta))
    np.testing.assert_array_equal(_myers_run(lib, seq, meta, 2),
                                  want.numpy())


def test_myers_hw_source_refuses_bad_words(lib):
    seq, meta = TM._tensors(["ACGT"], ["AACGTT"], [-1])
    out = np.zeros((3, 1), np.int32)
    assert lib["myers_hw"](_p(seq.numpy()), _p(meta.numpy()), 1, 3,
                           _p(out), None) != 0


@pytest.mark.parametrize("W", [1, 2])
@pytest.mark.parametrize("P", [1, 2, 4, 8, 16, 32, 64, 128])
def test_myers_hw_source_lanes_match_plain(lib, monkeypatch, P, W):
    """Every case of test_torch_myers and of the kernel-order model's
    MYERS_CASES (segment-boundary ties, k = -1 / 0 / >= m, queries of 1-128
    bp, short and all-N targets, the best at the first and last column) in
    one launch at P lanes a problem, steered by the SM count the launcher
    reads: several problems a warp (P < 32), a warp, and a problem over 2
    and 4 warps (P = 64, 128); with P > 1 also the model's cases built to
    show the warm-up tight (an alignment of cost k over m + k columns ending
    on the first column of segment P // 2).  W = 2 takes every case, W = 1
    those whose query fits one word."""
    trips = [x for f in KO._myers_all_cases().values() for x in zip(*f())
             if W == 2 or len(x[0]) <= 64]
    for m, k, n in ((20, 3, 400), (64, 12, 600), (128, 25, 1200))[:W + 1]:
        if P > 1:
            trips.append((*KO._myers_tight_case(m, k, P, n), k))
    seq, meta, rows = MY.pack(*zip(*trips))
    assert len(rows) == len(trips)
    B = meta.shape[1]
    sms = -(-B * P // KO.MYERS_LANES_PER_SM)
    assert KO.myers_lanes(B, sms) == P
    monkeypatch.setenv("CUDA_SHIM_SMS", str(sms))
    assert lib["myers_hw_lanes"](B) == P
    want = MY.hw_batch_plain(torch.from_numpy(seq), torch.from_numpy(meta))
    np.testing.assert_array_equal(_myers_run(lib, seq, meta, W),
                                  want.numpy())


def _seed_reads(k, w, hpc, n, L):
    """Tandem and random reads of up to L bases (no N with w > 1, so the
    minimizer rows are served; one all-N and one poly-T read with w = 1),
    a 3 bp read and an empty one."""
    rng = np.random.default_rng(k * 31 + w + L)
    reads = _random_reads(rng, n, L, n_frac=0.0 if w > 1 else 0.02)
    reads[0] = np.tile(rng.integers(0, 4, 37), L)[:L].astype(np.uint8)
    reads += [np.full(90, 3, np.uint8), np.zeros(3, np.uint8),
              np.zeros(0, np.uint8)]
    if w == 1:
        reads.append(np.full(80, 4, np.uint8))
    return reads


def _seed_run(lib, batch, lens, k, w, hpc, min_p, max_p, threads,
              packed=False, scratch=False):
    """One launch through the C entry point, with the global scratch the
    entry point asks for (scratch: assert that it asks for one)."""
    B, L = batch.shape
    wide = not SD.packed_ok(k, L)
    ends = np.full((B, L), 0x55, np.int32)
    periods = None if packed else np.full((B, L), 0x55, np.int32)
    n = np.full(B, -7, np.int32)
    fb = np.full(B, 7, np.uint8)
    nbytes = lib["seed_hits_scratch_bytes"](B, L, int(hpc), w, int(wide))
    assert (nbytes > 0) == scratch
    scr = np.zeros(nbytes, np.uint8) if nbytes else None
    rc = lib["seed_hits"](_p(batch), _p(lens), B, L, k, w, int(hpc), min_p,
                          max_p, int(wide), SD.pos_bits(L), int(packed),
                          threads, _p(scr), _p(ends), _p(periods), _p(n),
                          _p(fb), None)
    assert rc == 0
    return ends, periods, n, fb.astype(bool)


def _seed_cap(lib, monkeypatch, P, k, w, hpc, L):
    """Sets CUDA_SHIM_SMEM to the shared-memory cap at which one CTA holds
    the arrays of P lanes of an L-wide launch, and no more (16-lane
    steps): a CTA's head (the least cap at which a 16-base read fits,
    less that read's row) and P lanes' row."""
    lo, hi = 0, 1 << 20
    while lo < hi:
        mid = (lo + hi) // 2
        monkeypatch.setenv("CUDA_SHIM_SMEM", str(mid))
        if lib["seed_hits_scratch_bytes"](1, 16, 0, 1, 0) == 0:
            hi = mid
        else:
            lo = mid + 1
    head = lo - lib["seed_hits_row_bytes"](16, 0, 1, 0)
    wide = int(not SD.packed_ok(k, L))
    monkeypatch.setenv("CUDA_SHIM_SMEM", str(
        head + lib["seed_hits_row_bytes"](P, int(hpc), w, wide)))


# (k, w, hpc, min_p, max_p, threads, global scratch): 32-bit seed words
# at 128 and 256 threads, -H, w = 5 (with -H too), min_p near 0, k = 16
# (64-bit words: the poly-T key equals the 32-bit sentinel), and both
# word widths on the global-scratch route (a shared-memory cap too small
# for a cluster of 8 to hold the row)
@pytest.mark.parametrize("k,w,hpc,min_p,max_p,threads,scratch", [
    (8, 1, False, 30, 10000, 128, False), (8, 1, False, 30, 10000, 256,
                                           False),
    (8, 1, True, 30, 10000, 256, False), (8, 5, False, 30, 10000, 128,
                                          False),
    (8, 5, True, 30, 10000, 256, False), (5, 1, False, 2, 50, 128, False),
    (16, 1, False, 30, 10000, 256, False), (16, 3, False, 5, 10000, 128,
                                            False),
    (8, 1, True, 30, 10000, 128, True), (16, 1, False, 30, 10000, 128,
                                         True)],
    ids=["k8_t128", "k8_t256", "hpc", "w5", "w5_hpc", "k5_minp2", "k16",
         "k16_w3_minp5", "global_hpc", "global_k16"])
def test_seed_hits_source_matches_plain(lib, monkeypatch, k, w, hpc, min_p,
                                        max_p, threads, scratch):
    """Every output of every row (fallback rows too) equals seed_plain's,
    at L = 1024, and the non-fallback rows equal the host oracle."""
    if scratch:
        _seed_cap(lib, monkeypatch, 64, k, w, hpc, 1024)
    reads = _seed_reads(k, w, hpc, 6, 1024)
    batch, lens = SD.pad_batch(reads, 1024)
    got = _seed_run(lib, batch, lens, k, w, hpc, min_p, max_p, threads,
                    scratch=scratch)
    want = SD.seed_plain(torch.from_numpy(batch), torch.from_numpy(lens),
                         k=k, use_hpc=hpc, min_p=min_p, max_p=max_p, w=w)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x.numpy())
    ends, periods, n, fb = got
    assert (~fb).sum() >= 4
    for i, r in enumerate(reads):
        if not fb[i]:
            we, wp = collect_tandem_repeat_hits(r, k, w, hpc, min_p, max_p)
            np.testing.assert_array_equal(ends[i, :n[i]], we)
            np.testing.assert_array_equal(periods[i, :n[i]], wp)


def test_seed_hits_source_packed_and_routes(lib, monkeypatch):
    """The packed output equals collect_hits_packed's plain result; the
    scratch sizes follow the layout (shared memory, one CTA's or a
    cluster's, up to sm_90's cap)."""
    monkeypatch.delenv("CUDA_SHIM_SMEM", raising=False)
    reads = _seed_reads(8, 1, False, 5, 700)
    batch, lens = SD.pad_batch(reads, 700)
    ph, _, n, fb = _seed_run(lib, batch, lens, 8, 1, False, 30, 10000, 128,
                             packed=True)
    want = SD.collect_hits_packed(torch.from_numpy(batch),
                                  torch.from_numpy(lens), k=8,
                                  use_hpc=False, min_p=30, max_p=10000)
    np.testing.assert_array_equal(ph, want[0].numpy())
    np.testing.assert_array_equal(n, want[1].numpy())
    # two radix buffers of 32-bit words, keys, stream and valid bytes, for
    # the lanes rounded up to 16; positions with hpc, window minima with
    # w > 1, 64-bit words when wide
    assert lib["seed_hits_row_bytes"](700, 0, 1, 0) == 704 * 14
    assert lib["seed_hits_row_bytes"](700, 1, 5, 1) == 704 * 30
    assert lib["seed_hits_scratch_bytes"](3, 4400, 0, 1, 0) == 0
    # 20 kb with hpc, w > 1 and 64-bit words: a cluster holds it; 70 kb
    # passes a cluster of 8 (59392 bases at 30 bytes a lane)
    assert lib["seed_hits_scratch_bytes"](3, 20000, 1, 5, 1) == 0
    big = lib["seed_hits_row_bytes"](70000, 1, 5, 1)
    assert lib["seed_hits_scratch_bytes"](3, 70000, 1, 5, 1) == 3 * big
    # the route query: one CTA, a cluster, the global scratch
    assert lib["seed_hits_route"](4400, 0, 1, 0) == 1
    assert 2 <= lib["seed_hits_route"](20000, 1, 5, 1) <= 8
    assert lib["seed_hits_route"](70000, 1, 5, 1) == 0
    # a packed launch of 64-bit words is refused before any write
    out = np.full((1, 16), 0x55, np.int32)
    assert lib["seed_hits"](_p(batch[:1, :16].copy()), _p(lens[:1]), 1, 16,
                            16, 1, 0, 30, 100, 1, 4, 1, 128, None, _p(out),
                            None, _p(n), _p(fb.astype(np.uint8)),
                            None) == 1
    assert (out == 0x55).all()


# each route's rows, by row length at a shared-memory cap that holds
# SEED_P lanes a CTA: one CTA, a cluster of 2 and of 8, and past that the
# global scratch
SEED_P = 128
SEED_ROUTES = {"cta": 120, "cluster2": 250, "cluster8": 1000, "global": 1100}
SEED_CLUSTER = {"cta": 1, "cluster2": 2, "cluster8": 8, "global": 1}


def _seed_route_reads(rng, L):
    """A tandem read and random reads (one with Ns) of about L bases, a
    poly-A and a poly-T row of L (their keys all collide; with hpc one
    stream lane each), a 3 bp read and an empty one."""
    unit = rng.integers(0, 4, 41)
    tandem = np.tile(unit, L // 41 + 1)[:L]
    tandem = np.where(rng.random(L) < 0.02, rng.integers(0, 4, L), tandem)
    noisy = rng.integers(0, 4, L - 5)
    with_n = np.where(rng.random(L - 9) < 0.03, 4,
                      rng.integers(0, 4, L - 9))
    return [r.astype(np.uint8) for r in (
        tandem, noisy, with_n, np.zeros(L), np.full(L - 3, 3),
        np.zeros(3), np.zeros(0))]


@pytest.mark.parametrize("route", list(SEED_ROUTES))
@pytest.mark.parametrize("k,w,hpc", [
    (8, 1, False), (8, 1, True), (8, 5, False), (8, 5, True),
    (16, 1, False), (16, 1, True), (16, 5, False), (16, 5, True)])
def test_seed_hits_source_routes_match_plain(lib, monkeypatch, route, k, w,
                                             hpc):
    """Every output of every row equals seed_plain's (packed too where the
    words pack), at min_p 0, 1 and 3, on the route the row length steers
    to under a cap of SEED_P lanes a CTA; 64 threads a CTA (8 x 64 on a
    cluster of 8)."""
    L = SEED_ROUTES[route]
    _seed_cap(lib, monkeypatch, SEED_P, k, w, hpc, L)
    reads = _seed_route_reads(np.random.default_rng(k + w + L), L)
    batch, lens = SD.pad_batch(reads, L)
    tb, tl = torch.from_numpy(batch), torch.from_numpy(lens)
    for min_p in (0, 1, 3):
        got = _seed_run(lib, batch, lens, k, w, hpc, min_p, 10000, 64,
                        scratch=route == "global")
        assert lib["shim_last_cluster"]() == SEED_CLUSTER[route]
        assert lib["seed_hits_route"](
            L, int(hpc), w, int(not SD.packed_ok(k, L))) == (
                0 if route == "global" else SEED_CLUSTER[route])
        want = SD.seed_plain(tb, tl, k=k, use_hpc=hpc, min_p=min_p,
                             max_p=10000, w=w)
        for g, x in zip(got, want):
            np.testing.assert_array_equal(g, x.numpy())
        assert got[2][0] > 0         # the tandem read has hits
        if SD.packed_ok(k, L):
            ph = _seed_run(lib, batch, lens, k, w, hpc, min_p, 10000, 64,
                           packed=True, scratch=route == "global")[0]
            np.testing.assert_array_equal(
                ph, SD.pack_hits(*want[:3], SD.pos_bits(L)).numpy())


def _chain_batch(seed, rows):
    """The fuzz corpus' hits, after a row of no hits; then a non-singleton
    end group (gated) and a one-hit row."""
    rng = np.random.default_rng(seed)
    hits = [(np.zeros(0, np.int64), np.zeros(0, np.int64))]
    hits += [collect_tandem_repeat_hits(_random_read(rng), 8, 1, False, 30,
                                        10000) for _ in range(rows)]
    hits.append((np.array([100, 200, 200, 300]), np.array([50, 50, 60, 50])))
    hits.append((np.array([500]), np.array([40])))
    L = max(len(e) for e, _ in hits)
    ends = np.full((len(hits), L), 2**31 - 1, np.int32)
    periods = ends.copy()
    n = np.zeros(len(hits), np.int32)
    for i, (e, p) in enumerate(hits):
        ends[i, :len(e)], periods[i, :len(p)], n[i] = e, p, len(e)
    return ends, periods, n


def _chain_check(lib, window, seed):
    ends, periods, n = _chain_batch(seed, 14)
    B, L = ends.shape
    W = window or L
    score = np.full((B, L), 0x55, np.int32)
    frm = np.full((B, L), 0x55, np.int32)
    fb = np.full(B, 7, np.uint8)
    rc = lib["chain_dp"](_p(ends), _p(periods), _p(n), B, L, 8, W,
                         _p(score), _p(frm), _p(fb), None)
    assert rc == 0
    want = CD.chain_dp_plain(*map(torch.from_numpy, (ends, periods, n)),
                             k=8, window=W)
    np.testing.assert_array_equal(score, want[0].numpy())
    np.testing.assert_array_equal(frm, want[1].numpy())
    np.testing.assert_array_equal(fb.astype(bool), want[2].numpy())
    assert fb[-2] and not fb[-1]
    if window is None:
        assert fb.sum() == 1
    else:               # some rows incomplete, some exact
        assert 0 < fb[:-2].sum() < B - 2


# (window, seed): the fuzz corpus at full window (never incomplete), at
# 512 and at 64 (incomplete cells flag their rows); rows of no hits and of
# one, and a non-singleton end group (gated), in every batch; a warp a CTA
# (the launch fills 132 SMs), its planes in shared memory
@pytest.mark.parametrize("window,seed", [(None, 7), (512, 7), (64, 11)])
def test_chain_dp_source_matches_plain(lib, window, seed):
    _chain_check(lib, window, seed)


# the other routes of the same batches: four warps (reads) a CTA sharing
# its shared memory, and a partial last CTA (the launcher sees 4 SMs);
# planes too wide for shared memory, scanned in global memory; at full
# window (4 chunks a step), 64 (2) and 24 (1)
@pytest.mark.parametrize("route", ["smem_4warps", "global"])
@pytest.mark.parametrize("window,seed", [(None, 7), (64, 11), (24, 11)])
def test_chain_dp_source_routes_match_plain(lib, monkeypatch, route, window,
                                            seed):
    if route == "global":
        monkeypatch.setenv("CUDA_SHIM_SMEM", "1024")
    else:
        monkeypatch.setenv("CUDA_SHIM_SMS", "4")
    _chain_check(lib, window, seed)


# A cluster of 2 whose CTAs publish a word in shared memory, sync, and read
# each other's: with a last cluster barrier every read sees the word; without
# it the shim runs rank 0 to its exit before rank 1 starts, and rank 1 reads
# the exited CTA's poisoned shared memory (what the card forbids), every time.
SHIM_EXIT_SRC = r'''
#include "cuda_shim.h"
__global__ void swap_kernel(int* out, int last_sync) {
  extern __shared__ int s[];
  const int rank = blockIdx.x;
  if (threadIdx.x == 0) s[0] = 100 + rank;
  cooperative_groups::this_cluster().sync();
  const int* other =
      cooperative_groups::this_cluster().map_shared_rank(s, rank ^ 1);
  if (threadIdx.x == 0) out[rank] = other[0];
  if (last_sync) cooperative_groups::this_cluster().sync();
}
extern "C" int swap(int* out, int last_sync) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2);
  cfg.blockDim = dim3(64);
  cfg.dynamicSmemBytes = 16;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, swap_kernel, out, last_sync);
}
'''


# csrc/bulk_copy.cuh's protocol on three chunks: thread 0 announces and
# copies them (the last after a pause, so that the other threads wait on
# it), every thread waits for each chunk and copies it out; `mode` breaks
# one rule: more bytes announced than copied (a wait that never ends), a
# copy of 8 bytes, a wait on a barrier never initialised
SHIM_BULK_SRC = r'''
#include <cuda_runtime.h>
#include <stdint.h>
#include "bulk_copy.cuh"
__global__ void bulk_kernel(const int* src, int* out, int mode) {
  extern __shared__ int4 bulk_s[];
  int* buf = reinterpret_cast<int*>(bulk_s);
  uint64_t* bars = reinterpret_cast<uint64_t*>(buf + 96);
  if (threadIdx.x == 0) {
    for (int c = 0; c < 3; ++c)
      if (mode != 3 || c < 2) mbar_init(bars + c, 1);
    mbar_fence_init();
    for (int c = 0; c < 3; ++c) {
      if (c == 2) std::this_thread::sleep_for(std::chrono::milliseconds(50));
      if (mode == 3 && c == 2) break;
      const unsigned n = mode == 2 && c == 1 ? 8 : 128;
      mbar_arrive_expect_tx(bars + c, mode == 1 && c == 1 ? 256 : n);
      bulk_g2s(buf + 32 * c, src + 32 * c, n, bars + c);
    }
  }
  __syncthreads();
  for (int c = 0; c < 3; ++c) {
    mbar_wait(bars + c, 0);
    out[96 * threadIdx.x + 32 * c + threadIdx.x % 32] =
        buf[32 * c + threadIdx.x % 32];
  }
}
extern "C" int bulk(const int* src, int* out, int mode) {
  bulk_kernel<<<1, 64, 96 * 4 + 3 * 8, nullptr>>>(src, out, mode);
  return cudaGetLastError();
}
'''


def _shim_lib(tmp_path, name, src):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler on this host")
    shutil.copy(Path(__file__).with_name("cuda_shim.h"), tmp_path)
    cpp = tmp_path / f"{name}.cpp"
    cpp.write_text(_translate(src))
    so = tmp_path / f"lib{name}.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
                    "-I", str(tmp_path), "-o", str(so), str(cpp)],
                   check=True)
    return so


def test_shim_bulk_copy_lands_before_waits_return(tmp_path):
    fn = ctypes.CDLL(str(_shim_lib(tmp_path, "bulk", SHIM_BULK_SRC))).bulk
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    src = np.arange(96, dtype=np.int32) * 7 + 3
    out = np.zeros(64 * 96, np.int32)
    assert fn(src.ctypes.data, out.ctypes.data, 0) == 0
    for t in range(64):
        for c in range(3):
            assert out[96 * t + 32 * c + t % 32] == src[32 * c + t % 32]


@pytest.mark.parametrize("mode,msg", [
    (1, "the phase never completes"), (2, "16-byte whole"),
    (3, "before mbar_init")], ids=["bytes_short", "eight_bytes",
                                   "uninitialised"])
def test_shim_bulk_copy_refuses_what_the_card_would(tmp_path, mode, msg):
    """Each broken rule aborts the process (the card would fault or
    hang), so it runs in a child process."""
    so = _shim_lib(tmp_path, "bulk", SHIM_BULK_SRC)
    code = ("import ctypes, numpy as np\n"
            f"fn = ctypes.CDLL({str(so)!r}).bulk\n"
            "fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]\n"
            "src = np.arange(96, dtype=np.int32)\n"
            "out = np.zeros(64 * 96, np.int32)\n"
            f"fn(src.ctypes.data, out.ctypes.data, {mode})\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "CUDA_SHIM_WAIT_S": "1"})
    assert res.returncode != 0
    assert msg in res.stderr


@pytest.mark.parametrize("last_sync", [True, False])
def test_shim_poisons_an_exited_cluster_cta(tmp_path, last_sync):
    fn = ctypes.CDLL(str(_shim_lib(tmp_path, "swap", SHIM_EXIT_SRC))).swap
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    out = np.zeros(2, np.int32)
    for _ in range(20):
        assert fn(out.ctypes.data, int(last_sync)) == 0
        want = [101, 100] if last_sync else [101, 0x5A5A5A5A]
        assert out.tolist() == want


@pytest.mark.parametrize("name", list(DM.VARIANTS))
def test_dtype_micro_source_matches_plain(lib, name):
    """Every variant of the rate tool's step, the tool's own inputs at
    (4, 96) (a last block of 128 threads), CHAIN steps: exact."""
    x, y, a = (t.contiguous() for t in DM.tensors(
        name, DM.inputs(4, 96)[name], "cpu"))
    xo, yo = torch.empty_like(x), torch.empty_like(y)
    rc = lib["dtype_micro"](x.data_ptr(), y.data_ptr(), a.data_ptr(),
                            xo.data_ptr(), yo.data_ptr(), x.numel(),
                            DM.CHAIN, list(DM.VARIANTS).index(name), None)
    assert rc == 0
    wx, wy = DM.step_plain(name, x, y, a)
    assert torch.equal(xo, wx) and torch.equal(yo, wy)
