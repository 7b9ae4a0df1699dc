"""The port's CUDA sources for the redesigned kernels, run on the CPU.

csrc/wavefront.cu (``wf_global``, ``wf_ext``), csrc/profile_dp.cu
(``profile_dp``: its warp kernel and its strips, one CTA or a cluster a
region; ``profile_dp_first``, the first version), csrc/profile_bt.cu
(``profile_bt``) and csrc/myers_hw.cu (``myers_hw``) are compiled with the host's C++ compiler over
tests/cuda_shim.h, which emulates the CUDA subset they use (threads, warp
shuffles, barriers, shared memory, cp.async copies, thread-block clusters
and their distributed shared memory, the DPX intrinsics), and called
through the same C entry points and argument lists that _kernels.py
binds.  Every output must equal the port's plain version exactly.  This
runs the kernels' own index arithmetic, shuffles, tiles and epilogues
here; the card's compiler, timing and memory model are only checked on
the card (chip_smoke.py).
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import test_torch_kernel_order as KO
import test_torch_myers as TM
import torch

from tidehunter_tpu_torch import _kernels as K
from tidehunter_tpu_torch.ops import msa_device as TMD
from tidehunter_tpu_torch.ops import myers_device as MY
from tidehunter_tpu_torch.ops import wavefront as TW

torch.set_num_threads(1)

SOURCES = ("wavefront.cu", "profile_dp.cu", "profile_bt.cu", "myers_hw.cu")


def _translate(src: str) -> str:
    """CUDA C++ -> C++ over cuda_shim.h: the includes, dynamic shared
    memory and the <<<...>>> launches."""
    src = src.replace("#include <cuda_runtime.h>", '#include "cuda_shim.h"')
    src = src.replace("#include <cuda_pipeline.h>", "")
    src = src.replace("#include <cooperative_groups.h>", "")
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
    for k in (K.WF_GLOBAL, K.WF_EXT, K.PROFILE_DP, K.PROFILE_DP_FIRST,
              K.PROFILE_BT, K.MYERS_HW):
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


def _dp_check(lib, entry, T, W, B, lens, seed, *extra):
    """The entry point's plane equals profile_dp_plain's on every row a
    region writes (dead lanes 0), and rows past qlen + ncol - 1 stay
    untouched."""
    (unit, qlen, ncol, sub, wl, wdel, wl2, wdel2), costs, targs = _dp_round(
        np.random.default_rng(seed), T, B, lens)
    want = TMD.profile_dp_plain(*targs, costs, W).numpy()
    dirs = np.full((2 * T - 1, B, W or T), 0x77, np.uint8)
    rc = lib[entry](_p(unit), T, _p(sub), _p(wl), _p(wdel), _p(wl2),
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
