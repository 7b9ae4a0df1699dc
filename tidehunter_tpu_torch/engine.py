"""Batched device engine of the PyTorch port (counterpart of
``tidehunter_tpu/engine.py``).

  chunk of reads
    -> encode + seed + chain (native C)                         [host]
    -> partition walks (native C; oversize windows batched)     [host/dev]
    -> consensus: profile-POA MSA + aveMatch + boundary ext     [device]

The per-read stages are the JAX package's own generators
(``pipeline/consensus.seqs_msa_gen``, ``ops/partition``), driven
breadth-first by its ``_drive`` helpers; each drive round is resolved here
with one batched call per request kind, serially.  Request kinds:
``global``, ``giden``, ``gidens``, ``ext``, ``exts``, ``gx`` and ``msa``.

On ``cuda`` every device call launches the hand-written kernels; on
``cpu`` the same calls run their plain PyTorch versions.  Adapters
(``hws``), ``--polish`` and ``--msa graph`` are not part of this port yet:
the engine refuses them at construction.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tidehunter_tpu.engine import (
    _BufferResult,
    _chain_consensus_gen,
    _drive,
    _drive_collect,
    _resume_walk,
)
from tidehunter_tpu.io.codec import encode
from tidehunter_tpu.io.output import TandemResult
from tidehunter_tpu.ops import ksw2, ksw2_native
from tidehunter_tpu.ops.chaining_native import tandem_chain_native
from tidehunter_tpu.ops.partition import (
    combine_walks,
    partition_walk_left,
    partition_walk_right,
)
from tidehunter_tpu.ops.poa_profile import profile_consensus
from tidehunter_tpu.ops.seeding_native import collect_tandem_repeat_hits
from tidehunter_tpu.params import Params
from tidehunter_tpu.utils.metrics import METRICS

from ._kernels import require_cuda
from .ops import wavefront
from .ops.msa_device import DeviceMSA

KSW2_SCORES = (ksw2.MATCH_SC, ksw2.MIS_SC, ksw2.GAP_OPEN, ksw2.GAP_EXT)


class BatchAligner:
    """Buckets alignment requests by (query, target) length and runs each
    bucket as one wavefront launch of exactly its requests."""

    def __init__(self, buckets: Sequence[int], device: torch.device):
        self.buckets = sorted(buckets)
        self.device = device
        # requests at or below this size on both sides resolve on the
        # host in native C; the native pack keeps tleft below 2^20
        self.host_aln_cap = min(
            int(os.environ.get("TH_HOST_ALN_CAP", "192")), (1 << 20) - 2)

    def _bucket(self, n: int) -> Optional[int]:
        for b in self.buckets:
            if n <= b:
                return b
        return None

    def _grouped(self, reqs, idxs):
        """{(LQ, LT): [i]} over rectangular buckets, and the requests past
        the largest bucket on either side."""
        groups: Dict[Tuple[int, int], List[int]] = {}
        host: List[int] = []
        for i in idxs:
            bq = self._bucket(max(1, len(reqs[i][0])))
            bt = self._bucket(max(1, len(reqs[i][1])))
            if bq is None or bt is None:
                host.append(i)
            else:
                groups.setdefault((bq, bt), []).append(i)
        return groups, host

    def _pad(self, reqs, idxs, LQ, LT):
        B = len(idxs)
        q = np.full((B, LQ), 4, np.uint8)
        t = np.full((B, LT), 4, np.uint8)
        qlen = np.ones(B, np.int32)
        tlen = np.ones(B, np.int32)
        for row, i in enumerate(idxs):
            qs, ts = reqs[i][0], reqs[i][1]
            q[row, :len(qs)] = qs
            t[row, :len(ts)] = ts
            qlen[row] = max(1, len(qs))
            tlen[row] = max(1, len(ts))
        METRICS.add("device_items", B)
        METRICS.add("kernel_calls")
        METRICS.add("wf_cells", float(np.dot(qlen.astype(np.float64),
                                              tlen.astype(np.float64))))
        METRICS.add("wf_cells_disp", float(B) * LQ * LT)
        dev = self.device
        return tuple(torch.as_tensor(a, device=dev)
                     for a in (q, qlen, t, tlen))

    def run_global(self, reqs, scores=KSW2_SCORES, need_tleft=True):
        """reqs: [(q, t, qle)] -> [(iden_n, t_left_ext)].  Requests of at
        most host_aln_cap a side, and those past the largest bucket, run
        in native C; the rest take one wavefront launch per bucket."""
        out: List = [None] * len(reqs)
        rest = list(range(len(reqs)))
        if scores == KSW2_SCORES:
            cap = self.host_aln_cap
            small = [i for i in rest if max(len(reqs[i][0]),
                                           len(reqs[i][1])) <= cap]
            if small:
                METRICS.add("host_aln", len(small))
                with METRICS.timed("host_aln"):
                    res = ksw2_native.global_tleft_batch(
                        [reqs[i] for i in small])
                for i, r in zip(small, res):
                    out[i] = r
                rest = [i for i in rest if out[i] is None]
        groups, host = self._grouped(reqs, rest)
        if host:
            for i, r in zip(host, ksw2_native.global_tleft_batch(
                    [reqs[i] for i in host])):
                out[i] = r
        with METRICS.timed("dev_global"):
            for (LQ, LT), idxs in groups.items():
                q, qlen, t, tlen = self._pad(reqs, idxs, LQ, LT)
                qle = torch.as_tensor(
                    np.array([max(0, reqs[i][2]) for i in idxs], np.int32),
                    device=self.device)
                iden, tleft = wavefront.global_batch(
                    q, qlen, t, tlen, qle, scores, iden_only=not need_tleft)
                for i, a, b in zip(idxs, iden.tolist(), tleft.tolist()):
                    out[i] = (a, b)
        return out

    def run_giden(self, reqs, scores=KSW2_SCORES):
        """reqs: [(q, t)] -> [iden_n]"""
        res = self.run_global([(q, t, 0) for q, t in reqs], scores,
                              need_tleft=False)
        return [r[0] for r in res]

    def run_ext(self, reqs, scores=KSW2_SCORES):
        """reqs: [(q, t)] -> [(max_q, max_t)] (reverse beforehand for a
        left extension).  Targets are clamped to 2 * len(q): no cell past
        it can score above 0, the only scores the max tracking selects."""
        reqs = [
            (q, t[: 2 * max(1, len(q))]) if len(t) > 2 * len(q) else (q, t)
            for q, t in reqs
        ]
        out: List = [None] * len(reqs)
        groups, host = self._grouped(reqs, range(len(reqs)))
        for i in host:
            r = ksw2.extz(reqs[i][0], reqs[i][1], score_only=True)
            out[i] = (r.max_q, r.max_t)
        with METRICS.timed("dev_ext"):
            for (LQ, LT), idxs in groups.items():
                q, qlen, t, tlen = self._pad(reqs, idxs, LQ, LT)
                _mx, mt, mq, _sc = wavefront.ext_batch(q, qlen, t, tlen,
                                                       scores)
                for i, a, b in zip(idxs, mq.tolist(), mt.tolist()):
                    out[i] = (a, b)
        return out


class Engine:
    """Callable as ``process_chunk(chunk, mtp)``; also exposes
    ``prepare_chunk`` / ``finish_chunk`` for the pipelined runner (host
    work of chunk N+1 overlaps device work of chunk N)."""

    def __init__(self, mtp: Params, device: str = "cuda",
                 msa_mode: str = "profile"):
        missing = []
        if msa_mode != "profile":
            missing.append(f"--msa {msa_mode}")
        if getattr(mtp, "polish", 0):
            missing.append("--polish")
        if any(getattr(mtp, f) is not None for f in
               ("five_fn", "three_fn", "five_seq", "three_seq")):
            missing.append("adapters (-5/-3, -F, -s)")
        if missing:
            raise NotImplementedError(
                "not supported by the PyTorch port yet: " + ", ".join(missing))
        if device == "cuda":
            require_cuda()
        elif device != "cpu":
            raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
        if not ksw2_native.available():
            raise RuntimeError(
                "the native host library (tidehunter_tpu/native) did not load")
        self.mtp = mtp
        self.device = torch.device(device)
        self.aligner = BatchAligner(mtp.aln_bucket_sizes, self.device)
        self.msa = DeviceMSA(
            mtp.match, mtp.mismatch, mtp.gap_open1, mtp.gap_ext1,
            gap_open2=mtp.gap_open2, gap_ext2=mtp.gap_ext2,
            device=self.device)

    # --- request resolution ---

    def _resolve_batch(self, reqs):
        by_kind: Dict[str, List[int]] = {}
        for i, req in enumerate(reqs):
            by_kind.setdefault(req[0], []).append(i)
        unknown = set(by_kind) - {"global", "giden", "gidens", "ext", "exts",
                                  "gx", "msa"}
        if unknown:
            raise NotImplementedError(f"request kinds {sorted(unknown)}")
        METRICS.add("rounds")
        out: List = [None] * len(reqs)
        al = self.aligner

        def flat(idxs, field):
            pairs, spans = [], []
            for i in idxs:
                spans.append((len(pairs), len(reqs[i][field])))
                pairs.extend(reqs[i][field])
            return pairs, spans

        if "global" in by_kind:
            idxs = by_kind["global"]
            for i, r in zip(idxs, al.run_global([reqs[i][1:]
                                                 for i in idxs])):
                out[i] = r
        if "giden" in by_kind:
            idxs = by_kind["giden"]
            for i, r in zip(idxs, al.run_giden([reqs[i][1:3]
                                                for i in idxs])):
                out[i] = r
        if "ext" in by_kind:
            idxs = by_kind["ext"]
            for i, r in zip(idxs, al.run_ext([reqs[i][1:3] for i in idxs])):
                out[i] = r
        if "gidens" in by_kind:
            idxs = by_kind["gidens"]
            pairs, spans = flat(idxs, 1)
            res = al.run_giden(pairs)
            for i, (lo, n) in zip(idxs, spans):
                out[i] = res[lo:lo + n]
        if "exts" in by_kind:
            idxs = by_kind["exts"]
            pairs, spans = flat(idxs, 1)
            res = al.run_ext(pairs)
            for i, (lo, n) in zip(idxs, spans):
                out[i] = res[lo:lo + n]
        if "gx" in by_kind:
            # fused aveMatch identities + boundary extensions
            idxs = by_kind["gx"]
            gpairs, gspans = flat(idxs, 1)
            epairs, espans = flat(idxs, 2)
            gres = al.run_giden(gpairs)
            eres = al.run_ext(epairs)
            for i, (glo, gn), (elo, en) in zip(idxs, gspans, espans):
                out[i] = (gres[glo:glo + gn], eres[elo:elo + en])
        if "msa" in by_kind:
            idxs = by_kind["msa"]
            for i, r in zip(idxs, self._resolve_msa_device(
                    [reqs[i][1] for i in idxs])):
                out[i] = r
        return out

    def _resolve_msa_device(self, regions: List[List[np.ndarray]]):
        """Device profile-POA; a region past the largest bucket comes back
        None and takes the host profile_consensus, as the JAX engine's
        rule (engine.py:643-652) — counted as msa_host_oversize."""
        with METRICS.timed("dev_msa"):
            results = self.msa.consensus_batch(regions)
        m = self.mtp
        for ri, r in enumerate(results):
            if r is None:
                METRICS.add("msa_host_oversize")
                results[ri] = profile_consensus(
                    regions[ri], m.match, m.mismatch, m.gap_open1,
                    m.gap_ext1, gap_open2=m.gap_open2, gap_ext2=m.gap_ext2)
        return results

    # --- chunk processing ---

    def prepare_chunk(self, chunk, mtp: Params):
        """Stage 1 on the host: encode, seed and chain (native C), then the
        partition walks (native C; a walk that meets an oversize window
        defers to the batched drive of finish_chunk)."""
        bseqs: List = [None] * len(chunk)
        read_chains: List = [None] * len(chunk)
        with METRICS.timed("seed_chain"):
            for ri, rec in enumerate(chunk):
                if len(rec.seq) < mtp.k:
                    read_chains[ri] = (None, [])
                    continue
                bseqs[ri] = encode(rec.seq)
                ends, periods = collect_tandem_repeat_hits(
                    bseqs[ri], mtp.k, mtp.w, mtp.hpc, mtp.min_p, mtp.max_p)
                read_chains[ri] = tandem_chain_native(ends, periods, mtp.k)
        walked = self._partition_chunk(chunk, bseqs, read_chains, mtp)
        return chunk, bseqs, read_chains, walked

    def _partition_chunk(self, chunk, bseqs, read_chains, mtp: Params):
        cap = self.aligner.host_aln_cap
        walkers, walker_meta = [], []
        halves: Dict[Tuple[int, int, int], List[int]] = {}
        chain_objs: Dict[Tuple[int, int], object] = {}
        with METRICS.timed("partition"):
            for ri, rec in enumerate(chunk):
                dp, chains = read_chains[ri]
                for ci, ch in enumerate(chains):
                    chain_objs[(ri, ci)] = ch
                    cells = np.asarray(ch.cells)
                    starts_a = dp.start[cells]
                    ends_a = dp.end[cells]
                    if ch.est_ch_i == 0:
                        # the left half is empty when est_ch_i == 0
                        # (partition.py:59): the whole walk runs in C
                        pos = ksw2_native.walk_right_native(
                            bseqs[ri], starts_a, ends_a, ch.est_start,
                            ch.est_period, mtp.k, mtp.max_div, cap)
                        if pos is not None:
                            halves[(ri, ci, 0)] = []
                            halves[(ri, ci, 1)] = pos
                            METRICS.add("walk_native")
                            continue
                    coords = (starts_a.tolist(), ends_a.tolist())
                    for side, walk in ((0, partition_walk_left),
                                       (1, partition_walk_right)):
                        key = (ri, ci, side)
                        gen = walk(bseqs[ri], len(rec.seq), dp, ch, mtp.k,
                                   mtp.max_div, coords)
                        n_aln = 0
                        try:
                            req = gen.send(None)
                            while True:
                                q_, t_, qle_ = req
                                if max(len(q_), len(t_)) > cap:
                                    walkers.append(_resume_walk(gen, req))
                                    walker_meta.append(key)
                                    break
                                n_aln += 1
                                req = gen.send(ksw2_native.global_tleft_one(
                                    q_, t_, qle_))
                        except StopIteration as stop:
                            halves[key] = stop.value
                            METRICS.add("host_aln", n_aln)
        return halves, walkers, walker_meta, chain_objs

    def finish_chunk(self, prepared, mtp: Params) -> List[TandemResult]:
        chunk, bseqs, read_chains, walked = prepared
        results = [TandemResult() for _ in chunk]
        halves, walkers, walker_meta, chain_objs = walked
        with METRICS.timed("partition"):
            holder: Dict[int, List[int]] = {}
            if walkers:
                _drive_collect(walkers, self.aligner.run_global, holder)
            for wi, key in enumerate(walker_meta):
                halves[key] = holder.get(wi)
        # one consensus generator per (read, chain), all driven together;
        # each writes its own buffer, replayed in chain order afterwards so
        # record order and the admission filters see the reference order
        consensus_gens = []
        buffers: Dict[int, List[_BufferResult]] = {}
        for ri, rec in enumerate(chunk):
            _, chains = read_chains[ri]
            buffers[ri] = []
            for ci in range(len(chains)):
                par_pos = combine_walks(halves[(ri, ci, 0)],
                                        halves[(ri, ci, 1)],
                                        chain_objs[(ri, ci)])
                if par_pos is None or len(par_pos) < mtp.min_copy + 1:
                    continue
                buf = _BufferResult()
                buffers[ri].append(buf)
                consensus_gens.append(_chain_consensus_gen(
                    len(rec.seq), bseqs[ri], par_pos, buf, mtp))
        with METRICS.timed("consensus"):
            _drive(consensus_gens, self._resolve_batch)
        for ri in range(len(chunk)):
            for buf in buffers[ri]:
                for kind, a, b in buf.calls:
                    if kind == "cons":
                        results[ri].add_cons(a, b)
                    else:
                        results[ri].add_unit(a)
        return results

    def process_chunk(self, chunk, mtp: Params) -> List[TandemResult]:
        return self.finish_chunk(self.prepare_chunk(chunk, mtp), mtp)

    __call__ = process_chunk

    def close(self) -> None:
        """Nothing to release: the engine holds no threads or files."""
