"""Batched device engine of the PyTorch port (counterpart of
``tidehunter_tpu/engine.py``).

  chunk of reads
    -> encode + seed + chain (native C, on -t threads)          [host]
       (TH_DEVICE_SEED=1: seed on the card, TH_DEVICE_CHAIN=1:
       chain there too)                                         [device]
    -> partition walks (native C; oversize windows batched)     [host/dev]
    -> consensus: profile-POA MSA + aveMatch + boundary ext     [device]

The per-read stages are the port's copies of the JAX package's generators
(``pipeline/consensus.seqs_msa_gen``, ``ops/partition``), driven
breadth-first by the ``_drive`` helpers below; each drive round is resolved
here with one batched call per request kind, serially.  Request kinds:
``global``, ``giden``, ``gidens``, ``ext``, ``exts``, ``gx``, ``hws``
(Myers adapter searches, ``ops/myers_device``) and ``msa``.

On ``cuda`` every device call launches the hand-written kernels; on
``cpu`` the same calls run their plain PyTorch versions.  Seeding and
chaining stay on the host by default, as in the JAX engine on one device;
the environment selects the device routes of ``Engine._device_seed``
(``TH_DEVICE_SEED``, ``TH_DEVICE_CHAIN``, ``TH_OFFLOAD_V1``).  With a mesh
(``Engine(mesh=)``; ``make_engine`` builds one from ``TH_MESH`` or the
visible cards) every device call splits its rows over the mesh's devices,
device seeding becomes the default (and on the v1 route device chaining),
and the partition walks run on the device as breadth-first ``global``
rounds (``TH_HOST_WALK=1`` keeps them on the host).  Adapters run
their searches as ``hws`` rounds, and with ``-s -F`` a fourth stage drives
the single-copy reads; ``polish`` adds the device MSA's frozen-layout
rounds; ``msa_mode="poa"`` (the CLI's ``--msa graph``) resolves every
``msa`` request with the host oracle ``resolve_oracle``, as the JAX
engine does, and keeps every other kind on the device.
"""

from __future__ import annotations

import contextlib
import functools
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ._kernels import require_cuda
from .io.codec import encode
from .io.output import TandemResult
from .ops import ksw2, ksw2_native, offload, wavefront
from .ops.chaining_device import chain_dp_batch
from .ops.chaining_native import tandem_chain_from_dp, tandem_chain_native
from .ops.msa_device import DeviceMSA
from .ops.myers_device import hw_batch
from .ops.partition import (
    combine_walks,
    partition_walk_left,
    partition_walk_right,
)
from .ops.poa_profile import profile_consensus
from .ops.seeding_device import collect_hits_batch, pad_batch
from .ops.seeding_native import collect_tandem_repeat_hits
from .parallel import mesh as PM
from .params import Params
from .pipeline.consensus import (
    resolve_oracle,
    seqs_msa_gen,
    single_copy_full_len_gen,
)
from .utils.log import log
from .utils.metrics import METRICS

KSW2_SCORES = (ksw2.MATCH_SC, ksw2.MIS_SC, ksw2.GAP_OPEN, ksw2.GAP_EXT)
MSA_MODES = ("profile", "poa")
# the v1 seeding route's largest row chained on the device, in hits
V1_OVERSIZE_HITS = 8192


def v1_chain_window(cnt: np.ndarray, fb: np.ndarray, L: int):
    """(H, max_hits, Lh, oversize) of a v1 chunk from its pulled hit counts
    and seed flags: the most hits of a served row (the pulled width), the
    most of a row of at most V1_OVERSIZE_HITS (the chained width), the
    chain_dp window (512 doubled up to max_hits, at most the padded width
    L) and the rows past the limit, which the host chains."""
    cnt_ok = np.where(fb, 0, cnt)
    oversize = cnt_ok > V1_OVERSIZE_HITS
    H = int(cnt_ok.max()) if len(cnt) else 0
    max_hits = int(np.where(oversize, 0, cnt_ok).max()) if len(cnt) else 0
    Lh = 512
    while Lh < max_hits:
        Lh *= 2
    return H, max_hits, min(Lh, L), oversize


def v1_assemble(encoded, mtp: Params, cnt, fb, ends, periods, dp=None):
    """(hits_list, chains_list) of a v1 chunk from its pulled planes: a
    seed-flagged row is seeded on the host; with dp = (score, from_idx,
    chain flags), every other row of 2 hits or more is chained from the DP
    and a chain-flagged row is left None for the host chainer."""
    ends, periods = ends.astype(np.int64), periods.astype(np.int64)
    hits_list: List = []
    chains_list: List = [None] * len(encoded)
    for i, bs in enumerate(encoded):
        if fb[i]:
            METRICS.add("offload_seed_fb")
            hits_list.append(collect_tandem_repeat_hits(
                bs, mtp.k, mtp.w, mtp.hpc, mtp.min_p, mtp.max_p))
            continue
        c = int(cnt[i])
        e, p = ends[i, :c], periods[i, :c]
        hits_list.append((e, p))
        if dp is None:
            continue
        score, from_idx, fb_c = dp
        if c < 2:
            chains_list[i] = (None, [])
        elif fb_c[i]:
            METRICS.add("offload_chain_fb")     # the host chainer
        else:
            chains_list[i] = tandem_chain_from_dp(
                e, p, score[i, :c].astype(np.int64),
                from_idx[i, :c].astype(np.int64), mtp.k)
    return hits_list, chains_list


# --- breadth-first generator driving (tidehunter_tpu/engine.py) ---

def _drive(gens: List, resolver) -> None:
    """Breadth-first generator driving: collect one request per active
    generator, resolve them as one batch, resume."""
    pending: Dict[int, object] = {}
    for gi, gen in enumerate(gens):
        try:
            pending[gi] = gen.send(None)
        except StopIteration:
            pass
    while pending:
        keys = list(pending.keys())
        reqs = [pending[kk] for kk in keys]
        answers = resolver(reqs)
        pending = {}
        for kk, ans in zip(keys, answers):
            try:
                pending[kk] = gens[kk].send(ans)
            except StopIteration:
                pass


class _BufferResult:
    """Captures add_cons/add_unit calls for ordered replay (stage 3)."""

    def __init__(self) -> None:
        self.calls: List[Tuple] = []

    def add_cons(self, rec, mtp) -> None:
        self.calls.append(("cons", rec, mtp))

    def add_unit(self, sub_pos) -> None:
        self.calls.append(("unit", sub_pos, None))


def _chain_consensus_gen(seq_len, bseq, par_pos, result, mtp):
    yield from seqs_msa_gen(seq_len, bseq, par_pos, result, mtp)


def _resume_walk(gen, first_req):
    """Adapter for a generator already advanced to its first request:
    re-yields that request, then delegates (used when a synchronously
    resolved walk hits an oversize alignment and defers to the batched
    device drive)."""
    res = yield first_req
    while True:
        try:
            req = gen.send(res)
        except StopIteration as stop:
            return stop.value
        res = yield req


def _drive_collect(gens, resolver, holder: Dict[int, object]) -> None:
    pending: Dict[int, object] = {}
    for gi, gen in enumerate(gens):
        try:
            pending[gi] = gen.send(None)
        except StopIteration as stop:
            holder[gi] = stop.value
    while pending:
        keys = list(pending.keys())
        answers = resolver([pending[kk] for kk in keys])
        pending = {}
        for kk, ans in zip(keys, answers):
            try:
                pending[kk] = gens[kk].send(ans)
            except StopIteration as stop:
                holder[kk] = stop.value


class BatchAligner:
    """Buckets alignment requests by (query, target) length and runs each
    bucket as one wavefront launch of exactly its requests, split over
    `mesh` when one is given."""

    def __init__(self, buckets: Sequence[int], device: torch.device,
                 mesh=None):
        self.buckets = sorted(buckets)
        self.device = device
        self.mesh = mesh
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
                    q, qlen, t, tlen, qle, scores, iden_only=not need_tleft,
                    mesh=self.mesh)
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
                                                       scores, mesh=self.mesh)
                for i, a, b in zip(idxs, mq.tolist(), mt.tolist()):
                    out[i] = (a, b)
        return out


class Engine:
    """Callable as ``process_chunk(chunk, mtp)``; also exposes
    ``prepare_chunk`` / ``finish_chunk`` for the pipelined runner (host
    work of chunk N+1 overlaps device work of chunk N)."""

    def __init__(self, mtp: Params, device: str = "cuda",
                 msa_mode: str = "profile", mesh=None):
        """msa_mode: "profile" (the device profile-POA) or "poa" (every
        msa request to the host oracle, the JAX engine's mode names).

        mesh: a parallel.mesh.Mesh of `device`'s type, or None.  The
        engine hands it to its aligner, its device MSA and its device
        seeding: every one of their calls splits its rows over the mesh's
        devices (two engines on different meshes may live side by side),
        and, as in
        the JAX engine, three routes flip: device seeding becomes the
        default, the v1 seeding route chains on the device unless
        TH_DEVICE_CHAIN=0, and the partition walks run as breadth-first
        global rounds (_use_native_walks).  The adapter searches stay on
        the mesh's first device."""
        if msa_mode not in MSA_MODES:
            raise ValueError(f"msa_mode must be one of {MSA_MODES}, got "
                             f"{msa_mode!r}")
        if device == "cuda":
            require_cuda()
        elif device != "cpu":
            raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
        if mesh is not None:
            mesh = PM.Mesh(mesh)
            if mesh.type != device:
                raise ValueError(f"a {device} engine needs a mesh of {device} "
                                 f"devices, got {mesh}")
        if not ksw2_native.available():
            raise RuntimeError(
                "the native host library (tidehunter_tpu_torch/native) did not load")
        self.mtp = mtp
        self.msa_mode = msa_mode
        self.mesh = mesh
        if mesh is not None:
            self.device = mesh[0]
        elif device == "cuda":
            self.device = torch.device("cuda", torch.cuda.current_device())
        else:
            self.device = torch.device("cpu")
        self.aligner = BatchAligner(mtp.aln_bucket_sizes, self.device, mesh)
        self.msa = DeviceMSA(
            mtp.match, mtp.mismatch, mtp.gap_open1, mtp.gap_ext1,
            polish=mtp.polish, gap_open2=mtp.gap_open2,
            gap_ext2=mtp.gap_ext2, device=self.device, mesh=mesh)
        self._pool = None           # prepare_chunk's -t threads
        self._pool_n = 0
        # device seeding's own stream on each device: prepare_chunk runs
        # on the runner's prefetch thread while finish_chunk launches on
        # the current ones
        self._seed_streams = (
            {d: torch.cuda.Stream(d) for d in (mesh or (self.device,))}
            if device == "cuda" else None)

    # --- request resolution ---

    def _resolve_batch(self, reqs):
        by_kind: Dict[str, List[int]] = {}
        for i, req in enumerate(reqs):
            by_kind.setdefault(req[0], []).append(i)
        unknown = set(by_kind) - {"global", "giden", "gidens", "ext", "exts",
                                  "gx", "hws", "msa"}
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
        if "hws" in by_kind:
            # every request's adapter searches in one hw_batch call
            idxs = by_kind["hws"]
            trips, spans = flat(idxs, 1)
            with METRICS.timed("dev_hws"):
                res = hw_batch([q for q, _, _ in trips],
                               [t for _, t, _ in trips],
                               [k for _, _, k in trips], self.device)
            for i, (lo, n) in zip(idxs, spans):
                out[i] = res[lo:lo + n]
        if "msa" in by_kind:
            idxs = by_kind["msa"]
            regions = [reqs[i][1] for i in idxs]
            if self.msa_mode == "poa":
                res = [resolve_oracle(("msa", units), self.mtp)
                       for units in regions]
            else:
                res = self._resolve_msa_device(regions)
            for i, r in zip(idxs, res):
                out[i] = r
        return out

    def _resolve_walks(self, reqs):
        """One breadth-first round of partition walk steps (`global`
        requests with t_left), counted as walk_rounds."""
        METRICS.add("walk_rounds")
        return self.aligner.run_global(reqs)

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
                    m.gap_ext1, polish=m.polish, gap_open2=m.gap_open2,
                    gap_ext2=m.gap_ext2)
        return results

    # --- chunk processing ---

    def prepare_chunk(self, chunk, mtp: Params):
        """Stage 1: seed and chain every read, then the partition walks
        (native C; a walk that meets an oversize window defers to the
        batched drive of finish_chunk).

        Reads are seeded and chained on a pool of min(-t, cores) threads
        (the native seeder and chainer release the GIL), reused across
        chunks.  Under a mesh, or with TH_DEVICE_SEED=1, the chunk is
        seeded on the device first (_device_seed); the pool then chains
        the device's hits on the host, unless the device chained them too.
        Under a mesh the walks are left to finish_chunk (walked = None),
        as in the JAX engine."""
        device_hits = device_chains = None
        if (self.mesh is not None
                or os.environ.get("TH_DEVICE_SEED", "") == "1"):
            with METRICS.timed("device_seed"):
                device_hits, device_chains = self._device_seed(chunk, mtp)
        bseqs: List = [None] * len(chunk)
        read_chains: List = [None] * len(chunk)

        def seed_chain(ri: int) -> None:
            rec = chunk[ri]
            if len(rec.seq) < mtp.k:
                read_chains[ri] = (None, [])
                return
            bseqs[ri] = encode(rec.seq)
            if device_chains is not None and device_chains[ri] is not None:
                read_chains[ri] = device_chains[ri]
                return
            if device_hits is not None:
                ends, periods = device_hits[ri]
            else:
                ends, periods = collect_tandem_repeat_hits(
                    bseqs[ri], mtp.k, mtp.w, mtp.hpc, mtp.min_p, mtp.max_p)
            read_chains[ri] = tandem_chain_native(ends, periods, mtp.k)

        with METRICS.timed("seed_chain"):
            n_workers = max(1, min(int(mtp.n_thread or 1),
                                   os.cpu_count() or 1))
            if n_workers > 1 and len(chunk) > 1:
                if self._pool is None or self._pool_n != n_workers:
                    if self._pool is not None:
                        self._pool.shutdown(wait=False)
                    self._pool = ThreadPoolExecutor(max_workers=n_workers)
                    self._pool_n = n_workers
                list(self._pool.map(seed_chain, range(len(chunk))))
            else:
                for ri in range(len(chunk)):
                    seed_chain(ri)
        walked = None
        if self._use_native_walks():
            walked = self._partition_chunk(chunk, bseqs, read_chains, mtp,
                                           native=True)
        return chunk, bseqs, read_chains, walked

    def _device_seed(self, chunk, mtp: Params):
        """One device seeding call for the chunk: (hits_list,
        chains_list) as ops/offload.device_seed_chain returns them.

        The packed-word route (offload.device_seed_chain) whenever
        offload.supported(k, longest read) holds and TH_OFFLOAD_V1 is not
        1; TH_DEVICE_CHAIN=1 chains there too.  Otherwise the v1 route:
        collect_hits_batch (64-bit seed words where the packed ones do not
        fit: k up to 16, long reads), then, with TH_DEVICE_CHAIN=1 or
        under a mesh unless TH_DEVICE_CHAIN=0, chain_dp at window = the
        hit bucket (512 and up by powers of two) over the rows of at most
        V1_OVERSIZE_HITS hits (v1_chain_window); a larger row, like every
        row the seeder flags, is chained on the host (v1_assemble).  Every
        launch splits its rows over the mesh, each device on its own
        seeding stream."""
        maxL = max((len(r.seq) for r in chunk), default=1)
        chain_env = os.environ.get("TH_DEVICE_CHAIN", "")
        mesh = self.mesh or PM.Mesh([self.device])
        streams = self._seed_streams
        stream = streams[self.device] if streams else None
        if (os.environ.get("TH_OFFLOAD_V1", "") != "1"
                and offload.supported(mtp.k, maxL)):
            bseqs = [encode(rec.seq) if len(rec.seq) >= mtp.k else None
                     for rec in chunk]
            return offload.device_seed_chain(
                bseqs, mtp, chain_mode="device" if chain_env == "1"
                else "host", mesh=mesh, streams=streams)

        dev_chain = chain_env == "1" or (chain_env != "0"
                                         and self.mesh is not None)
        encoded = [encode(rec.seq) for rec in chunk]
        batch, lens = pad_batch(encoded)
        ends_d, periods_d, cnt_d, fb_d = PM.shard_rows(
            functools.partial(collect_hits_batch, k=mtp.k,
                              use_hpc=bool(mtp.hpc), min_p=mtp.min_p,
                              max_p=mtp.max_p, w=mtp.w),
            mesh, torch.as_tensor(batch), torch.as_tensor(lens),
            streams=streams)
        cnt, fb = PM.pull_async([cnt_d, fb_d], stream)()
        H, max_hits, Lh, oversize = v1_chain_window(cnt, fb,
                                                    ends_d.shape[1])
        planes = [ends_d[:, :H], periods_d[:, :H]]
        chain = dev_chain and max_hits >= 2
        with (METRICS.timed("device_chain") if chain
              else contextlib.nullcontext()):
            if chain:
                with PM.on_device(self.device, stream):
                    rows = (ends_d[:, :Lh].contiguous(),
                            periods_d[:, :Lh].contiguous(),
                            cnt_d.clamp(max=Lh))
                score_d, from_d, fbc_d = PM.shard_rows(
                    functools.partial(chain_dp_batch, k=mtp.k, window=Lh),
                    mesh, *rows, streams=streams)
                planes += [score_d[:, :max_hits], from_d[:, :max_hits],
                           fbc_d]
            planes = PM.pull_async(planes, stream)()
        dp = (planes[2], planes[3], planes[4] | oversize) if chain else None
        return v1_assemble(encoded, mtp, cnt, fb, planes[0], planes[1], dp)

    def _use_native_walks(self) -> bool:
        """Walk on the host (native C, in prepare_chunk) without a mesh;
        under a mesh every walk step becomes a `global` request of the
        breadth-first drive in finish_chunk, amortised over the whole
        chunk on the device, as in the JAX engine (TH_HOST_WALK=1/0
        overrides either way)."""
        env = os.environ.get("TH_HOST_WALK", "")
        return env == "1" or (env != "0" and self.mesh is None)

    def _partition_chunk(self, chunk, bseqs, read_chains, mtp: Params,
                         native: bool):
        """(halves, walkers, walker_meta, chain_objs).  native: each walk
        runs on the host (a right-only walk wholly in C, the others step by
        step with native alignments) until a window past host_aln_cap,
        where its generator is left in `walkers` for the batched drive;
        otherwise every walk half is a generator in `walkers`."""
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
                    if native and ch.est_ch_i == 0:
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
                        if not native:
                            walkers.append(gen)
                            walker_meta.append(key)
                            continue
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
        if walked is None:
            # the device walks: every step a global request (t_left) of
            # one breadth-first round over the chunk
            walked = self._partition_chunk(chunk, bseqs, read_chains, mtp,
                                           native=False)
        halves, walkers, walker_meta, chain_objs = walked
        with METRICS.timed("partition"):
            holder: Dict[int, List[int]] = {}
            if walkers:
                _drive_collect(walkers, self._resolve_walks, holder)
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
        # stage 4: single-copy full-length reads, their adapter searches
        # in two hws rounds (tidehunter_tpu/engine.py:1066-1078)
        if (mtp.single_copy and mtp.only_full_length
                and mtp.five_seq is not None and mtp.three_seq is not None):
            with METRICS.timed("single_copy"):
                _drive([single_copy_full_len_gen(rec.seq, results[ri], mtp)
                        for ri, rec in enumerate(chunk)],
                       self._resolve_batch)
        return results

    def process_chunk(self, chunk, mtp: Params) -> List[TandemResult]:
        return self.finish_chunk(self.prepare_chunk(chunk, mtp), mtp)

    __call__ = process_chunk

    def close(self) -> None:
        """Shut down prepare_chunk's thread pool."""
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
            self._pool_n = 0


def make_engine(mtp: Params, device: str = "cuda", mesh=None,
                msa_mode: str = "profile") -> Engine:
    """The engine, on a mesh when one is given or asked for (the JAX
    package's make_engine contract).

    mesh None: n = TH_MESH when set and not 0, else the visible CUDA
    devices (cuda) or 1 (cpu); a mesh of |n| devices (parallel.mesh.
    make_mesh) is built when n > 1 or n < 0, so TH_MESH=1 keeps one device
    without a mesh and TH_MESH=-n forces a mesh of n devices, n = 1
    included.  Asking for more CUDA devices than are visible raises."""
    if mesh is None:
        n = int(os.environ.get("TH_MESH", "0") or 0)
        if n == 0:
            n = torch.cuda.device_count() if device == "cuda" else 1
        if n > 1 or n < 0:
            mesh = PM.make_mesh(abs(n), device)
    engine = Engine(mtp, device, msa_mode=msa_mode, mesh=mesh)
    log(f"engine ready (device={device}"
        + (f", mesh=dp:{len(engine.mesh)}" if engine.mesh else "") + ")")
    return engine
