"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py
    # two commits' kernels on one card, in turns (A, B, B, A)
    python3 chip_smoke.py --kernels wf_ext,profile_bt --port OTHER_CHECKOUT
    python3 chip_smoke.py --kernels seed_hits,chain_dp
    python3 chip_smoke.py --kernels wf_dtype_probe,dtype_micro [--port DIR]

Phases, each printing its result on its own line:
  1. card and build: the card's name and power limit (nvidia-smi), the
     port's native host library built with cc from
     tidehunter_tpu_torch/native/, then every kernel of csrc/ built with
     nvcc for sm_90a (one nvcc per source, all started together);
  2. every kernel of the consensus path against its plain PyTorch version
     on the card, exact integer equality, at the shapes the default path
     gives it, with both times (CUDA events, the kernel's runs queued
     behind a device sleep); wf_ext also at each lanes-a-thread choice;
     wf_global at every shape beside the kernel of its other route
     (global_route: the warp kernel, or the CTA kernel wf_global_cta);
     profile_dp at every shape also against its first version, and on
     every band rung against the strips (profile_dp_on), each equal and
     timed in the same run; one region (B=1) at T=4096 W=256 on the
     first version and the band kernel, in us a row; K1 at the periods
     path's two largest launches ((1536,1536) B=1285, (3072,3072) B=388)
     and profile_dp at T=2048 on the periods path's largest launches (B =
     256, 251 and 256 on W = 128, 256 and 512) are held to their plain
     versions on their first 8 problems;
     in a --kernels run naming wf_global, both routes of wf_global at
     ROUTE_SWEEP's launch sizes, each equal to the other;
     myers_hw (the adapter search) against hw_batch_plain at the adapter
     path's shapes (4096 searches of the 84 and 25 bp adapters in ~1.1 kb
     doubled consensus), the single-copy path's (2048 searches of 32, 64,
     65 and 128 bp queries in ~5 kb reads) and few long targets (64
     searches of the same queries in ~12 kb reads), each with the lanes a
     problem its launch took, its bound counting ceil(qlen / 64) words a
     search over every target column and min(end + 1, m + ed) SHW
     columns;
  3. the wavefront dtype probe: wf_dtype_probe against probe_plain, exact,
     in all four variants in chains of 8 calls at (T=512, BT=128),
     (T=200, BT=7) and the ragged (T=201, BT=3) and (T=203, BT=5), then
     the probe's own timing table at its defaults, each variant bound at
     35 ops a 32-bit word (a packed int16 word holds 2 cells, an int8 word
     4);
  4. the default consensus path end to end: 1024 synthetic R2C2 reads
     (evals/bench.slice_reads: synth_read, seed 42) through
     pipeline.runner with the port's engine on cuda, chunks of 512, one
     warm run then a timed run; every kernel of the path must have
     launched in the timed run, the records of 32 of those reads plus 12
     fuzz-style reads must be byte-identical with the port's host oracle
     (pipeline.core.tidehunter_core), and every read's records of the
     timed run must match its committed oracle digest
     (evals/bench_digests.json, all 1024; the input FASTA its sha256);
     then the timed run once more under torch.profiler: each kernel's
     device ms and launches on the slice and the device busy share; then the host floor (evals/host_floor.py's
     engine with an instant device) and the slice, FLOOR_TURNS runs of
     each in turns on the same reads and chunks: the floor's share of the
     slice's wall a turn;
  5. short and long periods end to end: 512 reads of a 60 bp unit x 60,
     256 of 1500 bp x 6 and 128 of 3000 bp x 4 (evals/bench.
     period_populations: synth_read, seed 43)
     through the same runner and engine, one warm run then a timed run;
     full-width rounds (K3) and the 4096 bucket's W=256 must have
     launched, the latter on profile_dp's route there (the band kernel),
     every profile_dp launch on dp_route's kernel (the band kernel on
     every band rung) and wf_global_cta at least once (the periods path's
     two largest K1 launches), the launches by route of both entry points
     printed; the
     timed run's records of the first 8 reads of each population
     byte-identical with tidehunter_core (run over a pool of host
     processes), and every read's (all 896) matching its committed oracle
     digest; the timed run once more under torch.profiler;
  6. options: the 11 option runs of evals/bench.OPTION_RUNS, each
     through the port's CLI on the card with its own input file and
     argv: 1024 R2C2 reads with adapters (each unit the 84 bp 5' adapter,
     a 450 bp insert and the reverse complement of the 25 bp 3' adapter;
     9 copies at 10% error, a quarter of the reads a single copy) with
     -5/-3 -f 2, -F and -s -F; the slice with --polish 1 and --msa graph;
     the slice with -u -f 2; its first 512 reads with -M 3 -X 5 -O
     6,30 -E 3,1 and -H -k 16 -w 5; the first 512 adapter reads with -a 0.99 -f 2;
     the periods path's every second read (448) as gzipped FASTQ with -f
     3 -l and with -f 4 -c 3 -e 0.2 -p 50 -P 2000 -m 100 -r 0.5: each
     run's reads/s and stage timers (--metrics), its launches by kernel
     and by profile_dp route (OPTION_NEED: what it must launch and must
     not) and hws_host, the problems of each myers_hw launch, and every
     read's records held to the committed oracle digests
     (evals/option_digests.json, 8576 reads, by the bench's gate: the
     input's sha256, the records split by the run's -f and -u, no stray
     record, no read missing); the --msa graph run writes a --profile
     trace, which must parse and hold the card's kernels; then the
     -5/-3 -f 2 run once more, untimed, under torch.profiler (myers_hw's
     device ms and the run's device busy share); then myers_hw against
     hw_batch_plain on the inputs of the -5/-3 -f 2 run's largest launch
     (its main path: the numbers the summary line keeps);
  7. the full-width rung: regions that skip or escalate past the band
     window must equal the host mirror banded_profile_consensus;
  8. device seeding and chaining (TH_DEVICE_SEED, TH_DEVICE_CHAIN):
     seed_hits against its plain version, exact, at the slice's launch (the
     first 512-read chunk, k=8 w=1, packed hits), the periods path's 12.3
     kb reads, -H, w=5, k=16 (64-bit seed words), ~10.6 kb reads with -H
     and w=5 (clusters of 2), 40 kb reads (clusters of 4) and ~70 kb reads
     with -H, w=5 and 64-bit words (the global-scratch route), timed
     beside torch.sort over the same seed words; chain_dp against its
     plain version at the slice chunk's launch (its packed hits decoded
     into [512, L] planes, window = L) and at window 64; then the slice's 1024 reads through the runner with
     TH_DEVICE_SEED=1, with TH_DEVICE_CHAIN=1 too, and with TH_OFFLOAD_V1=1
     as well (the v1 route; a warm and a timed run each: reads/s,
     device_seed, seed_chain, partition, the offload_*_fb reroutes and
     both kernels' launches), every record byte-identical with phase 4's
     timed run (itself held read by read to the oracle's digests), and
     one run of the periods path with both switches byte-identical with
     phase 5's (likewise held);
  9. the mesh and --dist (parallel/mesh.py): the slice through
     engine.make_engine with TH_MESH=-1 (a mesh of the one card: device
     seeding by default, the partition walks as breadth-first global
     rounds), once more with TH_HOST_ALN_CAP=0 (every walk step on K1),
     with TH_OFFLOAD_V1=1 (the v1 route chains on the device under a
     mesh) and on an explicit Mesh([cuda:0, cuda:0]) (every split into two
     blocks); a warm and a timed run each: reads/s, rounds, walk rounds,
     launches and K1's walk launch shapes (the largest must be the one
     phase 2 checks, WALK_CASES), every record byte-identical with phase
     4's timed run (itself held read by read to the oracle's digests);
     then two CLI processes with --dist 127.0.0.1:PORT/2/I -f 2 on the
     card, their shards merged by tools.merge byte-identical
     with one process's -f 2 run.  Phase 2 holds K1 at the walk shapes
     ((128,128) B=507 and (256,256) B=1, t_left) to its plain version;
 10. the corpora (tidehunter_tpu_torch/evals/fuzz.py, soak.py,
     accuracy.py), every record held to the oracle.  The host oracle of
     (a) and (b) runs over a pool of host processes while (c) and (a) run
     on the card.  (c) the reference paper's accuracy protocol: its 14
     configs at 8 reads each (2-30 kb reads, 2-20 copies, error
     0.13-0.20) through accuracy.evaluate on make_engine, as the eval runs
     them (one card: no mesh), every read's records hashed to its
     committed oracle digest (evals/accuracy_digests.json), the table line
     and reads/s of each config, and the launches of each route: profile_dp
     by kernel (warp, strips, band) and (T, W), failing unless the 4096
     bucket's W=256 launched on its route, K3's full-width
     launches, wf_global's largest (LQ, LT); then the same under
     TH_DEVICE_SEED=1 TH_DEVICE_CHAIN=1 with seed_hits' routes (one CTA, a
     cluster of C, the global scratch).  (a) the 9 cases of
     tests/test_fuzz.py (5 x 12 random reads, 4 x 14 adapter and control
     reads, their adapter files in the phase's directory) through
     Engine(...).process_chunk, a fresh engine a case, byte-identical with
     the oracle; then on fresh engines under TH_HOST_ALN_CAP=0 and built by
     make_engine under TH_MESH=-1, each byte-identical with the first run.
     (b) the soak's seeds 1000-1029 at 12 reads a seed (360 reads; engines
     cached by (w, hpc, polish) as the soak caches them): the seeds that
     drew each switch, and the divergences and crashes, both 0.  Each of
     these runs resets the launch counts before it and fails if a kernel
     of its path did not launch.  No cut was needed.
 11. the measurement tools (tidehunter_tpu_torch/evals/: host_floor,
     seed_chain_micro, offload_micro2, offload_micro, msa_micro,
     tunnel_micro, dtype_micro, testfq_stages, mesh_scaling), each run by
     its main on the card and its table printed, a tool's own check (the
     staged seed and chain against the routes, 0 chain mismatches with the
     host, one MSA round against its steps, every mesh size's records
     against one device's) failing the run: the host floor at 1024 reads
     (its stage split; its share of the slice is phase 4's), both seeding
     routes' stage splits
     and the route against the host at 512 reads, the DeviceMSA step split
     at 512 regions, the copy costs and the element-type rates at their
     defaults, the periods path's 896 reads written as FASTQ with a
     constant quality at 2 reps (a cut from the tool's 3) and mesh sizes
     1, 2, 4 and 8 on the one card.  Before the tools, dtype_micro's
     kernel against its plain version, exactly, at each element type and
     the SWAR variant, at the tool's shape and at a ragged (7, 1001), each
     bound at 5 ops a 32-bit word (an int16 word holds 2 elements, an
     int8 word 4, a bfloat16x2 word 2) at its pipe's issue rate (the
     kernel line's dtype_micro row: its int32 case; its launches: the
     tool's own run);
 12. the bench (tidehunter_tpu_torch/evals/bench.py) by its main on the
     card, BENCH_PHASE_REPS timed runs of the slice, the periods path and
     the ada_f2 option cell after a warm run each, every read's records
     of all three (2944 reads) held to the committed digests and every
     rep to the first: its stderr lines printed under [bench] (the host's
     CPU model, load and probe among them), then its JSON object on a
     line of its own.
The line before the last is a JSON object with every kernel's launches,
error, times and bound (the larger of its integer ops over the card's int32
rate and its bytes over 3.35 TB/s; a profile DP's ops count the cells the
data needs, its bytes every lane of the rows written; seed_hits' and
chain_dp's the op counts in their sources' headers of the function's own
work: each read's live stream lanes and a comparison sort of them, and
each cell's scanned predecessors; wf_global's also holds its walk row;
profile_dp_band, profile_dp's route on the 4096 bucket's band rungs, has
its own row: its launches are the periods path's on that route);
the whole run's time is printed before them, and the last line is the
run's device record.  Any failure raises and exits non-zero without those two lines.
Without a CUDA card it exits 2.  JAX, the JAX package, bench and
__graft_entry__ are blocked from import: the port must not need them.
"""

from __future__ import annotations

import sys

for _name in ("jax", "jaxlib", "tidehunter_tpu", "bench", "__graft_entry__"):
    sys.modules[_name] = None    # any import of these now fails loudly

import argparse  # noqa: E402
import ctypes  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

T0 = time.perf_counter()

TOL = 0   # every kernel output is an integer, compared exactly
# Shapes the default path gives each kernel (synthetic R2C2 workload):
# aveMatch at (512, 512) (a slice launch carries ~4100 problems), oversize
# partition windows with t_left, boundary extensions at (512, 256) and
# (512, 640) (a slice launch carries 1-11 problems; B=1024 for the issue
# rate), MSA regions at T=640 on every band rung and full width, and at
# B=1 and 8 on the slice's rung; then the largest buckets, which
# long-period reads reach: wavefront rows past a 512 target and the 4096
# MSA bucket banded and at full width.
# wf_global's routes by target bucket T and launch (ops/wavefront.
# global_route): one column tile of 32 x 4 (T <= 128), 32 x 8 (T <= 256)
# or 32 x 16 (T <= 512) columns on the warp kernel; wider targets in tiles
# of 512, on the CTA kernel for few problems ((6144,6144) and (8192,8192)
# B=8 in clusters, (256,1024) B=512, the periods path's (1536,1536) and
# (3072,3072)), else the warp kernel with the edge column in shared
# memory or in a global scratch.  wf_ext's lanes a thread by target
# bucket and launch size (ops/wavefront.EXT_LANES): 1 at B <= the SM
# count and 2 above it up to T=1024, 4 at 4096, 16 at 8192.
# profile_dp's: the band kernel on the W=128/256/512 rungs of every bucket
# (T=640 at the slice's B=512, 8 and 1; the 4096 bucket at the protocol's
# B=8, the periods path's B=121 (W=256) and B=125 (W=128), and B=64; the
# 2048 bucket at B=8 and the periods path's largest); the strips at full
# width (a warp a region at T=128 with the short-period path's ~700
# regions a launch; 2 columns a lane over one CTA at T=256 and over
# clusters from T=640).
# profile_bt has one kernel for every rung: whole band rows or 128-lane
# windows a tile.
WF_CASES = [("iden_only", 2048, 512, 512), ("iden_only", 4096, 512, 512),
            ("iden_only", 256, 128, 128), ("tleft", 256, 256, 200),
            ("tleft", 512, 256, 1024),
            ("ext", 1, 512, 640), ("ext", 4, 512, 640), ("ext", 11, 512, 640),
            ("ext", 1024, 512, 640), ("ext", 1, 512, 256),
            ("ext", 4, 512, 256), ("ext", 11, 512, 256),
            ("ext", 1024, 512, 256),
            ("iden_only", 8, 6144, 6144), ("tleft", 8, 8192, 8192),
            ("ext", 8, 512, 4096), ("ext", 8, 4096, 8192),
            ("tleft", 507, 128, 128), ("tleft", 1, 256, 256),
            ("iden_only", 1285, 1536, 1536), ("iden_only", 388, 3072, 3072),
            ("iden_only", 150, 1024, 1024), ("iden_only", 72, 2048, 2048),
            ("iden_only", 69, 3072, 3072)]
# the periods path's two largest K1 launches (phase 5: 17.263 of K1's 21.5
# ms on its trace) and the accuracy protocol's largest past one tile
# (phase 10 (c): B up to 150, 72 and 69), held to the plain version on
# their first PLAIN_FIRST problems only (the plain K1 takes ~13.5 s at
# (6144,6144) B=8)
PLAIN_FIRST = 8
FIRST_ONLY = {("iden_only", 1285, 1536, 1536), ("iden_only", 388, 3072, 3072),
              ("iden_only", 150, 1024, 1024), ("iden_only", 72, 2048, 2048),
              ("iden_only", 69, 3072, 3072)}
# the device walks' K1 launches on the slice under a one-card mesh
# (phase 9): with TH_HOST_ALN_CAP=0 every walk step, the largest launch
# (128,128) B=507 (the first round of the first chunk); at the default cap
# the steps of at most 192 bases a side resolve in native C, and one
# (256,256) B=1 launch a chunk is left.  Phase 9 checks that its runs
# launched exactly these largest shapes.
WALK_CASES = {"TH_HOST_ALN_CAP=0": (128, 128, 507),
              "default cap": (256, 256, 1)}
WALK_LABEL = "tleft (128,128) B=507"    # kept in the kernel line
MSA_CASES = [(640, 128, 512, 450), (640, 128, 8, 450), (640, 128, 1, 450),
             (640, 256, 128, 450), (640, 512, 64, 450),
             (640, None, 64, 450), (128, None, 704, 60),
             (256, None, 64, 200), (2048, None, 8, 1500),
             (4096, 128, 64, 3000), (4096, 256, 64, 3000),
             (4096, 512, 8, 3000), (4096, None, 2, 3000),
             (4096, 256, 8, 3000), (4096, 256, 121, 3000),
             (4096, 128, 8, 3000), (4096, 128, 125, 3000),
             (2048, 128, 8, 1500), (2048, 256, 8, 1500),
             (2048, 512, 8, 1500), (2048, 128, 256, 1500),
             (2048, 256, 251, 1500), (2048, 512, 256, 1500)]
# the band kernel's launch sizes beyond B=64 (the protocol's B=8, the
# periods path's largest) and the T=2048 rungs at the protocol's B=8 (174
# launches) and the periods path's largest B (256 at W=128, 251 at
# W=256; W=512 at B=256, 16 warps a region of the band kernel, two waves
# of CTAs): profile_bt reads their planes as it reads the shapes checked
# above, so only profile_dp is checked there
DP_ONLY = set(MSA_CASES[-10:])
# checked against the plain version on their first PLAIN_FIRST regions
DP_FIRST = set(MSA_CASES[-3:])
# the entry point whose route each kernel of the summary is (--kernels
# profile_dp checks them all)
ENTRY_POINT = {"profile_dp_band": "profile_dp", "wf_global_cta": "wf_global"}
# wf_global's kernel of each route (ops/wavefront.GLOBAL_ROUTES)
GLOBAL_KERNEL = {"warp": "wf_global", "cta": "wf_global_cta"}
# wf_global's two routes timed side by side (each equal to the other) in
# a --kernels run that names wf_global: launch sizes about global_route's
# threshold at 2, 3, 4 and 6 tiles, and the accuracy protocol's launches
# past one tile (phase 10 (c): (1024,1024) B up to 150, (1280,1024) B up
# to 2, (2048,2048) B up to 72, (3072,3072) B up to 69): (kind, LQ, LT,
# sizes)
ROUTE_SWEEP = [("tleft", 256, 1024, (64, 256, 384, 512, 2048)),
               ("iden_only", 1024, 1024, (2, 8, 32, 72, 150, 264, 400,
                                          528)),
               ("iden_only", 1280, 1024, (2, 8)),
               ("iden_only", 1536, 1536, (132, 528, 700, 850, 1000, 1100,
                                          1200, 1285, 1800, 2570)),
               ("iden_only", 2048, 2048, (72, 132, 528, 1000, 1500, 2000)),
               ("iden_only", 3072, 3072, (8, 69, 132, 388, 1000, 2000))]
# the shape the band kernel was written for: phases 5 and 10 (c) fail
# unless their runs reach it on profile_dp's route there
BAND_SHAPE = (4096, 256)
# one region at the 4096 bucket's W=256 with a 3000 bp unit: (T, W, unit
# length) of row_cost
ROW_COST = (4096, 256, 3000)
# the check whose numbers stand for each kernel in the summary line: the
# largest launch shape of the slice (for wf_ext the route of its launches
# of more than one problem an SM, which hold most of its slice time; for
# myers_hw the largest launch of its main path, phase 6's first run)
MAIN_SHAPES = {"wf_global": "iden_only (512,512) B=4096",
               "wf_global_cta": "iden_only (3072,3072) B=388",
               "wf_ext": "ext (512,640) B=1024",
               "profile_dp": "T=640 W=128 B=512",
               "profile_dp_full": "T=128 W=full B=704",
               "profile_dp_band": "T=4096 W=256 B=121",
               "profile_bt": "T=640 W=128 B=512",
               "myers_hw": "largest launch of -5 -3 -f 2",
               "seed_hits": "slice chunk k=8 w=1 B=512 packed",
               "chain_dp": "slice chunk hits window=full B=512",
               "dtype_micro": "int32 (512,1024) chain 64"}
# wf_ext's lanes a thread timed at the slice's extension shapes, beside
# the choice of ops/wavefront.ext_lanes
EXT_LANES_SWEEP = ((512, 640), (512, 256))
LANES = (1, 2, 4)
# the probe's comparison shapes: its defaults, an odd tile, and two ragged
# ones (odd T, T no multiple of 4: lane T-1 inside its thread's lanes)
PROBE_CASES = [(512, 128), (200, 7), (201, 3), (203, 5)]
FLOOR_TURNS = 3      # phase 4's runs of the host floor and the slice each
SLICE_KERNELS = ("wf_global", "wf_ext", "profile_dp", "profile_bt")
# kernel names in a trace -> the kernel (profile_dp has four)
TRACE_NAMES = {"wf_global_kernel": "wf_global",
               "wf_global_cta": "wf_global_cta", "wf_ext_kernel": "wf_ext",
               "profile_dp_strip": "profile_dp_strip",
               "profile_dp_band": "profile_dp_band",
               "profile_dp_kernel": "profile_dp_first",
               "profile_bt_warp": "profile_bt",
               "myers_hw_kernel": "myers_hw"}
PERIOD_ORACLE_READS = 8      # reads of each population held to the oracle
SC_QLENS = (32, 64, 65, 128)  # single-copy search shapes of phase 2
LONG_READS, LONG_GAP = 16, 2300  # phase 2's long row: 16 reads of ~12 kb
# phase 6: the kernels each option run (evals/bench.OPTION_RUNS) must
# launch, those it must not, and the profile_dp routes it must take
CONSENSUS_KERNELS = ("wf_global", "wf_ext", "profile_dp", "profile_bt")
ADAPTER_NEED = (CONSENSUS_KERNELS + ("myers_hw",), (), ("band",))
OPTION_NEED = {"ada_f2": ADAPTER_NEED, "ada_F": ADAPTER_NEED,
               "ada_sF": ADAPTER_NEED, "ada_a": ADAPTER_NEED,
               "polish1": (CONSENSUS_KERNELS, ("myers_hw",), ("band",)),
               # the MSA on the host graph-POA
               "msa_graph": (("wf_global", "wf_ext"),
                             ("profile_dp", "profile_bt"), ()),
               # -u writes units, no consensus: K1 resolves the partition
               # walks' steps past TH_HOST_ALN_CAP (one launch, in the
               # slice's second chunk)
               "unit_f2": (("wf_global",), ("wf_ext", "profile_dp",
                                            "profile_bt"), ()),
               "scoring": (CONSENSUS_KERNELS, (), ("band",)),
               "seeding": (CONSENSUS_KERNELS, (), ("band",)),
               # K3 at full width on the 60 bp units, the band kernel on
               # every band rung (the 3000 bp units' 4096 bucket too; -P
               # 2000 drops those)
               "fq_f3_l": (CONSENSUS_KERNELS, (), ("strips", "band")),
               "fq_f4_filt": (CONSENSUS_KERNELS, (), ("strips", "band"))}

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
# int32 results per clock per SM: 64 on the INT pipe (CUDA C++ Programming
# Guide's throughput table, cc 9.0) plus 64 IMAD on the FMA pipe, which
# nvcc uses for adds and moves; at 64 alone wf_dtype_probe measured faster
# than its bound
INT32_PER_CLK_PER_SM = 128
# Integer ops per DP cell (per backtrack step for profile_bt), counted in
# each kernel's source in csrc/ for each variant; the probe's count is in
# its module.
OPS_PER_CELL = {"wf_global iden_only": 51, "wf_global tleft": 70,
                "wf_ext": 49, "profile_dp banded": 88,
                "profile_dp full": 76, "profile_bt": 73}
# myers_hw: int32 operations a target column and 64-bit query word, and a
# column, that the search needs, one yardstick for both versions (a 64-bit
# operator counts two).  A word: Hyyro's step, xv = eq | mv (1), xh =
# (((eq & pv) + pv) ^ pv) | eq (4), ph = mv | ~(xh | pv) (3), mh = pv & xh
# (1), ph <<= 1, mh <<= 1 (2), pv = mh | ~(xv | ph) (3), mv = ph & xv (1):
# 15 operators.  Picking eq by the target's code is an indexed load; the
# carry of the add and the bit the shifts move across words ride in an
# add-with-carry and a funnel shift; no mask is needed, since no bit flows
# down to bit m - 1.  A column: bit m - 1 of ph and mh (2), the score (2),
# the leftmost least (3), the column's index and loop test (2) and the
# target byte's address (1).  Both passes, over the columns the semantics
# need: every target column of the HW pass, min(end + 1, m + ed) of the
# SHW pass
MYERS_OPS_PER_COL_WORD = 30
MYERS_OPS_PER_COL = 10
# seed_hits: int32 ops a stream lane and key base, a lane, a sort compare
# and a binary-search step (32- / 64-bit words), and a lane and window
# offset of each w > 1 pass (csrc/seed_hits.cu's header)
SEED_OPS_KEY_BASE, SEED_OPS_LANE, SEED_OPS_W = 6, 30, 8
SEED_OPS_CMP, SEED_OPS_SEARCH = {False: 10, True: 16}, {False: 6, True: 9}
# chain_dp: int32 ops a predecessor lane scanned (get_con_score and the
# compare with the running maximum) and a cell (csrc/chain_dp.cu's header)
CHAIN_OPS_PER_LANE, CHAIN_OPS_PER_CELL = 29, 20
# dtype_micro's per-op issue rates by element type, results a clock an SM
# (x the SMs x the maximum SM clock: 132 x 1980 MHz on the H100 SXM), from
# the CUDA C++ Programming Guide's throughput table for cc 9.0.  float32
# add and multiply: 128 a clock an SM (scalar; 33.45 T ops/s; the step's
# max and compare taken at the same rate, so the bound stays a least
# time), where the data sheet's 67 TFLOP/s counts an FMA as two ops and
# this step has none.  bfloat16: 256 results a clock an SM of the 16-bit
# float add / multiply, 128 bf16x2 instructions (HFMA2.BF16, HMNMX2.BF16,
# HSET2.BF16), 33.45 T x2 ops/s, where the data sheet's 989 TFLOP/s is
# the tensor cores', which no elementwise op reaches.  The integer
# variants use INT32_PER_CLK_PER_SM, a packed s16x2 or s8x4 word being one
# 32-bit op.  A variant's ops count 32-bit words (elements / LANES_PER_WORD).
FP32_PER_CLK_PER_SM = 128
BF16X2_PER_CLK_PER_SM = 128
DTYPE_PER_CLK_PER_SM = {"float32": FP32_PER_CLK_PER_SM,
                        "bfloat16": BF16X2_PER_CLK_PER_SM}
# elements a 32-bit word of dtype_micro's packed kernel
LANES_PER_WORD = {"int32": 1, "int16": 2, "int8": 4, "float32": 1,
                  "bfloat16": 2, "swar": 1}
# dtype_micro's ragged check: a byte count no multiple of 16
DTYPE_RAGGED = (7, 1001)
# SWAR's int32 operators an element a step in csrc/dtype_micro.cu: padd
# once (7: two masks, add, mask, xor, mask, or) and pmax twice (10 each:
# or, mask, sub, mask, shift, multiply, and, not, and, or)
SWAR_OPS_PER_STEP = 27
# phase 8's seed_hits checks: (label, reads, k, w, hpc, packed hits)
SEED_CASES = [("slice chunk k=8 w=1 B=512 packed", "slice", 8, 1, False,
               True),
              ("periods 12.3 kb k=8 B=128 packed", "cdna", 8, 1, False, True),
              ("slice chunk -H B=512 packed", "slice", 8, 1, True, True),
              ("slice chunk w=5 B=512 packed", "slice", 8, 5, False, True),
              ("slice chunk k=16 B=512 64-bit words", "slice", 16, 1, False,
               False),
              ("cluster boundary ~10.6 kb -H w=5 B=128 packed", "boundary",
               8, 5, True, True),
              ("40 kb reads B=8 64-bit words", "long", 8, 1, False, False),
              ("past a cluster ~70 kb -H w=5 B=8 64-bit words (global "
               "scratch)", "past", 8, 5, True, False)]
CHAIN_WINDOWS = (None, 64)      # full (the plane's width L) and 64
# phase 8's slice runs: the packed route, seeding alone and chaining too,
# then the v1 route (collect_hits_batch, chain_dp at the hit bucket)
DEVICE_SEED_RUNS = (("TH_DEVICE_SEED=1", {"TH_DEVICE_SEED": "1"}),
                    ("TH_DEVICE_SEED=1 TH_DEVICE_CHAIN=1",
                     {"TH_DEVICE_SEED": "1", "TH_DEVICE_CHAIN": "1"}),
                    ("TH_DEVICE_SEED=1 TH_DEVICE_CHAIN=1 TH_OFFLOAD_V1=1",
                     {"TH_DEVICE_SEED": "1", "TH_DEVICE_CHAIN": "1",
                      "TH_OFFLOAD_V1": "1"}))
DEVICE_SEED_ENV = ("TH_DEVICE_SEED", "TH_DEVICE_CHAIN", "TH_OFFLOAD_V1")
# phase 9's runs of the slice: (label, environment, explicit mesh of two
# shards of card 0); make_engine builds the mesh from TH_MESH
MESH_RUNS = (("TH_MESH=-1", {"TH_MESH": "-1"}, False),
             ("TH_MESH=-1 TH_HOST_ALN_CAP=0",
              {"TH_MESH": "-1", "TH_HOST_ALN_CAP": "0"}, False),
             ("TH_MESH=-1 TH_OFFLOAD_V1=1",
              {"TH_MESH": "-1", "TH_OFFLOAD_V1": "1"}, False),
             ("Mesh([cuda:0, cuda:0])", {}, True))
MESH_ENV = DEVICE_SEED_ENV + ("TH_MESH", "TH_HOST_ALN_CAP", "TH_HOST_WALK",
                              "TH_DIST", "TH_METRICS")
# phase 11: the measurement tools, each with the arguments of its run
# (testfq_stages' FASTQ is written by the phase); dtype_micro's checked
# shape stands in the summary
EVAL_TOOLS = (("host_floor", ["1024"]), ("seed_chain_micro", ["512"]),
              ("offload_micro2", ["512"]), ("offload_micro", ["512"]),
              ("msa_micro", ["512"]), ("tunnel_micro", []),
              ("dtype_micro", []), ("testfq_stages", ["FASTQ", "2"]),
              ("mesh_scaling", []))


def nvidia_smi(query: str) -> str:
    res = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=120, check=True)
    return res.stdout.strip().splitlines()[0]


class Card:
    """The card's int32 rate (INT32_PER_CLK_PER_SM x SMs x the maximum SM
    clock) and the least time for a piece of work."""

    def __init__(self):
        self.sms = torch.cuda.get_device_properties(0).multi_processor_count
        self.clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
        self.int_rate = INT32_PER_CLK_PER_SM * self.sms * self.clock_mhz * 1e6

    def rate(self, per_clk_per_sm: int) -> float:
        """Ops a second at per_clk_per_sm results a clock an SM."""
        return per_clk_per_sm * self.sms * self.clock_mhz * 1e6

    def bound(self, ops: float, nbytes: float, rate=None):
        """(least ms, what bounds it) of ops at rate (default the int32
        rate) and nbytes at the HBM rate."""
        t_ops = ops / (rate or self.int_rate)
        t_bytes = nbytes / HBM_BYTES_PER_S
        return (max(t_ops, t_bytes) * 1e3,
                "operations" if t_ops >= t_bytes else "bytes")


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn over reps runs (CUDA events).  The runs queue
    behind a device sleep of ~10 ms, so that a kernel shorter than its
    wrapper's host time is timed back to back, not at the host's rate."""
    return timed(fn, reps)[0]


def timed(fn, reps: int = 1):
    """(mean device ms over reps runs of fn, the last run's result), the
    runs queued behind a device sleep as in cuda_ms."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def max_err(a, b) -> int:
    """Largest absolute difference over paired integer tensors."""
    err = 0
    for x, y in zip(a, b):
        if x.shape != y.shape:
            raise AssertionError(f"shape {tuple(x.shape)} != {tuple(y.shape)}")
        if x.numel():
            err = max(err, int((x.long() - y.long()).abs().max()))
    return err


def _nbytes(*xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs)


class Checks:
    """Kernel-vs-plain comparisons, one printed line each."""

    def __init__(self, card: Card, only=None):
        self.card = card
        self.only = only          # kernels to check (None: all)
        self.rows = {}

    def wants(self, kernel) -> bool:
        return (self.only is None or kernel in self.only
                or ENTRY_POINT.get(kernel) in self.only)

    def run(self, kernel, label, kern_fn, plain_fn, work, select=None,
            reps=5, beside=None, library_fn=None, rate=None, first=None,
            cut=None):
        """Compare, then time and bound (work() -> (ops, bytes); the ops at
        rate, default the int32 rate); with first, plain_fn computes the
        first `first` problems alone and the outputs are compared there
        (cut: the kernel's output cut to them, default each output's
        first rows; select then applies to the plain version's alone);
        beside: {name: fn} of other kernels of the same function (the first
        version, the other routes' kernels), each equal and timed beside as
        name_ms; with library_fn, the PyTorch call timed beside
        (library_ms); the main-path shape's numbers go to the summary."""
        if not self.wants(kernel):
            return
        beside = beside or {}
        sel = select or (lambda x: x)
        if not first:
            cut = sel
        elif cut is None:
            cut = lambda x: tuple(y[:first] for y in x)  # noqa: E731
        plain_ms, want = timed(plain_fn)
        got, want = cut(kern_fn()), sel(want)
        err = max_err(got, want)
        for name, fn in beside.items():
            e = max_err(cut(fn()), want)
            if e > TOL:
                raise AssertionError(f"{kernel} {label} ({name}): "
                                     f"max_abs_err {e}")
        if err > TOL:
            raise AssertionError(f"{kernel} {label}: max_abs_err {err}")
        ms = cuda_ms(kern_fn, reps)
        self.last_ms = ms
        beside_ms = {f"{name}_ms": cuda_ms(fn, reps)
                     for name, fn in beside.items()}
        library_ms = cuda_ms(library_fn, reps) if library_fn else None
        self.record(kernel, label + (f" (plain: first {first})" if first
                                     else ""), err, ms, plain_ms, *work(),
                    main=label == MAIN_SHAPES[kernel], beside_ms=beside_ms,
                    library_ms=library_ms, rate=rate)

    def record(self, kernel, label, err, ms, plain_ms, ops, nbytes, main,
               beside_ms=None, library_ms=None, rate=None):
        bound_ms, by = self.card.bound(ops, nbytes, rate)
        beside_ms = beside_ms or {}
        others = "".join(f" {k}={v:.4f} ({v / ms:.2f}x)"
                         for k, v in beside_ms.items())
        lib = (f" library_ms={library_ms:.4f}" if library_ms is not None
               else "")
        print(f"check {kernel} {label}: max_abs_err={err} ms={ms:.4f}"
              f"{others}{lib} plain_ms={plain_ms:.2f} bound_ms="
              f"{bound_ms:.4f} ({by}: {ops:.0f} ops, {nbytes:.0f} "
              f"bytes) share of bound {bound_ms / ms:.4f}", flush=True)
        row = self.rows.setdefault(kernel, {"max_abs_err": 0})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if label == WALK_LABEL:
            row["walk"] = {"shape": label, "ms": ms, "plain_ms": plain_ms,
                           "bound_ms": bound_ms, "bound_by": by}
        if main:
            row.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=by, library_ms=library_ms, **beside_ms)


def _mutate(rng, u, err):
    keep = rng.random(len(u)) >= err / 3
    u = np.where(rng.random(len(u)) < err / 3, rng.integers(0, 4, len(u)),
                 u)[keep]
    ins = rng.random(len(u)) < err / 3
    out = np.empty(len(u) + int(ins.sum()), np.uint8)
    pos = np.arange(len(u)) + np.cumsum(ins)
    out[pos] = u
    mask = np.ones(len(out), bool)
    mask[pos] = False
    out[mask] = rng.integers(0, 4, int(mask.sum()))
    return out


def pair_batch(rng, B, LQ, LT, dev):
    """B related (q, t) pairs with lengths in the upper quarter of the
    bucket, as the aveMatch and extension requests of the default path."""
    q = np.full((B, LQ), 4, np.uint8)
    t = np.full((B, LT), 4, np.uint8)
    qlen = np.zeros(B, np.int32)
    tlen = np.zeros(B, np.int32)
    for b in range(B):
        base = rng.integers(0, 4, max(LQ, LT)).astype(np.uint8)
        qs = _mutate(rng, base, 0.1)[: int(rng.integers(LQ * 3 // 4, LQ + 1))]
        ts = _mutate(rng, base, 0.1)[: int(rng.integers(LT * 3 // 4, LT + 1))]
        q[b, :len(qs)], t[b, :len(ts)] = qs, ts
        qlen[b], tlen[b] = len(qs), len(ts)
    return tuple(torch.as_tensor(a, device=dev) for a in (q, qlen, t, tlen))


def sweep_lanes(checks, label, q, ql, t, tl, sc):
    """wf_ext at each of LANES target lanes a thread: equal to the default
    route's outputs, with its time."""
    from tidehunter_tpu_torch.ops import wavefront as WF

    B, LT = t.shape
    chosen = WF.ext_lanes(LT, B, checks.card.sms)
    want = WF.ext_batch(q, ql, t, tl, sc)
    for L in LANES:
        run = lambda L=L: WF.ext_batch(q, ql, t, tl, sc, lanes=L)  # noqa: E731
        err = max_err(run(), want)
        if err > TOL:
            raise AssertionError(f"wf_ext {label} L={L}: max_abs_err {err}")
        mark = " (ext_lanes' choice)" if L == chosen else ""
        print(f"lanes wf_ext {label} L={L}: ms={cuda_ms(run, 5):.4f}{mark}",
              flush=True)


def sweep_routes(rng, dev):
    """wf_global's warp and CTA kernels at ROUTE_SWEEP's shapes, each equal
    to the other, with both times and global_route's choice."""
    from tidehunter_tpu_torch.ops import wavefront as WF

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for kind, LQ, LT, sizes in ROUTE_SWEEP:
        iden_only = kind == "iden_only"
        for B in sizes:
            q, ql, t, tl = pair_batch(rng, B, LQ, LT, dev)
            qle = (torch.zeros_like(ql) if iden_only else
                   (torch.rand(B, device=dev) * (ql + 2).float()).int())
            run = {r: (lambda r=r: WF.global_batch(
                q, ql, t, tl, qle, WF.DEFAULT_SCORES, iden_only, kernel=r))
                for r in WF.GLOBAL_ROUTES}
            err = max_err(run["warp"](), run["cta"]())
            if err > TOL:
                raise AssertionError(f"wf_global routes {kind} ({LQ},{LT}) "
                                     f"B={B}: max_abs_err {err}")
            ms = {r: cuda_ms(fn, 3) for r, fn in run.items()}
            print(f"route wf_global {kind} ({LQ},{LT}) B={B}: warp="
                  f"{ms['warp']:.4f} cta={ms['cta']:.4f} "
                  f"(global_route: {WF.global_route(B, LQ, LT, sms)})",
                  flush=True)


def dp_cells(qlen, ncol, W) -> float:
    """Cells a profile DP batch needs: (j, c) in [1, qlen] x [1, ncol],
    banded |c - j| <= W - 8 (a cell of row r = j + c - 2 at lane c - 1)."""
    if W is None:
        return float((qlen.double() * ncol.double()).sum())
    j = torch.arange(1, int(qlen.max()) + 1, device=qlen.device)[None, :]
    lo = (j - (W - 8)).clamp(min=1)
    hi = torch.minimum(j + (W - 8), ncol[:, None])
    n = (hi - lo + 1).clamp(min=0) * (j <= qlen[:, None])
    return float(n.double().sum())


def msa_round(rng, msa, T, W, B, L, dev):
    """One unit round of B regions (the second unit against the profile of
    the first, both L bp at 10% error from one base): profile_dp's
    arguments and the [2T-1, B] mask of the rows each region writes."""
    units = np.full((B, 2, T), 4, np.uint8)
    ulen = np.zeros((B, 2), np.int32)
    for b in range(B):
        base = rng.integers(0, 4, L).astype(np.uint8)
        for k in range(2):
            u = _mutate(rng, base, 0.1)[:T]
            units[b, k, :len(u)] = u
            ulen[b, k] = len(u)
    units_d = torch.as_tensor(units, device=dev)
    ulen_d = torch.as_tensor(ulen, device=dev)
    st = msa.init_state(units_d, ulen_d)
    sub, wdel, wl, wdel2, wl2 = msa.scores_step(st)
    unit, qlen = units_d[:, 1].contiguous(), ulen_d[:, 1].contiguous()
    rows = torch.arange(2 * T - 1, device=dev)[:, None]
    live = rows < (qlen + st.ncol - 1)[None, :]      # [2T-1, B]
    return (unit, qlen, st.ncol, sub, wl, wdel, wl2, wdel2, msa.costs,
            W), live


def row_cost(dev, msa):
    """One region (B=1) at ROW_COST's shape on the first version and on
    each of profile_dp's band-width kernels: every plane equal to the
    plain version's on its live rows, and its time a row (CUDA events,
    mean of 3) -- what a row of one region costs when nothing else runs on
    the card."""
    from tidehunter_tpu_torch.ops import msa_device as MD

    T, W, L = ROW_COST
    args, live = msa_round(np.random.default_rng(12), msa, T, W, 1, L, dev)
    nrows = int(live.sum())
    want = MD.profile_dp_plain(*args)[:nrows]
    for name in ("first", "band"):
        fn = lambda name=name: MD.profile_dp(*args, kernel=name)  # noqa: E731
        err = max_err((fn()[:nrows],), (want,))
        if err > TOL:
            raise AssertionError(f"row_cost {name}: max_abs_err {err}")
        ms = cuda_ms(fn, 3)
        print(f"row cost {name} T={T} W={W} B=1: {nrows} rows, "
              f"ms={ms:.4f} = {ms * 1e3 / nrows:.4f} us a row", flush=True)


def phase_kernels(checks, dev, lanes=True):
    """Every check of WF_CASES and MSA_CASES; with lanes, wf_ext's lanes a
    thread timed at EXT_LANES_SWEEP; in a --kernels run that names
    wf_global, its two routes at ROUTE_SWEEP."""
    from tidehunter_tpu_torch.ops import msa_device as MD
    from tidehunter_tpu_torch.ops import wavefront as WF

    rng = np.random.default_rng(7)
    sc = WF.DEFAULT_SCORES
    for kind, B, LQ, LT in WF_CASES:
        q, ql, t, tl = pair_batch(rng, B, LQ, LT, dev)
        label = f"{kind} ({LQ},{LT}) B={B}"
        # live cells: a problem runs qlen + tlen - 1 rows of live lanes
        cells = float((ql.double() * tl.double()).sum())
        if kind == "ext":
            def plain(q=q, ql=ql, t=t, tl=tl):
                besth, bestr, score = WF.ext_plain(q, ql, t, tl, sc)
                return (*WF.ext_tie_order(besth, bestr, ql, tl), score)

            # writes max, max_t, max_q and score [B], int32
            checks.run("wf_ext", label,
                       lambda: WF.ext_batch(q, ql, t, tl, sc), plain,
                       lambda: (OPS_PER_CELL["wf_ext"] * cells,
                                _nbytes(q, ql, t, tl) + 4 * B * 4))
            if (lanes and checks.wants("wf_ext")
                    and (LQ, LT) in EXT_LANES_SWEEP):
                sweep_lanes(checks, label, q, ql, t, tl, sc)
            continue
        iden_only = kind == "iden_only"
        # t_left requests (oversize partition windows) span qle 0..qlen+1
        qle = (torch.zeros_like(ql) if iden_only else
               (torch.rand(B, device=dev) * (ql + 2).float()).int())
        n = PLAIN_FIRST if (kind, B, LQ, LT) in FIRST_ONLY else B
        # the kernel of global_route's choice, the other route's beside
        route = WF.global_route(B, LQ, LT, checks.card.sms)
        beside = {r: (lambda r=r: WF.global_batch(q, ql, t, tl, qle, sc,
                                                  iden_only, kernel=r))
                  for r in WF.GLOBAL_ROUTES if r != route}
        checks.run(GLOBAL_KERNEL[route], label,
                   lambda: WF.global_batch(q, ql, t, tl, qle, sc, iden_only),
                   lambda: WF.global_plain(q[:n], ql[:n], t[:n], tl[:n],
                                           qle[:n], sc, not iden_only),
                   lambda: (OPS_PER_CELL[f"wf_global {kind}"] * cells,
                            _nbytes(q, ql, t, tl, qle) + 2 * B * 4),
                   first=n if n < B else None, beside=beside)

    # one unit round of a region batch: the second unit against the
    # profile of the first (skipped when no profile kernel is checked, as
    # on another tree's wavefront: --kernels wf_global --port)
    wants_msa = any(checks.wants(k) for k in (
        "profile_dp", "profile_dp_full", "profile_dp_band", "profile_bt"))
    msa = (MD.DeviceMSA(2, 4, 4, 2, gap_open2=24, gap_ext2=1, device=dev)
           if wants_msa else None)
    for T, W, B, L in MSA_CASES if wants_msa else ():
        args, live = msa_round(rng, msa, T, W, B, L, dev)
        unit, qlen, ncol, sub, wl, wdel, wl2, wdel2 = args[:8]
        label = f"T={T} W={W or 'full'} B={B}"
        # the work is the cells the data needs; a region writes one
        # direction byte per lane of its qlen + ncol - 1 rows, dead lanes 0
        dp_ops = (OPS_PER_CELL["profile_dp " + ("banded" if W else "full")]
                  * dp_cells(qlen, ncol, W))
        dp_bytes = (_nbytes(unit, qlen, ncol, sub, wl, wdel, wl2, wdel2)
                    + float(live.sum()) * (W or T))
        # K3 (full width) and K4 (banded) are one entry point; every shape
        # is timed against the first version, and every band rung against
        # the strips, the route profile_dp did not pick there.  K4's
        # summary rows: the slice's band rounds (profile_dp) and the 4096
        # bucket's (profile_dp_band)
        route = MD.dp_route(W)
        beside = {"first_version": (
            lambda: MD.profile_dp(*args, kernel="first"))}
        if W in MD.BAND_WIDTHS:
            for other in MD.DP_ROUTES:
                if other != route:
                    beside[other] = (lambda other=other: MD.profile_dp(
                        *args, kernel=other))
        kernel = ("profile_dp_full" if W is None else "profile_dp_band"
                  if T == MD.BUCKETS[-1] else "profile_dp")
        n = PLAIN_FIRST if (T, W, B, L) in DP_FIRST else B
        live_n = live[:, :n]
        checks.run(kernel, label, lambda: MD.profile_dp(*args),
                   lambda: MD.profile_dp_plain(
                       *(a[:n] if torch.is_tensor(a) else a
                         for a in args)),
                   lambda: (dp_ops, dp_bytes),
                   select=lambda d: (d[live_n],), beside=beside,
                   first=n if n < B else None,
                   cut=lambda d: (d[:, :n][live_n],))
        if (T, W, B, L) in DP_ONLY:
            continue
        dirs = MD.profile_dp(*args)
        bt = MD.profile_bt(dirs, qlen, ncol, T, W)
        steps = float(bt[1].double().sum())   # path length, a byte a step
        checks.run("profile_bt", label,
                   lambda: MD.profile_bt(dirs, qlen, ncol, T, W),
                   lambda: MD.profile_bt_plain(dirs, qlen, ncol, T, W),
                   lambda: (OPS_PER_CELL["profile_bt"] * steps,
                            steps + _nbytes(qlen, ncol, *bt)))
    if checks.wants("profile_dp"):
        row_cost(dev, msa)
    if checks.only and checks.wants("wf_global"):
        sweep_routes(rng, dev)
    if checks.wants("myers_hw"):
        check_myers(checks, dev, rng)


def revcomp(s: str) -> str:
    return s[::-1].translate(str.maketrans("ACGT", "TGCA"))


def myers_cases(rng):
    """(label, [(query, target, k)]): the adapter path's searches (the
    four adapter orientations in 1024 doubled consensus of an 84 + 450 +
    25 bp unit, k = 20% of the adapter), the single-copy path's (4
    queries of SC_QLENS bp in 512 reads of ~5 kb, each holding a noisy
    copy of every query) and few long targets (the same 4 queries in
    LONG_READS reads of ~12 kb: LONG_GAP random bases between the copies,
    where a thread a problem leaves the card emptiest)."""
    from tidehunter_tpu_torch.io.codec import decode
    from tidehunter_tpu_torch.ops.myers_device import encode5

    B = bench_mod()
    adapters = [B.FIVE, revcomp(B.THREE), revcomp(B.FIVE), B.THREE]
    codes = [encode5(a) for a in adapters]
    cons = []
    for _ in range(1024):
        unit = np.concatenate([codes[0], rng.integers(0, 4, 450).astype(
            np.uint8), codes[1]])
        unit = np.roll(_mutate(rng, unit, 0.02), int(rng.integers(0, 559)))
        cons.append(decode(np.concatenate([unit, unit])))
    main = [(a, t, int(len(a) * 0.2)) for t in cons for a in adapters]
    queries = [rng.integers(0, 4, n).astype(np.uint8) for n in SC_QLENS]
    reads = []
    for _ in range(512):
        read = [rng.integers(0, 4, 1000).astype(np.uint8)]
        for q in queries:
            read += [_mutate(rng, q, 0.1),
                     rng.integers(0, 4, 1000).astype(np.uint8)]
        reads.append(decode(np.concatenate(read)))
    sc = [(decode(q), t, int(len(q) * 0.2)) for t in reads for q in queries]
    longs = []
    for _ in range(LONG_READS):
        read = [rng.integers(0, 4, LONG_GAP).astype(np.uint8)]
        for q in queries:
            read += [_mutate(rng, q, 0.1),
                     rng.integers(0, 4, LONG_GAP).astype(np.uint8)]
        longs.append(decode(np.concatenate(read)))
    lc = [(decode(q), t, int(len(q) * 0.2)) for t in longs for q in queries]
    qs = "/".join(map(str, SC_QLENS))
    return [("adapters in doubled consensus B=4096", main),
            (f"single-copy qlen {qs} in ~5 kb reads B=2048", sc),
            (f"long targets qlen {qs} in ~12 kb reads B="
             f"{LONG_READS * len(SC_QLENS)}", lc)]


def check_myers(checks, dev, rng):
    """myers_hw at phase 2's shapes, packed as hw_batch packs them."""
    from tidehunter_tpu_torch.ops.myers_device import pack

    for label, trips in myers_cases(rng):
        seq, meta, rows = pack(*zip(*trips))
        assert len(rows) == len(trips)
        myers_check(checks, label, torch.as_tensor(seq, device=dev),
                    torch.as_tensor(meta, device=dev), int(meta[1].max()))


def myers_check(checks, label, seq, meta, qmax):
    """myers_hw against hw_batch_plain on the card, exact, with the lanes a
    problem of its launch (myers_hw_lanes; not printed for a tree without
    it).  The bound counts the work this run's data needs: for each
    search, ceil(qlen / 64) words over every target column (HW pass) and,
    when it is within k, min(end + 1, m + ed) columns (SHW pass: no later
    column can score ed), for the first version as for this one."""
    from tidehunter_tpu_torch import _kernels as K
    from tidehunter_tpu_torch.ops import myers_device as MY

    B = meta.shape[1]
    if hasattr(K.load(), "myers_hw_lanes"):
        with torch.cuda.device(seq.device):
            P = K.host_call("myers_hw_lanes", [ctypes.c_int], ctypes.c_int,
                            B)
        print(f"myers_hw {label}: {P} lanes a problem, B={B}, targets "
              f"{int(meta[3].min())}-{int(meta[3].max())} bp", flush=True)

    def work():
        ed, _, end = MY.myers_hw(seq, meta, qmax).double()
        words = torch.ceil(meta[1].double() / 64)
        shw = torch.minimum(end + 1, meta[1].double() + ed)
        cols = meta[3].double() + torch.where(ed >= 0, shw, 0)
        ops = float((cols * (MYERS_OPS_PER_COL_WORD * words
                             + MYERS_OPS_PER_COL)).sum())
        return ops, _nbytes(seq, meta) + 3 * 4 * meta.shape[1]

    checks.run("myers_hw", label, lambda: (MY.myers_hw(seq, meta, qmax),),
               lambda: (MY.hw_batch_plain(seq, meta),), work, reps=20)


def phase_probe(checks, dev) -> int:
    """wf_dtype_probe against probe_plain (chains of 8 calls, exact), then
    the probe's timing table at its defaults: the run whose launches
    count."""
    from tidehunter_tpu_torch import _kernels as K
    from tidehunter_tpu_torch.evals import wf_dtype_probe as P

    worst = 0
    for T, BT in PROBE_CASES:
        for name in P.VARIANTS:
            tb = P.tile(name, T, BT, dev)
            err = max_err(P.chain(tb, name),
                          P.chain(tb, name, P.probe_plain))
            if err > TOL:
                raise AssertionError(
                    f"wf_dtype_probe {name} T={T} BT={BT}: max_abs_err {err}")
            worst = max(worst, err)
            print(f"check wf_dtype_probe {name} T={T} BT={BT}: chain of "
                  f"{P.CHAIN} max_abs_err={err}", flush=True)
    T, BT = PROBE_CASES[0]
    plain_ms = {}
    for name, (dt, iota_dt) in P.VARIANTS.items():
        tb = P.tile(name, T, BT, dev)
        plain_ms[name] = cuda_ms(lambda: P.probe_plain(tb, dt, iota_dt), 1)

    K.reset_launches()
    ms = P.time_variants(T, BT)
    launches = K.WF_DTYPE_PROBE.launches
    for line in P.report(T, BT, ms):
        print(f"probe T={T} BT={BT}: {line}", flush=True)
    # OPS_PER_CELL source ops a 32-bit word: an int32 word is a cell, a
    # packed int16 word 2, an int8 word 4; tb is read and out written
    # once, at the state type's width
    cells = BT * T * P.n_rows(T)
    ops = P.OPS_PER_CELL * cells
    for name, (dt, _) in P.VARIANTS.items():
        bound_ms, by = checks.card.bound(ops * dt.itemsize / 4,
                                         2 * BT * T * dt.itemsize)
        print(f"probe variant {name} T={T} BT={BT}: ms={ms[name]:.4f} "
              f"plain_ms={plain_ms[name]:.2f} bound_ms={bound_ms:.4f} "
              f"({by}) share of bound {bound_ms / ms[name]:.4f} "
              f"speedup vs int32 {ms['int32'] / ms[name]:.4f}",
              flush=True)
    checks.record("wf_dtype_probe", f"int32 T={T} BT={BT}", worst,
                  ms["int32"], plain_ms["int32"], ops, 2 * BT * T * 4,
                  main=True)
    checks.rows["wf_dtype_probe"]["variants_ms"] = ms
    return launches


def fuzz_reads(rng, n):
    """Fuzz-style reads: random periods, copy numbers and error rates."""
    from tidehunter_tpu_torch.evals.synth import synth_read
    from tidehunter_tpu_torch.io.fastx import FastxRecord

    out = []
    for i in range(n):
        L = int(rng.integers(30, 600))
        copies = int(rng.integers(2, 9))
        err = float(rng.choice([0.0, 0.05, 0.15]))
        out.append(FastxRecord(name=f"fuzz_{i}", comment="",
                               seq=synth_read(rng, L, copies, err,
                                              int(rng.integers(0, 200)))))
    return out


def serialize(reads, results, mtp):
    from tidehunter_tpu_torch.io.output import write_read_output

    buf = io.StringIO()
    for rec, res in zip(reads, results):
        write_read_output(buf, rec.name, rec.seq, res, mtp)
    return buf.getvalue()


def _oracle_one(task) -> str:
    """(read, params, graph MSA) -> the read's records by tidehunter_core,
    serialized; graph sets the host oracle's graph-POA switch (TH_MSA), as
    the CLI's --msa graph does for its run."""
    from tidehunter_tpu_torch.pipeline.core import tidehunter_core

    rec, mtp, graph = task
    if graph:
        os.environ["TH_MSA"] = "graph"
    else:
        os.environ.pop("TH_MSA", None)
    return serialize([rec], [tidehunter_core(rec.seq, mtp)], mtp)


def oracle_records(tasks):
    """The records of each (read, params, graph MSA) task by the host
    oracle, computed over a pool of host processes (one core left to this
    one); the pool is shut down before returning."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    n = max(1, min(len(tasks), (os.cpu_count() or 2) - 1))
    with ProcessPoolExecutor(n, mp_context=multiprocessing.get_context(
            "spawn")) as pool:
        return list(pool.map(_oracle_one, tasks))


def bench_mod():
    """The port's bench (tidehunter_tpu_torch/evals/bench.py): the slice's
    and the periods path's reads, their committed oracle digests and the
    gate that holds every read's records to them."""
    from tidehunter_tpu_torch.evals import bench

    return bench


def check_cell_digests(cell, reads, text):
    """Every read's records of a timed run (text) against the cell's
    committed oracle digests (bench_digests.json), and its input (all the
    cell's reads) against the file's sha256; raises on a difference."""
    B = bench_mod()
    digests = B.load_digests()
    t0 = time.perf_counter()
    B.check_input(cell, reads, digests)
    n = B.check_records(cell, reads, text, digests)
    print(f"{cell} digests: all {n} reads' records of the timed run "
          f"({text.count('>')} records) match the oracle's digests in "
          f"{os.path.relpath(B.DIGESTS)}; input sha256 matches "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)


def phase_slice(tmp, dev):
    """Returns the timed run's launches and (input file, its output)."""
    from tidehunter_tpu_torch import _kernels as K
    from tidehunter_tpu_torch.engine import Engine
    from tidehunter_tpu_torch.params import Params
    from tidehunter_tpu_torch.pipeline import runner
    from tidehunter_tpu_torch.pipeline.core import tidehunter_core
    from tidehunter_tpu_torch.utils.metrics import METRICS

    B = bench_mod()
    n_reads = B.SLICE_READS
    reads = B.slice_reads()
    fa = os.path.join(tmp, "r2c2.fa")
    with open(fa, "w") as f:
        f.writelines(f">{r.name}\n{r.seq}\n" for r in reads)
    mtp = Params()
    mtp.chunk_read_n = 512
    engine = Engine(mtp, device=dev.type)
    t0 = time.perf_counter()
    runner.run(fa, mtp, out=io.StringIO(), process_chunk=engine)
    sync(dev)
    warm_s = time.perf_counter() - t0

    METRICS.reset()
    K.reset_launches()
    sink = io.StringIO()
    t0 = time.perf_counter()
    metrics = runner.run(fa, mtp, out=sink, process_chunk=engine)
    sync(dev)
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in K.launches().items() if k in SLICE_KERNELS}
    snap = METRICS.snapshot()
    print(f"slice: {n_reads} reads in {wall:.3f} s = "
          f"{n_reads / wall:.2f} reads/s (warm run {warm_s:.3f} s); "
          f"consensus records {metrics.cons_records}; "
          f"launches {json.dumps(launches)} over {metrics.chunks} chunks; "
          f"regions past the largest bucket (host rule) "
          f"{int(snap.get('msa_host_oversize', 0))}", flush=True)
    print("slice stages: " + " ".join(
        f"{k}={v}" for k, v in sorted(snap.items())), flush=True)
    idle = [k for k, v in launches.items() if v <= 0]
    if idle:
        raise AssertionError(f"kernels not launched by the slice: {idle}")
    trace_run(lambda: runner.run(fa, mtp, out=io.StringIO(),
                                 process_chunk=engine), dev, "slice")
    floor_in_turns(fa, mtp, engine, dev)
    if metrics.reads != n_reads or metrics.cons_records < n_reads // 2:
        raise AssertionError(f"slice produced {metrics.cons_records} records"
                             f" for {metrics.reads} reads")

    check = reads[:32] + fuzz_reads(np.random.default_rng(2024), 12)
    t0 = time.perf_counter()
    want = [tidehunter_core(r.seq, mtp) for r in check]
    oracle_s = time.perf_counter() - t0
    got = engine(check, mtp)
    bad = [r.name for r, a, b in zip(check, got, want)
           if serialize([r], [a], mtp) != serialize([r], [b], mtp)]
    if bad:
        raise AssertionError(f"records differ from the oracle: {bad}")
    if not sink.getvalue().startswith(serialize(reads[:32], want[:32], mtp)):
        raise AssertionError("slice output differs from the oracle")
    n_rec = sum(len(w.records) for w in want)
    print(f"slice oracle: {len(check)} reads ({n_rec} records) "
          f"byte-identical with tidehunter_core ({oracle_s:.1f} s host)",
          flush=True)
    check_cell_digests("slice", reads, sink.getvalue())
    return launches, (fa, sink.getvalue())


def floor_in_turns(fa, mtp, engine, dev):
    """The host floor and the slice, FLOOR_TURNS runs of each in turns on
    the slice's reads and chunks in this process (the floor's engine warmed
    once first), so that the host's speed is the same for both: the walls
    a turn and the floor's share of the slice's."""
    from tidehunter_tpu_torch.evals import host_floor as HF
    from tidehunter_tpu_torch.pipeline import runner

    floor = HF.floor_engine(mtp, dev.type)
    runner.run(fa, mtp, out=io.StringIO(), process_chunk=floor)
    walls = {"floor": [], "slice": []}
    for _ in range(FLOOR_TURNS):
        for name, eng in (("floor", floor), ("slice", engine)):
            sync(dev)
            t0 = time.perf_counter()
            runner.run(fa, mtp, out=io.StringIO(), process_chunk=eng)
            sync(dev)
            walls[name].append(time.perf_counter() - t0)
    floor.close()
    n = bench_mod().SLICE_READS
    ms = {k: [1e3 * w / n for w in v] for k, v in walls.items()}
    shares = [f / w for f, w in zip(walls["floor"], walls["slice"])]
    print("host floor in turns with the slice (ms/read [host]): floor "
          + " ".join(f"{x:.4f}" for x in ms["floor"]) + "; slice "
          + " ".join(f"{x:.4f}" for x in ms["slice"])
          + "; the floor's share of the slice's wall a turn "
          + " ".join(f"{x:.4f}" for x in shares), flush=True)


def trace_run(run, dev, label):
    """run() once more under torch.profiler: device ms and launches of
    every kernel by name and of each kernel of TRACE_NAMES, and the device
    busy share (the union of kernel and copy intervals over the wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name, glob_ms = [], {}, []
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        spans.append((ev.time_range.start, ev.time_range.end))
        name = ev.name.replace("(anonymous namespace)::", "")
        name = name.split("(")[0].removeprefix("void ")
        if "wf_global_kernel" in name or "wf_global_cta" in name:
            glob_ms.append((ev.time_range.start,
                            (spans[-1][1] - spans[-1][0]) / 1e3))
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (spans[-1][1] - spans[-1][0]) / 1e3, n + 1)
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    per_kernel = {k: [0.0, 0] for k in TRACE_NAMES.values()}
    for name, (ms, n) in sorted(by_name.items(), key=lambda x: -x[1][0]):
        print(f"{label} trace: {name}: {ms:.3f} ms in {n} launches",
              flush=True)
        key = next((v for k, v in TRACE_NAMES.items() if k in name), None)
        if key:
            per_kernel[key][0] += ms
            per_kernel[key][1] += n
    busy_ms = busy_us / 1e3
    print(f"{label} trace summary: " + json.dumps({
        "wall_ms": round(wall_ms, 3), "device_busy_ms": round(busy_ms, 3),
        "device_busy_share": round(busy_ms / wall_ms, 5),
        "device_ms_all": round(sum(ms for ms, _ in by_name.values()), 3),
        "kernels": {k: {"device_ms": round(ms, 3), "launches": n}
                    for k, (ms, n) in per_kernel.items()}}), flush=True)
    return [ms for _, ms in sorted(glob_ms)]


class LaunchShapes:
    """Records the (T, W, B) of every profile_dp call of the device MSA
    and the (LQ, LT, B) of every wf_global call of the engine while active
    (the calls themselves are unchanged)."""

    def __init__(self):
        from tidehunter_tpu_torch.ops import msa_device as MD
        from tidehunter_tpu_torch.ops import wavefront as WF

        self.md, self.wf, self.calls, self.glob = MD, WF, [], []
        self.orig, self.orig_g = MD.profile_dp, WF.global_batch

    def __enter__(self):
        def rec(unit, *args, **kw):
            W = kw.get("W", args[8] if len(args) > 8 else None)
            self.calls.append((args[2].shape[2], W, unit.shape[0]))
            return self.orig(unit, *args, **kw)

        def rec_g(q, ql, t, *args, **kw):
            self.glob.append((q.shape[1], t.shape[1], q.shape[0]))
            return self.orig_g(q, ql, t, *args, **kw)

        self.md.profile_dp, self.wf.global_batch = rec, rec_g
        return self

    def __exit__(self, *exc):
        self.md.profile_dp, self.wf.global_batch = self.orig, self.orig_g

    def summary(self) -> str:
        by = {}
        for T, W, B in self.calls:
            n, lo, hi = by.get((T, W), (0, B, B))
            by[(T, W)] = (n + 1, min(lo, B), max(hi, B))
        return "; ".join(f"T={T} W={W or 'full'}: {n} launches, B "
                         f"{lo}-{hi}" for (T, W), (n, lo, hi) in
                         sorted(by.items(), key=lambda x: (x[0][0],
                                                           x[0][1] or 0)))


def check_band_route(shapes, routes, label):
    """The run reached the 4096 bucket's W=256 (BAND_SHAPE), profile_dp
    launched the kernel of that shape's route there, and every launch took
    dp_route's kernel: fails otherwise."""
    from tidehunter_tpu_torch.ops import msa_device as MD

    if not any((T, W) == BAND_SHAPE for T, W, _ in shapes.calls):
        raise AssertionError(f"{label}: no profile_dp launch at T, W = "
                             f"{BAND_SHAPE}")
    route = MD.dp_route(BAND_SHAPE[1])
    if not routes.get(route):
        raise AssertionError(f"{label}: profile_dp's {route} kernel, the "
                             f"route of {BAND_SHAPE}, did not launch")
    off = {MD.dp_route(W) for T, W, _ in shapes.calls} ^ set(routes)
    if off:
        raise AssertionError(f"{label}: profile_dp launches by route "
                             f"{routes} against dp_route's {off}")


def phase_periods(tmp, dev):
    """Short and long periods end to end (the bench's
    PERIOD_POPULATIONS): reads/s, stage timers and launches of the timed
    run, the profile_dp shapes it launched, the timed run once more under
    torch.profiler, the timed run's records of the first
    PERIOD_ORACLE_READS reads of each population against tidehunter_core,
    and every read's against the committed digests.  Returns the launches
    of the timed run, K3's as its full-width rounds, and (input file, its
    output)."""
    from tidehunter_tpu_torch import _kernels as K
    from tidehunter_tpu_torch.engine import Engine
    from tidehunter_tpu_torch.params import Params
    from tidehunter_tpu_torch.pipeline import runner
    from tidehunter_tpu_torch.utils.metrics import METRICS

    B = bench_mod()
    pops = B.period_populations()
    reads = [r for pop in pops for r in pop]
    fa = os.path.join(tmp, "periods.fa")
    with open(fa, "w") as f:
        f.writelines(f">{r.name}\n{r.seq}\n" for r in reads)
    mtp = Params()
    mtp.chunk_read_n = 512
    engine = Engine(mtp, device=dev.type)
    t0 = time.perf_counter()
    runner.run(fa, mtp, out=io.StringIO(), process_chunk=engine)
    sync(dev)
    warm_s = time.perf_counter() - t0

    METRICS.reset()
    K.reset_launches()
    sink = io.StringIO()
    with LaunchShapes() as shapes:
        t0 = time.perf_counter()
        metrics = runner.run(fa, mtp, out=sink, process_chunk=engine)
        sync(dev)
        wall = time.perf_counter() - t0
    launches = {k: v for k, v in K.launches().items() if k in SLICE_KERNELS}
    routes = dict(K.PROFILE_DP.routes)
    groutes = dict(K.WF_GLOBAL.routes)
    snap = METRICS.snapshot()
    full = int(snap.get("msa_full_rounds", 0))
    mix = ", ".join(f"{n} of {u} bp x {c}"
                    for _, n, u, c in B.PERIOD_POPULATIONS)
    print(f"periods: {len(reads)} reads ({mix}) in {wall:.3f} s = "
          f"{len(reads) / wall:.2f} reads/s (warm run {warm_s:.3f} s); "
          f"consensus records {metrics.cons_records}; "
          f"launches {json.dumps(launches)}; msa_full_rounds {full}; "
          f"regions past the largest bucket (host rule) "
          f"{int(snap.get('msa_host_oversize', 0))}", flush=True)
    print("periods stages: " + " ".join(
        f"{k}={v}" for k, v in sorted(snap.items())), flush=True)
    print(f"periods profile_dp launches: {shapes.summary()}", flush=True)
    print(f"periods profile_dp routes: {route_summary(shapes)}; launches "
          f"by route {json.dumps(routes)}; wf_global launches by route "
          f"{json.dumps(groutes)}", flush=True)
    if full <= 0:
        raise AssertionError("the periods path ran no full-width round")
    check_band_route(shapes, routes, "periods")
    if not groutes.get("cta"):
        raise AssertionError("periods: wf_global's CTA kernel did not "
                             "launch")
    idle = [k for k, v in launches.items() if v <= 0]
    if idle:
        raise AssertionError(f"kernels not launched by the periods path: "
                             f"{idle}")
    if metrics.reads != len(reads) or metrics.cons_records < len(reads) // 2:
        raise AssertionError(f"periods produced {metrics.cons_records} "
                             f"records for {metrics.reads} reads")
    # wf_global's launches in the traced run, in order, beside their shapes
    with LaunchShapes() as traced:
        glob_ms = trace_run(lambda: runner.run(fa, mtp, out=io.StringIO(),
                                               process_chunk=engine), dev,
                            "periods")
    if len(glob_ms) == len(traced.glob):
        print("periods trace wf_global launches: " + "; ".join(
            f"({lq},{lt}) B={b} {ms:.3f} ms"
            for (lq, lt, b), ms in zip(traced.glob, glob_ms)), flush=True)

    got = B.records_by_read(sink.getvalue())
    check = [r for pop in pops for r in pop[:PERIOD_ORACLE_READS]]
    t0 = time.perf_counter()
    want = oracle_records([(r, mtp, False) for r in check])
    oracle_s = time.perf_counter() - t0
    bad = [r.name for r, w in zip(check, want) if got.get(r.name, "") != w]
    if bad:
        raise AssertionError(f"periods records differ from the oracle: "
                             f"{bad}")
    for name, *_ in B.PERIOD_POPULATIONS:
        recs = [w for r, w in zip(check, want)
                if r.name.startswith(name + "_")]
        print(f"periods oracle {name}: the timed run's records of its first "
              f"{len(recs)} reads ({sum(w.count('>') for w in recs)} "
              f"records) byte-identical with tidehunter_core", flush=True)
    print(f"periods oracle: {len(check)} reads in {oracle_s:.1f} s over a "
          f"pool of host processes", flush=True)
    check_cell_digests("periods", reads, sink.getvalue())
    return ({**launches, "profile_dp_full": full,
             "profile_dp_band": routes.get("band", 0),
             "wf_global_cta": groutes["cta"]},
            (fa, sink.getvalue()))


class MyersLaunches:
    """Records the problem count of every myers_hw launch of hw_batch
    while active, and the inputs of the largest (the calls themselves are
    unchanged)."""

    def __init__(self):
        from tidehunter_tpu_torch.ops import myers_device as MY

        self.my, self.orig = MY, MY.myers_hw
        self.sizes, self.largest = [], None

    def __enter__(self):
        def rec(seq, meta, qmax):
            self.sizes.append(meta.shape[1])
            if self.largest is None or \
                    meta.shape[1] > self.largest[1].shape[1]:
                self.largest = (seq, meta, qmax)
            return self.orig(seq, meta, qmax)

        self.my.myers_hw = rec
        return self

    def __exit__(self, *exc):
        self.my.myers_hw = self.orig


def check_trace(path, label):
    """The --profile trace at path parses as a Chrome trace and holds the
    card's kernels."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = {}
    for ev in events:
        if ev.get("cat") == "kernel":
            key = next((v for k, v in TRACE_NAMES.items()
                        if k in ev["name"]), "other")
            kernels[key] = kernels.get(key, 0) + 1
    print(f"options {label} --profile: {os.path.getsize(path)} bytes, "
          f"{len(events)} events; kernel events {json.dumps(kernels)}",
          flush=True)
    if not kernels:
        raise AssertionError(f"options {label}: the --profile trace holds "
                             f"no kernel event")


def myers_main_launch(dev):
    """The inputs of the largest myers_hw launch of phase 6's first run
    (ada_f2, its main path), from one untimed run through the CLI:
    --kernels myers_hw times that launch on each tree."""
    from tidehunter_tpu_torch import cli

    B = bench_mod()
    run = B.OPTION_RUNS[0][0]
    with tempfile.TemporaryDirectory() as tmp:
        path = B.write_input(run, B.cell_reads(run), tmp)
        with MyersLaunches() as rec:
            rc = cli.main([*B.option_argv(run, tmp), "--device", dev.type,
                           "-o", os.path.join(tmp, "main.out"), path])
    if rc != 0:
        raise AssertionError(f"options {run}: exit {rc}")
    return rec.largest


def phase_options(tmp, dev):
    """Each option run of evals/bench.OPTION_RUNS through the port's CLI on
    the card: reads/s, stage timers (--metrics), launches by kernel and by
    profile_dp route, hws_host; each must launch the kernels and routes of
    OPTION_NEED and none that it forbids; the msa_graph run writes a
    --profile trace, which must hold the card's kernels; then every read's
    records of every run held to the committed oracle digests
    (evals/option_digests.json, by bench's gate: the input's sha256, the
    records split by the run's -f and -u, no stray record, no read
    missing); then the first run once more under torch.profiler
    (trace_run), untimed.  Returns myers_hw's launches in the first run
    (its main path) and the inputs of that run's largest launch."""
    from tidehunter_tpu_torch import _kernels as K
    from tidehunter_tpu_torch import cli

    B = bench_mod()
    digests = B.load_digests(B.OPTION_DIGESTS)
    out, met = os.path.join(tmp, "options.out"), os.path.join(tmp,
                                                              "options.json")
    trace = os.path.join(tmp, "options_trace.json")
    pops, main, checked = {}, None, 0
    for run, pop, n, argv in B.OPTION_RUNS:
        if pop not in pops:
            pops[pop] = B.population(pop)
        reads = pops[pop][:n]
        path = B.write_input(run, reads, tmp)
        B.check_input(run, reads, digests, B.read_input(path))
        mtp, _ = B.option_params(run, tmp)
        prof = ["--profile", trace] if run == "msa_graph" else []
        K.reset_launches()
        with MyersLaunches() as rec:
            rc = cli.main([*B.option_argv(run, tmp), *prof, "--device",
                           dev.type, "-o", out, "--metrics", met, path])
            sync(dev)
        launches = {k: v for k, v in K.launches().items() if v}
        routes = dict(K.PROFILE_DP.routes)
        if rc != 0:
            raise AssertionError(f"options {run}: exit {rc}")
        with open(met) as f:
            snap = json.load(f)
        print(f"options {run} ({' '.join(argv)}): {snap['reads']} reads "
              f"({pop}) in {snap['wall_s']} s = {snap['reads_per_s']} "
              f"reads/s; records {snap['cons_records']}; launches "
              f"{json.dumps(launches)}; profile_dp by route "
              f"{json.dumps(routes)}; hws_host "
              f"{int(snap.get('hws_host', 0))}"
              f"{' (under --profile)' if prof else ''}", flush=True)
        print(f"options {run} stages: " + " ".join(
            f"{k}={v}" for k, v in sorted(snap.items())), flush=True)
        if prof:
            check_trace(trace, run)
        if rec.sizes:
            print(f"options {run} myers_hw problems a launch: {rec.sizes}",
                  flush=True)
        if main is None:
            main = (launches.get("myers_hw", 0), rec.largest)
        need, forbid, need_routes = OPTION_NEED[run]
        idle = [k for k in need if not launches.get(k)]
        idle += [f"profile_dp route {r}" for r in need_routes
                 if not routes.get(r)]
        if idle:
            raise AssertionError(f"options {run}: not launched: {idle}")
        ran = [k for k in forbid if launches.get(k)]
        if ran:
            raise AssertionError(f"options {run}: launched {ran}")
        if snap["reads"] != len(reads) or snap["cons_records"] <= 0:
            raise AssertionError(f"options {run}: {snap['cons_records']} "
                                 f"records for {snap['reads']} reads")
        t0 = time.perf_counter()
        with open(out) as f:
            text = f.read()
        k = B.check_records(run, reads, text, digests, mtp.out_fmt,
                            mtp.only_unit)
        checked += k
        print(f"options {run} digests: all {k} reads' records "
              f"({text.count(chr(10))} lines) match the oracle's digests in "
              f"{os.path.relpath(B.OPTION_DIGESTS)}; input sha256 matches "
              f"({time.perf_counter() - t0:.2f} s)", flush=True)
    print(f"options digests: {checked} reads of {len(B.OPTION_RUNS)} runs "
          f"held", flush=True)
    # the main path's run once more, untimed, under torch.profiler
    run = B.OPTION_RUNS[0][0]
    path = B.write_input(run, B.cell_reads(run), tmp)
    trace_run(lambda: cli.main([*B.option_argv(run, tmp), "--device",
                                dev.type, "-o", out, path]), dev,
              f"options {run}")
    return main


def phase_full_width(dev):
    """Band-touch regions of tests/test_msa_device.py:95-107."""
    from tidehunter_tpu_torch.ops.msa_device import DeviceMSA
    from tidehunter_tpu_torch.ops.poa_profile import banded_profile_consensus
    from tidehunter_tpu_torch.utils.metrics import METRICS

    rng = np.random.default_rng(31)
    regions = []
    for i in range(6):
        p = int(rng.integers(900, 1600))
        unit = rng.integers(0, 4, p)
        us = []
        for _ in range(4):
            u = list(np.where(rng.random(p) < 0.08,
                              rng.integers(0, 4, p), unit))
            if i == 0 and len(us) == 1:
                del u[100:420]
            us.append(np.array(u, np.uint8))
        regions.append(us)
    before = METRICS.snapshot().get("msa_full_rounds", 0)
    dm = DeviceMSA(2, 4, 4, 2, gap_open2=24, gap_ext2=1, device=dev)
    got = dm.consensus_batch(regions)
    full = METRICS.snapshot().get("msa_full_rounds", 0) - before
    for ri, (reg, g) in enumerate(zip(regions, got)):
        want = banded_profile_consensus(reg, 2, 4, 4, 2, gap_open2=24,
                                        gap_ext2=1)
        if g is None or not (np.array_equal(g[0], want[0])
                             and np.array_equal(g[1], want[1])):
            raise AssertionError(f"full-width rung: region {ri} differs")
    if full <= 0:
        raise AssertionError("the full-width rung did not run")
    print(f"full-width rung: {len(regions)} regions equal the host mirror; "
          f"{int(full)} full-width rounds", flush=True)


def seed_batch(key, dev):
    """The codes [B, L] and lengths [B] of one SEED_CASES population on
    dev: the slice's first chunk, phase 5's 12.3 kb reads, 128 reads of
    ~10.6 kb (with -H and w=5, just past one CTA's shared memory), 8 reads
    of ~70 kb (with -H, w=5 and 64-bit words, past a cluster of 8), or 8
    reads of ~40 kb (past one CTA)."""
    from tidehunter_tpu_torch.evals.synth import synth_read
    from tidehunter_tpu_torch.io.codec import encode
    from tidehunter_tpu_torch.ops.seeding_device import pad_batch

    if key == "slice":
        seqs = [r.seq for r in bench_mod().slice_reads(512)]
    elif key == "cdna":
        seqs = [r.seq for r in bench_mod().period_populations()[-1]]
    elif key == "boundary":
        rng = np.random.default_rng(46)
        seqs = [synth_read(rng, 1150, 9) for _ in range(128)]
    elif key == "past":
        rng = np.random.default_rng(47)
        seqs = [synth_read(rng, 7000, 10) for _ in range(8)]
    else:
        rng = np.random.default_rng(45)
        seqs = [synth_read(rng, 4000, 10) for _ in range(8)]
    batch, lens = pad_batch([encode(x) for x in seqs])
    return torch.as_tensor(batch, device=dev), torch.as_tensor(lens,
                                                                device=dev)


def seed_ops(bseq, lens, k, w, hpc, wide) -> float:
    """The seeding function's integer ops on these reads (SEED_OPS_*), not
    those of seed_hits' own sort network: a row of stream length s and
    g = ceil(log2 s) costs s (k key bases + a lane + two w passes + g + 1
    search steps) and s * g sort compares, over the live words only."""
    b = bseq.cpu().numpy()
    ops = 0.0
    for row, n in zip(b, lens.tolist()):
        s = (int(np.count_nonzero(row[1:n] != row[:n - 1])) + 1
             if hpc and n else n)
        g = max(0, int(max(s, 1) - 1).bit_length())
        ops += s * (SEED_OPS_KEY_BASE * k + SEED_OPS_LANE
                    + (2 * SEED_OPS_W * w if w > 1 else 0)
                    + SEED_OPS_SEARCH[wide] * (g + 1)
                    + SEED_OPS_CMP[wide] * g)
    return ops


def check_seed(checks, dev):
    """seed_hits against seed_plain (packed by pack_hits where the case
    packs) at SEED_CASES, exact; library: torch.sort over the same seed
    words, one row a read (32-bit where they pack, else 64-bit)."""
    from tidehunter_tpu_torch import _kernels as K
    from tidehunter_tpu_torch.ops import seeding_device as SD
    from tidehunter_tpu_torch.params import Params

    mtp = Params()
    batches = {}
    for label, key, k, w, hpc, packed in SEED_CASES:
        if key not in batches:
            batches[key] = seed_batch(key, dev)
        bseq, lens = batches[key]
        B, L = bseq.shape
        kw = dict(k=k, use_hpc=hpc, min_p=mtp.min_p, max_p=mtp.max_p, w=w)
        wide = not SD.packed_ok(k, L)
        pb = SD.pos_bits(L)
        if packed:
            def kern(kw=kw):
                return SD.collect_hits_packed(bseq, lens, **kw)

            def plain(kw=kw, pb=pb):
                e, p, n, fb = SD.seed_plain(bseq, lens, **kw)
                return SD.pack_hits(e, p, n, pb), n, fb
            out_bytes = B * L * 4 + B * 5
        else:
            def kern(kw=kw):
                return SD.collect_hits_batch(bseq, lens, **kw)

            def plain(kw=kw):
                return SD.seed_plain(bseq, lens, **kw)
            out_bytes = B * L * 8 + B * 5
        if key == "past" and K.host_call(
                "seed_hits_scratch_bytes", [ctypes.c_int] * 5,
                ctypes.c_longlong, B, L, int(hpc), w, int(wide)) <= 0:
            raise AssertionError(f"seed_hits {label}: not the global "
                                 f"scratch route")
        key_, pos, valid, _ = SD._keys_valid_positions(
            bseq, lens, k=k, use_hpc=hpc, w=w)
        words = (torch.where(valid, (key_ << pb) | pos, 2**31 - 1).int()
                 if not wide else
                 torch.where(valid, (key_ << 31) | pos, SD.INT64_MAX))
        checks.run("seed_hits", label, kern, plain,
                   lambda k=k, w=w, hpc=hpc, wide=wide, ob=out_bytes: (
                       seed_ops(bseq, lens, k, w, hpc, wide),
                       _nbytes(bseq, lens) + ob),
                   library_fn=lambda words=words: torch.sort(words, dim=1))


def check_chain(checks, dev):
    """chain_dp against chain_dp_plain at the main path's launch, exact:
    the slice chunk packed and seeded as offload.device_seed_chain packs
    and seeds it (k=8, w=1), its hit words decoded into [B, L] planes (L =
    the longest read, -1 past n_hits) at window = L, then at window 64;
    at each window also the row with the most hits alone (B=1, the same
    L), with its cells and scanned lanes.  The bound counts the predecessor lanes the sequential scan needs
    (chain_dp_plain's scan_lanes)."""
    from tidehunter_tpu_torch.io.codec import encode
    from tidehunter_tpu_torch.ops import chaining_device as CD
    from tidehunter_tpu_torch.ops import offload
    from tidehunter_tpu_torch.ops import seeding_device as SD
    from tidehunter_tpu_torch.params import Params

    mtp = Params()
    bseqs = [encode(r.seq) if len(r.seq) >= mtp.k else None
             for r in bench_mod().slice_reads(512)]
    L = max(len(b) for b in bseqs if b is not None)
    arr, lens, _ = offload.pack_reads(bseqs, len(bseqs), L)
    ph, n, _ = SD.collect_hits_packed(
        torch.as_tensor(arr, device=dev), torch.as_tensor(lens, device=dev),
        k=mtp.k, use_hpc=bool(mtp.hpc), min_p=mtp.min_p, max_p=mtp.max_p,
        w=mtp.w)
    pb = SD.pos_bits(L)
    ends, periods = ph >> pb, ph & ((1 << pb) - 1)
    top = int(torch.argmax(n))      # the row with the most hits
    planes = {len(ends): (ends, periods, n),
              1: (ends[top:top + 1], periods[top:top + 1], n[top:top + 1])}
    for window in CHAIN_WINDOWS:
        W = window or L
        wname = "full" if window is None else W
        # the launch, then its longest row alone (B=1, the same L and
        # window): how far one read's chain sets the launch's time
        for B, (e, p, nh) in planes.items():
            lanes = {}

            def plain(W=W, lanes=lanes, e=e, p=p, nh=nh):
                *out, lanes["n"] = CD.chain_dp_plain(e, p, nh, k=mtp.k,
                                                     window=W,
                                                     scan_lanes=True)
                return tuple(out)

            label = (f"slice chunk hits window={wname} B={B}" if B > 1 else
                     f"slice chunk's longest row window={wname} B=1")
            checks.run("chain_dp", label,
                       lambda W=W, e=e, p=p, nh=nh: CD.chain_dp_batch(
                           e, p, nh, k=mtp.k, window=W), plain,
                       lambda lanes=lanes, e=e, p=p, nh=nh, B=B: (
                           CHAIN_OPS_PER_LANE * lanes["n"]
                           + CHAIN_OPS_PER_CELL * float(nh.double().sum()),
                           _nbytes(e, p, nh) + B * L * 8 + B),
                       reps=3)
            if B == 1:
                print(f"chain_dp longest row: {int(nh[0])} cells, "
                      f"{lanes['n']} predecessor lanes scanned "
                      f"(window={wname}, L={L})", flush=True)


def phase_seed_checks(checks, dev):
    """Phase 8's kernel checks (those of checks.only with --kernels)."""
    if checks.wants("seed_hits"):
        check_seed(checks, dev)
    if checks.wants("chain_dp"):
        check_chain(checks, dev)


def phase_device_seed(tmp, dev, slice_run, periods_run):
    """The slice through the runner under each DEVICE_SEED_RUNS setting (a
    warm and a timed run): reads/s, stage timers, reroutes and launches;
    seed_hits must launch (chain_dp too with TH_DEVICE_CHAIN=1) and every
    record must equal phase 4's timed run's.  Then one run of the periods
    path with the second setting's switches, equal to phase 5's output.
    Returns each kernel's launches in its main run (seed_hits: the first
    setting's, chain_dp: the second's)."""
    from tidehunter_tpu_torch import _kernels as K
    from tidehunter_tpu_torch.engine import Engine
    from tidehunter_tpu_torch.params import Params
    from tidehunter_tpu_torch.pipeline import runner
    from tidehunter_tpu_torch.utils.metrics import METRICS

    saved = {k: os.environ.get(k) for k in DEVICE_SEED_ENV}

    def set_env(env):
        for k in DEVICE_SEED_ENV:
            os.environ.pop(k, None)
        os.environ.update(env)

    mtp = Params()
    mtp.chunk_read_n = 512
    launches = {}
    try:
        for label, env in DEVICE_SEED_RUNS:
            set_env(env)
            engine = Engine(mtp, device=dev.type)
            fa, want = slice_run
            runner.run(fa, mtp, out=io.StringIO(), process_chunk=engine)
            sync(dev)
            METRICS.reset()
            K.reset_launches()
            sink = io.StringIO()
            t0 = time.perf_counter()
            metrics = runner.run(fa, mtp, out=sink, process_chunk=engine)
            sync(dev)
            wall = time.perf_counter() - t0
            engine.close()
            got = {k: v for k, v in K.launches().items() if v}
            snap = METRICS.snapshot()
            per_chunk = snap.get("time_device_seed_s", 0) / metrics.chunks
            print(f"device seed {label}: {metrics.reads} reads in "
                  f"{wall:.3f} s = {metrics.reads / wall:.2f} reads/s; "
                  f"device_seed {per_chunk:.4f} s a chunk over "
                  f"{metrics.chunks} chunks; offload_seed_fb "
                  f"{int(snap.get('offload_seed_fb', 0))} offload_chain_fb "
                  f"{int(snap.get('offload_chain_fb', 0))}; launches "
                  f"{json.dumps(got)}", flush=True)
            print(f"device seed {label} stages: " + " ".join(
                f"{k}={v}" for k, v in sorted(snap.items())), flush=True)
            need = ["seed_hits"] + (["chain_dp"] if "TH_DEVICE_CHAIN" in env
                                    else [])
            idle = [k for k in need if not got.get(k)]
            if idle:
                raise AssertionError(f"device seed {label}: not launched: "
                                     f"{idle}")
            if sink.getvalue() != want:
                raise AssertionError(f"device seed {label}: records differ "
                                     f"from phase 4's")
            print(f"device seed {label}: all {metrics.reads} reads' records "
                  f"byte-identical with phase 4's host-seeded run, every "
                  f"read of which matches its oracle digest", flush=True)
            for k in need:
                launches.setdefault(k, got[k])
        fa, want = periods_run
        set_env(DEVICE_SEED_RUNS[1][1])
        engine = Engine(mtp, device=dev.type)
        K.reset_launches()
        sink = io.StringIO()
        t0 = time.perf_counter()
        metrics = runner.run(fa, mtp, out=sink, process_chunk=engine)
        sync(dev)
        wall = time.perf_counter() - t0
        engine.close()
        got = {k: v for k, v in K.launches().items() if v}
        if sink.getvalue() != want:
            raise AssertionError("device seed periods: records differ from "
                                 "phase 5's")
        print(f"device seed periods {DEVICE_SEED_RUNS[1][0]}: "
              f"{metrics.reads} reads in {wall:.3f} s = "
              f"{metrics.reads / wall:.2f} reads/s (one run); launches "
              f"{json.dumps(got)}; records byte-identical with phase 5's, "
              f"every read of which matches its oracle digest",
              flush=True)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return launches


class MeshCalls:
    """Records, while active, the wf_global launches of the partition
    walks' steps and the (B, n, blocks) of every row split over a mesh
    (parallel/mesh.row_blocks, which shard_rows and the device MSA call);
    the calls are unchanged.

    walk_launches: the change of wf_global's launch counter inside
    Engine._resolve_walks (one breadth-first round of walk steps), summed
    over the rounds; walks: the (LQ, LT, B) of each of those launches,
    read from the wavefront's single-block launcher on the thread inside a
    round (the walk steps of a one-card mesh are launched whole; a round
    may launch several buckets, or none when native C took every step)."""

    def __init__(self):
        import threading

        from tidehunter_tpu_torch import _kernels as K
        from tidehunter_tpu_torch import engine as E
        from tidehunter_tpu_torch.ops import wavefront as WF
        from tidehunter_tpu_torch.parallel import mesh as PM

        self.k, self.e, self.wf, self.pm = K, E, WF, PM
        self.orig_r = E.Engine._resolve_walks
        self.orig_g, self.orig_b = WF._global_one, PM.row_blocks
        self.walks, self.splits = [], []
        self.walk_launches = 0
        self.inside = threading.local()

    def __enter__(self):
        def rec_r(engine, reqs):
            before = self.k.WF_GLOBAL.launches
            self.inside.on = True
            try:
                return self.orig_r(engine, reqs)
            finally:
                self.inside.on = False
                self.walk_launches += self.k.WF_GLOBAL.launches - before

        def rec_g(q, ql, t, tl, qle, *args):
            if getattr(self.inside, "on", False) and q.shape[0]:
                self.walks.append((q.shape[1], t.shape[1], q.shape[0]))
            return self.orig_g(q, ql, t, tl, qle, *args)

        def rec_b(B, n):
            out = self.orig_b(B, n)
            self.splits.append((B, n, len(out)))
            return out

        self.e.Engine._resolve_walks = rec_r
        self.wf._global_one, self.pm.row_blocks = rec_g, rec_b
        return self

    def __exit__(self, *exc):
        self.e.Engine._resolve_walks = self.orig_r
        self.wf._global_one, self.pm.row_blocks = self.orig_g, self.orig_b

    def largest_walk(self):
        return max(self.walks, key=lambda x: (x[2], x[0], x[1]),
                   default=None)


def phase_mesh(tmp, dev, slice_run):
    """Phase 9: the slice through make_engine on a one-card mesh (MESH_RUNS:
    device seeding and device walks, every walk step on K1, the v1 route's
    device chaining, an explicit mesh of two shards of card 0), a warm and
    a timed run each, every record byte-identical with phase 4's timed
    run; then two CLI processes under --dist on the card, merged by
    tools.merge, byte-identical with one process's run.  Returns
    wf_global's launches at the walk shapes (TH_HOST_ALN_CAP=0's run)."""
    from tidehunter_tpu_torch import _kernels as K
    from tidehunter_tpu_torch import cli
    from tidehunter_tpu_torch.engine import make_engine
    from tidehunter_tpu_torch.params import Params
    from tidehunter_tpu_torch.parallel import mesh as PM
    from tidehunter_tpu_torch.pipeline import runner
    from tidehunter_tpu_torch.utils.metrics import METRICS

    fa, want = slice_run
    saved = {k: os.environ.get(k) for k in MESH_ENV}
    mtp = Params()
    mtp.chunk_read_n = 512
    walk_launches = 0
    base = None
    try:
        for label, env, two in MESH_RUNS:
            for k in MESH_ENV:
                os.environ.pop(k, None)
            os.environ.update(env)
            card = (torch.device("cuda", torch.cuda.current_device())
                    if dev.type == "cuda" else dev)
            mesh = PM.Mesh([card] * 2) if two else None
            engine = make_engine(mtp, device=dev.type, mesh=mesh)
            if engine.mesh is None or len(engine.mesh) != (2 if two else 1):
                raise AssertionError(f"mesh {label}: engine mesh "
                                     f"{engine.mesh}")
            t0 = time.perf_counter()
            runner.run(fa, mtp, out=io.StringIO(), process_chunk=engine)
            sync(dev)
            warm_s = time.perf_counter() - t0
            METRICS.reset()
            K.reset_launches()
            sink = io.StringIO()
            with MeshCalls() as calls:
                t0 = time.perf_counter()
                metrics = runner.run(fa, mtp, out=sink,
                                     process_chunk=engine)
                sync(dev)
                wall = time.perf_counter() - t0
            engine.close()
            got = {k: v for k, v in K.launches().items() if v}
            snap = METRICS.snapshot()
            print(f"mesh {label}: {metrics.reads} reads in {wall:.3f} s = "
                  f"{metrics.reads / wall:.2f} reads/s (warm run "
                  f"{warm_s:.3f} s); consensus rounds "
                  f"{int(snap.get('rounds', 0))}, walk rounds "
                  f"{int(snap.get('walk_rounds', 0))}, walk_native "
                  f"{int(snap.get('walk_native', 0))}, host_aln "
                  f"{int(snap.get('host_aln', 0))}; device_seed "
                  f"{snap.get('time_device_seed_s', 0) / metrics.chunks:.4f}"
                  f" s a chunk; launches {json.dumps(got)}; K1 walk "
                  f"launches {calls.walk_launches}, (LQ, LT, B) "
                  f"{calls.walks}", flush=True)
            print(f"mesh {label} stages: " + " ".join(
                f"{k}={v}" for k, v in sorted(snap.items())), flush=True)
            need = ["seed_hits", "wf_global", "wf_ext", "profile_dp",
                    "profile_bt"] + (["chain_dp"] if "TH_OFFLOAD_V1" in env
                                     else [])
            idle = [k for k in need if not got.get(k)]
            if idle:
                raise AssertionError(f"mesh {label}: not launched: {idle}")
            if snap.get("walk_native", 0) or not snap.get("walk_rounds"):
                raise AssertionError(f"mesh {label}: the walks did not run "
                                     f"on the device")
            if not calls.walk_launches:
                raise AssertionError(f"mesh {label}: no K1 walk launch")
            if calls.walk_launches != len(calls.walks):
                raise AssertionError(
                    f"mesh {label}: {calls.walk_launches} walk launches "
                    f"counted, {len(calls.walks)} launch shapes read")
            if not two:
                key = ("TH_HOST_ALN_CAP=0" if "TH_HOST_ALN_CAP" in env
                       else "default cap")
                if calls.largest_walk() != WALK_CASES[key]:
                    raise AssertionError(
                        f"mesh {label}: largest K1 walk launch "
                        f"{calls.largest_walk()}, phase 2 checks "
                        f"{WALK_CASES[key]}")
                if key == "TH_HOST_ALN_CAP=0":
                    walk_launches = calls.walk_launches
            if two:
                bad = [x for x in calls.splits
                       if x[1] != 2 or x[2] != min(x[0], 2)]
                if bad or not calls.splits:
                    raise AssertionError(f"mesh {label}: splits {bad}")
                fewer = [k for k in need if got[k] <= base.get(k, 0)]
                if got["seed_hits"] != 2 * metrics.chunks or fewer:
                    raise AssertionError(
                        f"mesh {label}: not launched as two blocks: "
                        f"{got} against {base}")
                print(f"mesh {label}: {len(calls.splits)} row splits, "
                      f"{sum(x[2] == 2 for x in calls.splits)} of them into "
                      f"two blocks (the rest single rows)", flush=True)
            elif base is None:
                base = got
            if sink.getvalue() != want:
                raise AssertionError(f"mesh {label}: records differ from "
                                     f"phase 4's")
            print(f"mesh {label}: all {metrics.reads} reads' records "
                  f"byte-identical with phase 4's run, every read of which "
                  f"matches its oracle digest", flush=True)
        for k in MESH_ENV:
            os.environ.pop(k, None)
        phase_dist(tmp, fa, cli, dev)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return walk_launches


def phase_dist(tmp, fa, cli, dev):
    """Two port CLI processes, --dist 127.0.0.1:PORT/2/I -f 2, on the one
    card; their shard files merged by tools.merge must equal one process's
    -f 2 run of the same reads."""
    import socket

    root = os.path.dirname(os.path.dirname(os.path.abspath(cli.__file__)))
    one = os.path.join(tmp, "one.tab")
    t0 = time.perf_counter()
    if cli.main(["--device", dev.type, "-f", "2", "-o", one, fa]) != 0:
        raise AssertionError("dist: the single-process run failed")
    one_s = time.perf_counter() - t0
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    out = os.path.join(tmp, "dist.tab")
    env = {k: v for k, v in os.environ.items() if k not in MESH_ENV}
    env.update(PYTHONPATH=root)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tidehunter_tpu_torch.cli", "--device",
         dev.type, "--dist", f"127.0.0.1:{port}/2/{i}", "-f", "2", "-o",
         out, fa], cwd=root,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for i in range(2)]
    try:
        res = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    dist_s = time.perf_counter() - t0
    for i, (p, (_, err)) in enumerate(zip(procs, res)):
        err = err.decode()
        if p.returncode != 0 or f"auto input shard {i}/2" not in err:
            raise AssertionError(f"dist rank {i}: exit {p.returncode}\n"
                                 f"{err[-3000:]}")
        line = [x for x in err.splitlines() if "reads/s" in x]
        print(f"dist rank {i}: {line[-1].split('] ', 2)[-1] if line else ''}"
              , flush=True)
    merged = subprocess.run(
        [sys.executable, "-m", "tidehunter_tpu_torch.tools.merge", "-i", fa,
         "-f", "2", *(f"{out}.shard{i}-of-2" for i in range(2))], cwd=root,
        env=env, capture_output=True, text=True, timeout=600, check=True)
    with open(one) as f:
        single = f.read()
    if merged.stdout != single or not single:
        raise AssertionError("dist: merged shards differ from the "
                             "single-process run")
    print(f"dist: two processes on one card ({dist_s:.3f} s, each from "
          f"its start to its exit) merged byte-identical with the "
          f"single-process -f 2 run ({one_s:.3f} s in this process; "
          f"{single.count(chr(10))} records)", flush=True)


# phase 10: the fuzz corpus, the soak and the accuracy protocol
# (tidehunter_tpu_torch/evals/{fuzz,soak,accuracy}.py), every record held
# to the oracle
SOAK_SEEDS = range(1000, 1030)
SOAK_READS = 12
# (a)'s engines, each run on every case: (label, environment, built by
# make_engine); the first is the one held to the oracle, the others to it
CORPUS_ENGINES = (("Engine", {}, False),
                  ("TH_HOST_ALN_CAP=0", {"TH_HOST_ALN_CAP": "0"}, False),
                  ("TH_MESH=-1", {"TH_MESH": "-1"}, True))
# kernels each of (a)'s engines must launch over the 9 cases (the adapter
# cases search on the card; under a mesh the reads are seeded there; with
# no host alignment cap every partition window is on K1)
CORPUS_NEED = {"Engine": ("profile_dp", "profile_bt", "myers_hw"),
               "TH_HOST_ALN_CAP=0": ("wf_global", "profile_dp",
                                     "profile_bt", "myers_hw"),
               "TH_MESH=-1": ("seed_hits", "profile_dp", "profile_bt",
                              "myers_hw")}
# (c): the eval's own route, then device seeding and chaining on the same
# reads (seed_hits' routes on 2-30 kb reads)
ACCURACY_RUNS = (("default", {}),
                 ("TH_DEVICE_SEED=1 TH_DEVICE_CHAIN=1",
                  {"TH_DEVICE_SEED": "1", "TH_DEVICE_CHAIN": "1"}))
ACCURACY_NEED = ("wf_global", "wf_ext", "profile_dp", "profile_bt")


class SeedRoutes:
    """Records, while active, the route of every seed_hits launch (one
    CTA, a cluster of C or the global scratch), as csrc/seed_hits.cu's
    seed_hits_route reports it; the launches are unchanged."""

    def __init__(self):
        from tidehunter_tpu_torch.ops import seeding_device as SD

        self.sd, self.orig, self.routes = SD, SD._launch, []

    def __enter__(self):
        from tidehunter_tpu_torch import _kernels as K

        def rec(bseq, length, k, use_hpc, min_p, max_p, w, packed):
            B, L = bseq.shape
            if B and L and bseq.device.type == "cuda":
                with torch.cuda.device(bseq.device):
                    C = K.host_call("seed_hits_route", [ctypes.c_int] * 4,
                                    ctypes.c_int, L, int(use_hpc), w,
                                    int(not self.sd.packed_ok(k, L)))
                if C < 0:
                    raise RuntimeError("seed_hits_route: the card's shared "
                                       "memory could not be queried")
                self.routes.append(({0: "global scratch", 1: "one CTA"}.get(
                    C, f"cluster of {C}"), B, L))
            return self.orig(bseq, length, k, use_hpc, min_p, max_p, w,
                             packed)

        self.sd._launch = rec
        return self

    def __exit__(self, *exc):
        self.sd._launch = self.orig

    def summary(self) -> str:
        by = {}
        for route, B, L in self.routes:
            n, b, lo, hi = by.get(route, (0, 0, L, L))
            by[route] = (n + 1, b + B, min(lo, L), max(hi, L))
        return "; ".join(f"{r}: {n} launches, {b} reads, L {lo}-{hi}"
                         for r, (n, b, lo, hi) in sorted(by.items()))


def route_summary(shapes) -> str:
    """profile_dp's launches by route and (T, W), K3's full-width ones
    among them, and wf_global's largest (LQ, LT) with their launches and
    largest B, from a LaunchShapes."""
    from tidehunter_tpu_torch.ops import msa_device as MD

    from tidehunter_tpu_torch.ops import wavefront as WF

    dp = {}
    for T, W, B in shapes.calls:
        key = (MD.dp_route(W), T, W)
        n, lo, hi = dp.get(key, (0, B, B))
        dp[key] = (n + 1, min(lo, B), max(hi, B))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    glob = {}
    for LQ, LT, B in shapes.glob:
        key = (WF.global_route(B, LQ, LT, sms), LQ, LT)
        n, hi = glob.get(key, (0, 0))
        glob[key] = (n + 1, max(hi, B))
    largest = sorted(glob.items(), key=lambda x: -x[0][1] * x[0][2])[:6]
    return ("profile_dp " + "; ".join(
        f"{r} T={T} W={W or 'full'}: {n} launches, B {lo}-{hi}"
        for (r, T, W), (n, lo, hi) in sorted(
            dp.items(), key=lambda x: (x[0][0], x[0][1], x[0][2] or 0)))
        + " | K3 full-width launches "
        + str(sum(n for (_, _, W), (n, *_) in dp.items() if W is None))
        + " | wf_global largest " + "; ".join(
            f"{r} ({lq},{lt}): {n} launches, B up to {hi}"
            for (r, lq, lt), (n, hi) in largest))


def _set_env(env, names):
    for k in names:
        os.environ.pop(k, None)
    os.environ.update(env)


def phase_corpus(tmp, dev):
    """Phase 10: (a) the 9 fuzz cases through Engine on the card, held to
    the oracle, then on a fresh engine under TH_HOST_ALN_CAP=0 and one
    built by make_engine under TH_MESH=-1, each equal to the first run;
    (c) the accuracy protocol at 8 reads a config through the eval's
    make_engine, every read held to its committed oracle digest, with the
    launches of each kernel route, once as the eval runs and once with
    device seeding and chaining; (b) the soak's seeds, every record held
    to the oracle.  The oracle of (a) and (b) runs over a pool of host
    processes while (a) and (c) run on the card."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from tidehunter_tpu_torch import _kernels as K
    from tidehunter_tpu_torch.engine import Engine, make_engine
    from tidehunter_tpu_torch.evals import accuracy as A
    from tidehunter_tpu_torch.evals import fuzz
    from tidehunter_tpu_torch.evals import soak as S
    from tidehunter_tpu_torch.utils.metrics import METRICS

    env_names = MESH_ENV + ("TH_MSA",)
    saved = {k: os.environ.get(k) for k in env_names}
    cases = fuzz.all_cases(tmp)
    draws = [fuzz.soak_draw(seed, SOAK_READS) for seed in SOAK_SEEDS]
    tasks = ([(r, mtp, False) for _, mtp, reads in cases for r in reads]
             + [(r, d[0], False) for d in draws for r in d[3]])
    n = max(1, min(len(tasks), (os.cpu_count() or 2) - 1))
    pool = ProcessPoolExecutor(n, mp_context=multiprocessing.get_context(
        "spawn"))
    t_oracle = time.perf_counter()
    futs = [pool.submit(_oracle_one, t) for t in tasks]
    try:
        # (c) the accuracy protocol
        digests = A.load_digests()
        configs = A.CONFIGS
        for label, env in ACCURACY_RUNS:
            _set_env(env, env_names)
            METRICS.reset()
            K.reset_launches()
            with LaunchShapes() as shapes, SeedRoutes() as seeds:
                t0 = time.perf_counter()
                n_held = A.evaluate(A.DIGEST_READS, dev.type, configs,
                                    digests=digests,
                                    sync=lambda: sync(dev))
                wall = time.perf_counter() - t0
            got = {k: v for k, v in K.launches().items() if v}
            routes = dict(K.PROFILE_DP.routes)
            snap = METRICS.snapshot()
            n_reads = A.DIGEST_READS * len(configs)
            print(f"accuracy {label}: {n_reads} reads in {wall:.3f} s; "
                  f"{n_held} reads' records match their oracle digests; "
                  f"launches {json.dumps(got)}; msa_full_rounds "
                  f"{int(snap.get('msa_full_rounds', 0))}, regions past "
                  f"the largest bucket (host rule) "
                  f"{int(snap.get('msa_host_oversize', 0))}", flush=True)
            print(f"accuracy {label} routes: {route_summary(shapes)}; "
                  f"profile_dp launches by route {json.dumps(routes)}; "
                  f"wf_global launches by route "
                  f"{json.dumps(K.WF_GLOBAL.routes)}", flush=True)
            check_band_route(shapes, routes, f"accuracy {label}")
            if seeds.routes:
                print(f"accuracy {label} seed_hits routes: "
                      f"{seeds.summary()}", flush=True)
            need = ACCURACY_NEED + (("seed_hits", "chain_dp") if env
                                    else ())
            idle = [k for k in need if not got.get(k)]
            if idle:
                raise AssertionError(f"accuracy {label}: not launched: "
                                     f"{idle}")
            if n_held != n_reads:
                raise AssertionError(f"accuracy {label}: {n_held} of "
                                     f"{n_reads} reads held to digests")

        # (a) the fuzz corpus
        first = None
        for label, env, via_make in CORPUS_ENGINES:
            _set_env(env, env_names)
            K.reset_launches()
            outs = []
            t0 = time.perf_counter()
            for _, mtp, reads in cases:
                eng = (make_engine(mtp, device=dev.type) if via_make
                       else Engine(mtp, device=dev.type))
                if via_make and (eng.mesh is None or len(eng.mesh) != 1):
                    raise AssertionError(f"fuzz {label}: engine mesh "
                                         f"{eng.mesh}")
                outs.append(serialize(reads, eng.process_chunk(reads, mtp),
                                      mtp))
                eng.close()
            sync(dev)
            wall = time.perf_counter() - t0
            got = {k: v for k, v in K.launches().items() if v}
            idle = [k for k in CORPUS_NEED[label] if not got.get(k)]
            if idle:
                raise AssertionError(f"fuzz {label}: not launched: {idle}")
            if first is None:
                first = outs
            else:
                bad = [c[0] for c, a, b in zip(cases, outs, first) if a != b]
                if bad:
                    raise AssertionError(f"fuzz {label}: records differ "
                                         f"from the first run: {bad}")
            print(f"fuzz {label}: {len(cases)} cases "
                  f"({sum(len(c[2]) for c in cases)} reads) in {wall:.3f} "
                  f"s; launches {json.dumps(got)}"
                  + ("" if outs is first else "; records byte-identical "
                     "with the first run"), flush=True)
        want, i = [], 0
        for _, _, reads in cases:
            want.append("".join(f.result() for f in futs[i:i + len(reads)]))
            i += len(reads)
        bad = [c[0] for c, a, b in zip(cases, first, want) if a != b]
        if bad:
            raise AssertionError(f"fuzz: records differ from the oracle: "
                                 f"{bad}")
        print(f"fuzz oracle: all {i} reads of the {len(cases)} cases "
              f"({sum(w.count(chr(10)) for w in want)} record lines) "
              f"byte-identical with tidehunter_core under each engine",
              flush=True)

        # (b) the soak
        soak_want = {}
        for seed, d in zip(SOAK_SEEDS, draws):
            soak_want[seed] = "".join(f.result()
                                      for f in futs[i:i + len(d[3])])
            i += len(d[3])
        print(f"oracle of (a) and (b): {len(tasks)} reads over {n} host "
              f"processes, done {time.perf_counter() - t_oracle:.1f} s "
              f"after their start", flush=True)
        _set_env({}, env_names)
        K.reset_launches()
        t0 = time.perf_counter()
        res = S.soak(SOAK_SEEDS, SOAK_READS, dev.type, want=soak_want,
                     log=lambda s: print(f"soak: {s}", flush=True))
        sync(dev)
        wall = time.perf_counter() - t0
        got = {k: v for k, v in K.launches().items() if v}
        drawn = dict(sorted(res.drawn.items()))
        print(f"soak: seeds {SOAK_SEEDS.start}-{SOAK_SEEDS.stop - 1} x "
              f"{SOAK_READS} reads ({res.runs * SOAK_READS} reads) in "
              f"{wall:.3f} s; seeds drawing each switch "
              f"{json.dumps(drawn)}; divergences {len(res.divergences)}, "
              f"crashes {len(res.crashes)}; launches {json.dumps(got)}",
              flush=True)
        if res.failures or res.runs != len(SOAK_SEEDS):
            raise AssertionError(f"soak: {res.runs} runs, divergences "
                                 f"{res.divergences}, crashes "
                                 f"{res.crashes}")
        need = (["profile_dp", "profile_bt"]
                + (["seed_hits"] if drawn.get("device seeding") else [])
                + (["chain_dp"] if drawn.get("device chaining") else []))
        idle = [k for k in need if not got.get(k)]
        if idle:
            raise AssertionError(f"soak: not launched: {idle}")
        print(f"soak oracle: all {res.runs * SOAK_READS} reads' records "
              f"byte-identical with tidehunter_core", flush=True)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
        _set_env({k: v for k, v in saved.items() if v is not None},
                 env_names)


def check_dtype_micro(checks):
    """dtype_micro's kernel against its plain version on the card, exactly
    (the float variants bit for bit), at the tool's default shape and at
    DTYPE_RAGGED for every variant, both timed; a variant's bound counts
    OPS_PER_STEP ops a 32-bit word a step (SWAR_OPS_PER_STEP an element
    for SWAR) at its pipe's rate (DTYPE_PER_CLK_PER_SM, else the int32
    rate) and the three inputs read and two outputs written once; each
    narrow variant's speedup over int32 at the tool's shape.  The summary
    keeps the int32 case."""
    from tidehunter_tpu_torch.evals import dtype_micro as DM

    def bits(ts):
        return [t.view(torch.int16 if t.dtype == torch.bfloat16
                       else torch.int32) if t.is_floating_point() else t
                for t in ts]

    ms = {}
    for B, L in (DM.SHAPE, DTYPE_RAGGED):
        for name, arrays in DM.inputs(B, L).items():
            x, y, a = DM.tensors(name, arrays, "cuda")
            ops = SWAR_OPS_PER_STEP if name == "swar" else DM.OPS_PER_STEP
            words = B * L / LANES_PER_WORD[name]
            label = f"{name} ({B},{L}) chain {DM.CHAIN}"
            checks.run("dtype_micro", label,
                       lambda: DM.step(name, x, y, a),
                       lambda: DM.step_plain(name, x, y, a),
                       lambda: (ops * DM.CHAIN * words,
                                5 * B * L * x.element_size()),
                       select=bits, rate=checks.card.rate(
                           DTYPE_PER_CLK_PER_SM.get(name,
                                                    INT32_PER_CLK_PER_SM)))
            if (B, L) == DM.SHAPE and checks.wants("dtype_micro"):
                ms[name] = checks.last_ms
    for name in ("int16", "int8", "bfloat16"):
        if name in ms:
            print(f"dtype_micro {name} speedup vs int32: "
                  f"{ms['int32'] / ms[name]:.4f}", flush=True)


def phase_evals(tmp, dev, checks):
    """Phase 11: dtype_micro's kernel checks, then every tool of EVAL_TOOLS
    by its main on the card, its output printed line by line under its
    name; a tool that exits non-zero fails the run.  Returns dtype_micro's
    launches in its own run."""
    import contextlib
    import importlib

    from tidehunter_tpu_torch import _kernels as K

    check_dtype_micro(checks)
    fq = os.path.join(tmp, "periods.fq")
    with open(fq, "w") as f:
        for pop in bench_mod().period_populations():
            for r in pop:
                f.write(f"@{r.name}\n{r.seq}\n+\n{'5' * len(r.seq)}\n")
    saved = {k: os.environ.pop(k, None) for k in MESH_ENV + ("TH_MSA",)}
    launches = None
    try:
        for name, argv in EVAL_TOOLS:
            mod = importlib.import_module(
                f"tidehunter_tpu_torch.evals.{name}")
            argv = [fq if a == "FASTQ" else a for a in argv]
            if name == "dtype_micro":
                K.DTYPE_MICRO.launches = 0
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = mod.main([*argv, "--device", "cuda"])
            wall = time.perf_counter() - t0
            if name == "dtype_micro":
                launches = K.DTYPE_MICRO.launches
            for line in out.getvalue().splitlines():
                print(f"[{name}] {line}", flush=True)
            print(f"eval tool {name} {' '.join(argv)}: exit {rc} in "
                  f"{wall:.1f} s", flush=True)
            if rc != 0:
                raise AssertionError(f"eval tool {name}: exit {rc}")
    finally:
        for k, v in saved.items():
            if v is not None:
                os.environ[k] = v
    if not launches:
        raise AssertionError("dtype_micro's run launched no kernel")
    return launches


BENCH_PHASE_REPS = 3     # phase 12's timed runs a cell
# phase 12's cells: the bench's two and the option cell of myers_hw's main
# path
BENCH_PHASE_CELLS = ("slice", "periods", "ada_f2")


def phase_bench():
    """Phase 12: the port's bench by its main on the card, BENCH_PHASE_CELLS
    at BENCH_PHASE_REPS reps, every record held to the committed digests;
    its stderr lines printed under [bench], then its JSON object on a line
    of its own.  A gate failure, a wrong count of checked records, a cell
    without its median, a missing host key or a device that is not the
    card raises."""
    import contextlib

    B = bench_mod()
    names = MESH_ENV + ("TH_MSA", "BENCH_READS", "BENCH_CHUNK", "BENCH_REPS")
    saved = {k: os.environ.pop(k, None) for k in names}
    os.environ["BENCH_REPS"] = str(BENCH_PHASE_REPS)
    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = B.main(["--device", "cuda", "--cells",
                         ",".join(BENCH_PHASE_CELLS)])
    finally:
        os.environ.pop("BENCH_REPS")
        for k, v in saved.items():
            if v is not None:
                os.environ[k] = v
    for line in err.getvalue().splitlines():
        print(f"[bench] {line}", flush=True)
    lines = out.getvalue().splitlines()
    if rc != 0 or not lines:
        raise AssertionError(f"bench: exit {rc}")
    res = json.loads(lines[-1])
    want = sum(B.OPTIONS[c][1] if c in B.OPTIONS else B.SLICE_READS
               if c == "slice" else sum(p[1] for p in B.PERIOD_POPULATIONS)
               for c in BENCH_PHASE_CELLS)
    if res["records_checked"] != want:
        raise AssertionError(f"bench: {res['records_checked']} reads "
                             f"checked, not {want}")
    medians = {"slice": res["median"], "periods": res["periods_median"],
               **{c: o["median"] for c, o in res["options"].items()}}
    if any(medians.get(c) is None for c in BENCH_PHASE_CELLS):
        raise AssertionError(f"bench: medians {medians}")
    if set(res["host"]) != {"cpu_model", "cores", "load_1m", "probe_ms"}:
        raise AssertionError(f"bench: host {res['host']}")
    if res["device"] != torch.cuda.get_device_name(0):
        raise AssertionError(f"bench: device {res['device']!r}")
    print(lines[-1], flush=True)


KERNEL_META = {
    "wf_global": ("tidehunter_tpu_torch/csrc/wavefront.cu",
                  "tidehunter_tpu/ops/wavefront.py:154"),
    # the CTA route of wf_global (launches: the periods path's, where its
    # (3072,3072) launch reaches it)
    "wf_global_cta": ("tidehunter_tpu_torch/csrc/wavefront.cu",
                      "tidehunter_tpu/ops/wavefront.py:154"),
    "wf_ext": ("tidehunter_tpu_torch/csrc/wavefront.cu",
               "tidehunter_tpu/ops/wavefront.py:333"),
    # one entry point serves both profile DP variants: the banded one
    # (launches from the slice) and the full-width one (launches: the
    # periods path's full-width rounds, one launch a round)
    "profile_dp": ("tidehunter_tpu_torch/csrc/profile_dp.cu",
                   "tidehunter_tpu/ops/msa_device.py:256"),
    "profile_dp_full": ("tidehunter_tpu_torch/csrc/profile_dp.cu",
                        "tidehunter_tpu/ops/msa_device.py:87"),
    # the band route of profile_dp (launches: the periods path's, where
    # the 4096 bucket's W=256 rounds reach it)
    "profile_dp_band": ("tidehunter_tpu_torch/csrc/profile_dp.cu",
                        "tidehunter_tpu/ops/msa_device.py:256"),
    "profile_bt": ("tidehunter_tpu_torch/csrc/profile_bt.cu",
                   "tidehunter_tpu/ops/msa_device.py:479"),
    "wf_dtype_probe": ("tidehunter_tpu_torch/csrc/wf_dtype_probe.cu",
                       "evals/wf_dtype_probe.py:111"),
    # a lax.scan, not a Pallas kernel: the hand kernel of the adapter path
    "myers_hw": ("tidehunter_tpu_torch/csrc/myers_hw.cu",
                 "tidehunter_tpu/ops/myers_jax.py:51"),
    # XLA sort dataflows and a lax.while_loop, not Pallas kernels: the
    # hand kernels of device seeding (TH_DEVICE_SEED, TH_DEVICE_CHAIN)
    "seed_hits": ("tidehunter_tpu_torch/csrc/seed_hits.cu",
                  "tidehunter_tpu/ops/seeding_jax.py:243"),
    "chain_dp": ("tidehunter_tpu_torch/csrc/chain_dp.cu",
                 "tidehunter_tpu/ops/chaining_jax.py:63"),
    # the element-type rate tool's step (phase 11)
    "dtype_micro": ("tidehunter_tpu_torch/csrc/dtype_micro.cu",
                    "evals/dtype_micro.py step (XLA-fused, not Pallas)"),
}


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--port", metavar="DIR",
                    help="import tidehunter_tpu_torch from DIR (the root of "
                         "another checkout) instead of this one, to time two "
                         "commits on one card in turns (A, B, B, A); no lanes "
                         "sweep")
    ap.add_argument("--kernels", metavar="NAMES",
                    help="comma-separated kernels: run the build and only "
                         "their checks (phase 2), then stop")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if args.port:
        sys.path.insert(0, os.path.abspath(args.port))
    from tidehunter_tpu_torch import _kernels as K
    from tidehunter_tpu_torch import native

    dev = torch.device("cuda")
    print(nvidia_smi("name,power.limit"), flush=True)
    card = Card()
    print(f"int32 rate: {INT32_PER_CLK_PER_SM} x {card.sms} SMs x "
          f"{card.clock_mhz:.0f} MHz (clocks.max.sm) = "
          f"{card.int_rate / 1e12:.3f} Tops/s; bytes at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; float32 "
          f"{card.rate(FP32_PER_CLK_PER_SM) / 1e12:.3f} T ops/s, bfloat16 "
          f"x2 {card.rate(BF16X2_PER_CLK_PER_SM) / 1e12:.3f} T ops/s",
          flush=True)
    native.get_lib()
    print(f"native host library: built from tidehunter_tpu_torch/native/ "
          f"in {native.build_seconds:.2f} s and loaded "
          f"({os.path.relpath(native.lib_path)})", flush=True)
    t0 = time.perf_counter()
    K.load()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {K.build_seconds:.1f} s)", flush=True)
    for line in K.build_log.splitlines():
        if "Used" in line or "Compiling entry" in line:
            print("ptxas: " + line.strip().removeprefix("ptxas info    : "))

    only = set(args.kernels.split(",")) if args.kernels else None
    checks = Checks(card, only)
    t0 = time.perf_counter()
    phase_kernels(checks, dev, lanes=not args.port)
    print(f"kernels: all equal their plain versions "
          f"({time.perf_counter() - t0:.1f} s; port "
          f"{os.path.dirname(os.path.abspath(K.__file__))})", flush=True)
    if only:
        if checks.wants("myers_hw"):
            myers_check(checks, MAIN_SHAPES["myers_hw"],
                        *myers_main_launch(dev))
        phase_seed_checks(checks, dev)
        if checks.wants("wf_dtype_probe"):
            phase_probe(checks, dev)
        if checks.wants("dtype_micro"):
            check_dtype_micro(checks)
        return 0
    t0 = time.perf_counter()
    launches = {"wf_dtype_probe": phase_probe(checks, dev)}
    print(f"probe: all variants equal probe_plain "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        slice_launches, slice_run = phase_slice(tmp, dev)
        launches.update(slice_launches)
        t0 = time.perf_counter()
        period_launches, periods_run = phase_periods(tmp, dev)
        launches["profile_dp_full"] = period_launches["profile_dp_full"]
        launches["profile_dp_band"] = period_launches["profile_dp_band"]
        launches["wf_global_cta"] = period_launches["wf_global_cta"]
        print(f"periods phase: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        launches["myers_hw"], largest = phase_options(tmp, dev)
        print(f"options phase: {time.perf_counter() - t0:.1f} s", flush=True)
        seq, meta, qmax = largest
        print(f"myers_hw main-path launch: B={meta.shape[1]}, longest query "
              f"{qmax} bp", flush=True)
        myers_check(checks, MAIN_SHAPES["myers_hw"], seq, meta, qmax)
        phase_full_width(dev)
        t0 = time.perf_counter()
        phase_seed_checks(checks, dev)
        launches.update(phase_device_seed(tmp, dev, slice_run, periods_run))
        print(f"device seed phase: {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        walk_launches = phase_mesh(tmp, dev, slice_run)
        checks.rows["wf_global"]["walk"]["launches"] = walk_launches
        print(f"mesh phase: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        phase_corpus(tmp, dev)
        print(f"corpus phase: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        launches["dtype_micro"] = phase_evals(tmp, dev, checks)
        print(f"evals phase: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_bench()
    print(f"bench phase: {time.perf_counter() - t0:.1f} s", flush=True)

    print(f"whole run: {time.perf_counter() - T0:.1f} s", flush=True)
    rows = []
    for name, (src, repl) in KERNEL_META.items():
        row = checks.rows[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": repl, "launches": launches[name],
                     "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                     "plain_ms": row["plain_ms"],
                     "bound_ms": row["bound_ms"],
                     "bound_by": row["bound_by"],
                     # no single PyTorch call computes an affine-gap DP
                     # wavefront, a profile-POA DP, its backtrack, a
                     # bit-parallel edit-distance search or the chain DP;
                     # seed_hits' is torch.sort over its seed words
                     "library_ms": row.get("library_ms")})
        for extra in ("variants_ms", "first_version_ms", "warp_ms",
                      "cta_ms", "strips_ms", "band_ms", "walk"):
            if extra in row:
                rows[-1][extra] = row[extra]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
