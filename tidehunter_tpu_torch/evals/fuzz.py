"""The fuzz corpus: randomized reads and parameters held to the oracle.

Every generator here draws from ``rng`` in the same order as its original
in the JAX package's tests and evals, so one seed gives the same reads and
the same ``Params`` in both packages:

- ``random_read``: tandem-ish reads of ``tests/test_fuzz.py``'s
  ``_random_read`` (kind 0: pure random; else 2-7 copies of a 30-299 bp
  unit at 0, 5 or 15% error between random flanks);
- ``adapter_read``: ``test_fuzz.py``'s ``_adapter_read`` (the adapters
  inside every unit of an R2C2-shaped read, or a single copy);
- ``soak_read`` and ``soak_draw``: the soak's generator and its per-seed
  draw of ``Params`` and the device seeding switches (``evals/soak.py``);
- ``FUZZ_CASES`` and ``ADAPTER_CASES``: the 9 (seed, format, options)
  cases of ``test_fuzz.py``, built into reads and ``Params`` by
  ``fuzz_case`` and ``adapter_case``;
- ``mutate``: the copies' noise, also the accuracy protocol's.

The contract each case is held to: the engine's serialized records are
byte-identical with those of the host oracle, ``pipeline.core.
tidehunter_core``, read by read.
"""

from __future__ import annotations

import io
import os

import numpy as np

from ..io.codec import decode
from ..io.fastx import FastxRecord
from ..io.output import write_read_output
from ..params import Params

# test_fuzz.py's test_engine_matches_oracle_fuzz: (seed, format, options)
FUZZ_CASES = [
    (1, 2, {}),
    (2, 3, {}),
    (3, 1, {"min_copy": 3}),
    (4, 2, {"only_unit": True}),
    (5, 4, {"min_frac": 0.6}),
]
FUZZ_READS = 12
# test_fuzz.py's test_engine_matches_oracle_adapter_fuzz
ADAPTER_CASES = [
    (11, 2, {}),
    (12, 3, {"only_full_length": True}),
    (13, 1, {"only_full_length": True, "single_copy": True}),
    (14, 2, {"only_longest": True}),
]
ADAPTER_READS, CONTROL_READS = 10, 4
COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}


def mutate(rng, unit: np.ndarray, err: float) -> np.ndarray:
    """Apply uniform substitution/insertion/deletion noise at rate err
    (split evenly, the reference simulator's model)."""
    out = []
    for c in unit:
        r = rng.random()
        if r < err / 3:
            continue                                  # deletion
        elif r < 2 * err / 3:
            out.append(int(rng.integers(0, 4)))       # insertion
            out.append(int(c))
        elif r < err:
            out.append(int(rng.integers(0, 4)))       # substitution
        else:
            out.append(int(c))
    return np.array(out, dtype=np.uint8)


def random_read(rng):
    kind = rng.integers(0, 4)
    if kind == 0:   # pure random (usually no TR)
        return decode(rng.integers(0, 4, int(rng.integers(50, 800))
                                   ).astype(np.uint8))
    unit_len = int(rng.integers(30, 300))
    copies = int(rng.integers(2, 8))
    err = float(rng.choice([0.0, 0.05, 0.15]))
    unit = rng.integers(0, 4, unit_len).astype(np.uint8)
    parts = [rng.integers(0, 4, int(rng.integers(0, 80))).astype(np.uint8)]
    parts += [mutate(rng, unit, err) for _ in range(copies)]
    parts.append(rng.integers(0, 4, int(rng.integers(0, 80))).astype(np.uint8))
    return decode(np.concatenate(parts))


def soak_read(rng):
    """The soak's read: random_read's shapes widened (units of 30-399 bp,
    2-8 copies, up to 15% error), and kind 4 adds a homopolymer flank,
    which stresses HPC seeding."""
    kind = rng.integers(0, 5)
    if kind == 0:   # pure random (usually no TR)
        return decode(rng.integers(0, 4, int(rng.integers(50, 800))
                                   ).astype(np.uint8))
    unit_len = int(rng.integers(30, 400))
    copies = int(rng.integers(2, 9))
    err = float(rng.choice([0.0, 0.05, 0.1, 0.15]))
    unit = rng.integers(0, 4, unit_len).astype(np.uint8)
    parts = [rng.integers(0, 4, int(rng.integers(0, 100))).astype(np.uint8)]
    parts += [mutate(rng, unit, err) for _ in range(copies)]
    if kind == 4:
        parts.append(np.repeat(rng.integers(0, 4), int(rng.integers(5, 120)))
                     .astype(np.uint8))
    parts.append(rng.integers(0, 4, int(rng.integers(0, 100))).astype(np.uint8))
    return decode(np.concatenate(parts))


def adapter_read(rng, five, three_rc, tandem: bool):
    """Read whose repeat unit (or single copy, tandem=False) embeds the
    adapters: the R2C2 shape the full-length logic targets."""
    def _mut(s):
        out = []
        for ch in s:
            r = rng.random()
            if r < 0.02:
                continue
            if r < 0.04:
                out.append("ACGT"[rng.integers(0, 4)])
            out.append(ch)
        return "".join(out)

    insert = decode(rng.integers(0, 4, int(rng.integers(60, 200))
                                 ).astype(np.uint8))
    unit = five + insert + three_rc
    copies = int(rng.integers(3, 6)) if tandem else 1
    flank = decode(rng.integers(0, 4, int(rng.integers(10, 60))
                                ).astype(np.uint8))
    body = "".join(_mut(unit) for _ in range(copies))
    return flank + body + flank[::-1]


def serialize(reads, results, mtp) -> str:
    buf = io.StringIO()
    for rec, res in zip(reads, results):
        write_read_output(buf, rec.name, rec.seq, res, mtp)
    return buf.getvalue()


def fuzz_case(seed, fmt, extra, n_reads=FUZZ_READS):
    """(Params, reads) of one FUZZ_CASES case."""
    rng = np.random.default_rng(seed)
    mtp = Params()
    mtp.out_fmt = fmt
    for k, v in extra.items():
        setattr(mtp, k, v)
    reads = [FastxRecord(name=f"f{i}", comment="", seq=random_read(rng))
             for i in range(n_reads)]
    return mtp, reads


def adapter_case(seed, fmt, extra, adapter_dir, n_reads=ADAPTER_READS,
                 n_controls=CONTROL_READS):
    """(Params, reads) of one ADAPTER_CASES case: the adapters are written
    to adapter_dir as 5p.fa and 3p.fa and loaded; n_reads adapter reads
    (every other one a single copy under single_copy), then n_controls
    adapter-free controls, on which full-length must not fire."""
    from ..pipeline.runner import load_adapters

    rng = np.random.default_rng(seed)
    five = decode(rng.integers(0, 4, 24).astype(np.uint8))
    three = decode(rng.integers(0, 4, 22).astype(np.uint8))
    three_rc = "".join(COMP[c] for c in reversed(three))
    five_fn = os.path.join(adapter_dir, "5p.fa")
    three_fn = os.path.join(adapter_dir, "3p.fa")
    with open(five_fn, "w") as f:
        f.write(f">5p\n{five}\n")
    with open(three_fn, "w") as f:
        f.write(f">3p\n{three}\n")
    mtp = Params()
    mtp.out_fmt = fmt
    mtp.five_fn, mtp.three_fn = five_fn, three_fn
    for k, v in extra.items():
        setattr(mtp, k, v)
    load_adapters(mtp)
    reads = [
        FastxRecord(name=f"a{i}", comment="",
                    seq=adapter_read(rng, five, three_rc,
                                     tandem=not (mtp.single_copy and i % 2)))
        for i in range(n_reads)
    ] + [FastxRecord(name=f"c{i}", comment="", seq=random_read(rng))
         for i in range(n_controls)]
    return mtp, reads


def all_cases(adapter_dir):
    """The 9 cases as (label, Params, reads); each adapter case writes its
    adapters to a directory of its own under adapter_dir."""
    out = []
    for seed, fmt, extra in FUZZ_CASES:
        out.append((f"fuzz seed={seed} -f {fmt} {extra}",
                    *fuzz_case(seed, fmt, extra)))
    for seed, fmt, extra in ADAPTER_CASES:
        d = os.path.join(adapter_dir, f"adapters_{seed}")
        os.makedirs(d, exist_ok=True)
        out.append((f"adapters seed={seed} -f {fmt} {extra}",
                     *adapter_case(seed, fmt, extra, d)))
    return out


def soak_draw(seed, n_reads=12):
    """The soak's draw for one seed: (Params, device seeding, device
    chaining, reads).  Format, minimizer window, -H, min_copy, only_unit,
    min_frac, only_longest, min_len and --polish are drawn first, then the
    switches (TH_DEVICE_SEED, and TH_DEVICE_CHAIN only with it), then the
    reads, named s{seed}_{i}."""
    rng = np.random.default_rng(seed)
    mtp = Params()
    mtp.out_fmt = int(rng.choice([1, 2, 3, 4]))
    mtp.w = int(rng.choice([1, 1, 1, 3, 5]))
    mtp.hpc = int(rng.choice([0, 0, 1]))
    mtp.min_copy = int(rng.choice([2, 2, 3]))
    mtp.only_unit = bool(rng.choice([False, False, True]))
    if rng.random() < 0.3:
        mtp.min_frac = 0.6
    if rng.random() < 0.2:
        mtp.only_longest = True
    if rng.random() < 0.2:
        mtp.min_len = int(rng.choice([50, 100]))
    mtp.polish = int(rng.choice([0, 0, 1]))
    dev_seed = bool(rng.choice([False, True]))
    dev_chain = bool(dev_seed and rng.choice([False, True]))
    reads = [FastxRecord(name=f"s{seed}_{i}", comment="", seq=soak_read(rng))
             for i in range(n_reads)]
    return mtp, dev_seed, dev_chain, reads
