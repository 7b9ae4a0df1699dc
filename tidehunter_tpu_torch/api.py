"""Library API of the PyTorch port: the pipeline the CLI drives, as plain
Python calls (the JAX package's ``api.Detector``, with the port's engine
behind it).

    from tidehunter_tpu_torch import Detector

    with Detector(device="cuda", k=8) as det:
        results = det.detect(seqs)
        det.run_file("reads.fa", out=open("cons.fa", "w"))

``device``: "cuda" (hand-written kernels on the card), "cpu" (their plain
PyTorch versions) or "off" (the sequential host oracle).  The engine is
built on first use.  Every option of ``Params`` runs through it, the
adapters (``five_fn``/``three_fn`` with ``only_full_length`` and
``single_copy``) and ``polish`` included.

Results are ``TandemResult`` objects (one per input read, input order),
each holding ``.records`` — a list of ``ConsRecord`` with the same fields
the CLI serializes.
"""

from __future__ import annotations

import dataclasses
from typing import IO, Iterable, List, Optional, Union

from .io.fastx import FastxRecord
from .io.output import TandemResult
from .params import Params
from .pipeline import runner
from .pipeline.core import tidehunter_core

DEVICES = ("cuda", "cpu", "off")

SeqLike = Union[str, FastxRecord, tuple]

_PARAM_FIELDS = {f.name for f in dataclasses.fields(Params)}


def _make_params(overrides: dict) -> Params:
    unknown = set(overrides) - _PARAM_FIELDS
    if unknown:
        raise TypeError(
            f"unknown parameter(s): {sorted(unknown)}; "
            f"valid names are the fields of tidehunter_tpu_torch.params.Params"
        )
    return dataclasses.replace(Params(), **overrides)


def _as_record(i: int, s: SeqLike) -> FastxRecord:
    if isinstance(s, FastxRecord):
        return s
    if isinstance(s, tuple):
        name, seq = s
        return FastxRecord(name=str(name), comment="", seq=seq)
    return FastxRecord(name=f"read_{i}", comment="", seq=str(s))


class Detector:
    """Reusable detection pipeline with an optional device engine.

    Keyword arguments are ``Params`` field overrides (k, w, hpc, min_copy,
    max_div, min_p, max_p, min_cov/min_frac, POA scores, out_fmt, min_len,
    only_* flags, ...); defaults match the reference CLI defaults
    (reference src/tidehunter.h:9-41).
    """

    def __init__(self, device: str = "cuda", **params):
        if device not in DEVICES:
            raise ValueError(f"device must be one of {DEVICES}")
        self.params = _make_params(params)
        self.device = device
        self._engine = None
        self._adapters_loaded = False

    # -- internals ---------------------------------------------------
    def _ensure_adapters(self) -> None:
        if not self._adapters_loaded:
            runner.load_adapters(self.params)
            self._adapters_loaded = True

    def _process_chunk(self):
        if self.device == "off":
            return None  # runner falls back to the sequential host oracle
        if self._engine is None:
            from .engine import Engine

            self._engine = Engine(self.params, device=self.device)
        return self._engine

    # -- API ----------------------------------------------------------
    def detect(self, seqs: Iterable[SeqLike]) -> List[TandemResult]:
        """Detect tandem repeats in in-memory sequences.

        ``seqs``: strings, (name, seq) tuples, or FastxRecords. Returns
        one TandemResult per input, in input order.
        """
        self._ensure_adapters()
        records = [_as_record(i, s) for i, s in enumerate(seqs)]
        engine = self._process_chunk()
        mtp = self.params
        results: List[TandemResult] = []
        if engine is None:
            for rec in records:
                results.append(tidehunter_core(rec.seq, mtp))
            return results
        n = max(1, mtp.chunk_read_n)
        for i in range(0, len(records), n):
            results.extend(engine(records[i : i + n], mtp))
        return results

    def run_file(
        self,
        read_fn: str,
        out: Optional[IO[str]] = None,
        resume_cursor: Optional[str] = None,
        shard: Optional[tuple] = None,
    ) -> runner.RunMetrics:
        """Stream a FASTA/FASTQ[.gz] file and serialize records to ``out``
        (default stdout) in the configured ``out_fmt`` — the CLI's engine
        room as a call. Returns RunMetrics (reads, chunks, cons_records)."""
        return runner.run(
            read_fn,
            self.params,
            out=out,
            resume_cursor=resume_cursor,
            process_chunk=self._process_chunk(),
            shard=shard,
        )

    def close(self) -> None:
        if self._engine is not None:
            self._engine.close()
            self._engine = None

    def __enter__(self) -> "Detector":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def detect(seqs: Iterable[SeqLike], device: str = "cuda",
           **params) -> List[TandemResult]:
    """One-shot convenience wrapper around Detector.detect."""
    with Detector(device=device, **params) as det:
        return det.detect(seqs)
