"""Library API of the PyTorch port: the JAX package's ``Detector`` with
the port's engine behind it.

    from tidehunter_tpu_torch import Detector

    with Detector(device="cuda", k=8) as det:
        results = det.detect(seqs)
        det.run_file("reads.fa", out=open("cons.fa", "w"))

``device``: "cuda" (hand-written kernels on the card), "cpu" (their plain
PyTorch versions) or "off" (the sequential host oracle).  The engine is
built on first use.
"""

from __future__ import annotations

from typing import Iterable, List

from tidehunter_tpu import api as _api
from tidehunter_tpu.io.output import TandemResult

from .engine import Engine

DEVICES = ("cuda", "cpu", "off")


class Detector(_api.Detector):
    def __init__(self, device: str = "cuda", **params):
        if device not in DEVICES:
            raise ValueError(f"device must be one of {DEVICES}")
        super().__init__(device="off", **params)
        self.device = device

    def _process_chunk(self):
        if self.device == "off":
            return None
        if self._engine is None:
            self._engine = Engine(self.params, device=self.device)
        return self._engine


def detect(seqs: Iterable, device: str = "cuda",
           **params) -> List[TandemResult]:
    """One-shot convenience wrapper around Detector.detect."""
    with Detector(device=device, **params) as det:
        return det.detect(seqs)
