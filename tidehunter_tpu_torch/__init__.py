"""PyTorch/CUDA port of tidehunter_tpu's default consensus path.

The framework-free layers (params, io, pipeline generators, native C host
kernels, NumPy oracles) are imported from ``tidehunter_tpu``; this package
adds the device layers: the wavefront alignment and the profile-POA MSA,
each backed by a hand-written CUDA kernel (``csrc/``) on a CUDA device and
by a plain PyTorch version on the CPU.  It never imports JAX.

    python -m tidehunter_tpu_torch.cli reads.fa --device cuda

    from tidehunter_tpu_torch import Detector
    with Detector(device="cuda") as det:
        results = det.detect(seqs)
"""

from tidehunter_tpu.version import __version__


def __getattr__(name):
    if name in ("Detector", "detect"):
        from . import api

        return getattr(api, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["__version__", "Detector", "detect"]
