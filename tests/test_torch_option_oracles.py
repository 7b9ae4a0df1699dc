"""The committed oracle digests of the option runs
(tidehunter_tpu_torch/evals/option_digests.json) re-derived on the CPU.

* For one sampled read of every run, the committed digest equals the
  port's pipeline.core.tidehunter_core and the JAX package's, each under
  its own cli.parse_args of the run's argv and its own load_adapters
  (TH_MSA=graph for msa_graph), each serialized by its own writer.
* Each run new to the gate changes records: its digests differ from
  default flags in the same format on at least one read (ada_a against
  ada_f2's digests, scoring and seeding against the slice's committed
  default digests, over every read; unit_f2, fq_f3_l and fq_f4_filt on
  their sampled read against the port's oracle under default flags).
Tolerance: exact (sha256 of each read's records).
"""

import io

import pytest
import torch

from tidehunter_tpu import cli as jax_cli
from tidehunter_tpu.io.output import write_read_output as jax_write
from tidehunter_tpu.pipeline.core import tidehunter_core as jax_core
from tidehunter_tpu.pipeline.runner import load_adapters as jax_adapters
from tidehunter_tpu_torch import cli
from tidehunter_tpu_torch.evals import bench as B
from tidehunter_tpu_torch.evals.fuzz import serialize
from tidehunter_tpu_torch.params import Params
from tidehunter_tpu_torch.pipeline.core import tidehunter_core
from tidehunter_tpu_torch.pipeline.runner import load_adapters

torch.set_num_threads(1)

# the read of each run re-derived: one with records, cheap where the run
# allows (ada_sF's read 3 is a single copy, which -s resolves)
SAMPLE = {"ada_f2": 0, "ada_F": 1, "ada_sF": 3, "polish1": 0,
          "msa_graph": 1, "unit_f2": 0, "scoring": 0, "seeding": 3,
          "ada_a": None, "fq_f3_l": 1, "fq_f4_filt": 1}


@pytest.fixture(scope="module")
def digests():
    return B.load_digests(B.OPTION_DIGESTS)


@pytest.fixture(scope="module")
def adapter_dir(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("adapters"))
    B.write_adapters(tmp)
    return tmp


@pytest.fixture
def graph_env(monkeypatch):
    def set_for(run):
        if run == "msa_graph":
            monkeypatch.setenv("TH_MSA", "graph")
        else:
            monkeypatch.delenv("TH_MSA", raising=False)
    return set_for


def _sample(run, digests):
    """The sampled read's index: ada_a's first read whose records differ
    from ada_f2's (the same reads at the default -a)."""
    if SAMPLE[run] is not None:
        return SAMPLE[run]
    dig = digests["cells"]
    return next(i for i, (a, b) in enumerate(zip(dig["ada_a"]["digests"],
                                                 dig["ada_f2"]["digests"]))
                if a != b)


def _port_digest(rec, mtp):
    return B.sha256(serialize([rec], [tidehunter_core(rec.seq, mtp)], mtp))


@pytest.mark.parametrize("run", [r[0] for r in B.OPTION_RUNS])
def test_sampled_digest_by_both_oracles(run, digests, adapter_dir,
                                        graph_env):
    i = _sample(run, digests)
    rec = B.cell_reads(run, i + 1)[i]
    argv = [*B.option_argv(run, adapter_dir), "reads.fa"]
    mtp = cli.parse_args(argv)[0]
    load_adapters(mtp)
    jmtp = jax_cli.parse_args(argv)[0]
    jax_adapters(jmtp)
    graph_env(run)
    port = _port_digest(rec, mtp)
    buf = io.StringIO()
    jax_write(buf, rec.name, rec.seq, jax_core(rec.seq, jmtp), jmtp)
    assert port == B.sha256(buf.getvalue()) == \
        digests["cells"][run]["digests"][i]
    assert port != B.sha256("")       # the read has records


def _differing(a, b):
    return sum(x != y for x, y in zip(a, b))


@pytest.mark.parametrize("run", ["unit_f2", "scoring", "seeding", "ada_a",
                                 "fq_f3_l", "fq_f4_filt"])
def test_new_run_changes_records(run, digests, adapter_dir, graph_env):
    graph_env(run)
    want = digests["cells"][run]["digests"]
    if run in ("scoring", "seeding", "ada_a"):
        # the same reads under default flags in the same format: ada_f2's
        # digests, and the slice's committed default (FASTA) digests
        dflt = (digests["cells"]["ada_f2"]["digests"] if run == "ada_a"
                else B.load_digests()["cells"]["slice"]["digests"])
        assert len(want) == 512
        assert _differing(want, dflt) > 0
        return
    i = SAMPLE[run]
    rec = B.cell_reads(run, i + 1)[i]
    mtp = cli.parse_args([*B.option_argv(run, adapter_dir), "reads.fa"])[0]
    dflt = Params()
    dflt.out_fmt = mtp.out_fmt
    assert want[i] != _port_digest(rec, dflt)
