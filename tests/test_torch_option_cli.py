"""The option runs of the port's bench (evals/bench.OPTION_RUNS) through
the port's CLI on the CPU, held by the bench's gate: the first 4 reads of
each run (its population's input file, FASTA or gzipped FASTQ, and its
adapter files) through cli.main([...argv, "--device", "cpu"]), which
runs the kernels' plain versions, every read's records equal to its
committed oracle digest (evals/option_digests.json) once split by the
run's -f and -u; a digest of a tab or -u record changed in a copy fails
the gate.  The runs whose plain versions take longest on the CPU (the
consensus runs on the slice and fq_f3_l) are in
test_torch_option_cli_consensus.py.
Tolerance: exact (sha256 of each read's records).
"""

import json
import os

import pytest
import torch

from tidehunter_tpu_torch import cli
from tidehunter_tpu_torch.evals import bench as B

torch.set_num_threads(1)

FIRST = 4
RUNS = ("ada_f2", "ada_F", "ada_sF", "ada_a", "msa_graph", "unit_f2",
        "fq_f4_filt")


@pytest.fixture(scope="module")
def digests():
    return B.load_digests(B.OPTION_DIGESTS)


def check_first_reads(run, tmp, digests):
    """The run's first FIRST reads through the CLI on the CPU, held by the
    gate; a tampered digest of a read with records fails it where the run
    writes tab lines or units."""
    th_msa = os.environ.get("TH_MSA")
    reads = B.cell_reads(run, FIRST)
    path = B.write_input(run, reads, tmp)
    out = os.path.join(tmp, f"{run}.out")
    assert cli.main([*B.option_argv(run, tmp), "--device", "cpu", "-o", out,
                     path]) == 0
    assert os.environ.get("TH_MSA") == th_msa
    with open(out) as f:
        text = f.read()
    mtp, _ = B.option_params(run, tmp)
    assert B.check_records(run, reads, text, digests, mtp.out_fmt,
                           mtp.only_unit) == FIRST
    got = B.records_by_read(text, mtp.out_fmt, mtp.only_unit)
    assert got, f"{run}: no records in its first {FIRST} reads"
    if mtp.out_fmt in (2, 4) or mtp.only_unit:
        i = next(k for k, r in enumerate(reads) if r.name in got)
        bad = json.loads(json.dumps(digests))
        d = bad["cells"][run]["digests"]
        d[i] = ("0" if d[i][0] != "0" else "1") + d[i][1:]
        with pytest.raises(B.GateError, match=f"'{reads[i].name}'"):
            B.check_records(run, reads, text, bad, mtp.out_fmt,
                            mtp.only_unit)


@pytest.mark.parametrize("run", RUNS)
def test_first_reads_through_the_cli_pass_the_gate(run, tmp_path, digests):
    check_first_reads(run, str(tmp_path), digests)
