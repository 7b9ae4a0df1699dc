"""The option runs of evals/bench.OPTION_RUNS whose first 4 reads take
longest through the port's CLI on the CPU (the plain profile DP and
backtrack of --polish 1, the non-default scores and seeding on the slice,
and -f 3 -l on the periods FASTQ), held by the bench's gate as in
test_torch_option_cli.py.
Tolerance: exact (sha256 of each read's records).
"""

import pytest
import torch
from test_torch_option_cli import check_first_reads

from tidehunter_tpu_torch.evals import bench as B

torch.set_num_threads(1)

RUNS = ("polish1", "scoring", "seeding", "fq_f3_l")


@pytest.fixture(scope="module")
def digests():
    return B.load_digests(B.OPTION_DIGESTS)


def test_the_two_files_cover_every_run():
    from test_torch_option_cli import RUNS as OTHERS

    assert sorted(RUNS + OTHERS) == sorted(B.OPTIONS)


@pytest.mark.parametrize("run", RUNS)
def test_first_reads_through_the_cli_pass_the_gate(run, tmp_path, digests):
    check_first_reads(run, str(tmp_path), digests)
