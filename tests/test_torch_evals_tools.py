"""The port's measurement tools (tidehunter_tpu_torch/evals/: host_floor,
seed_chain_micro, offload_micro2, offload_micro, msa_micro, dtype_micro,
testfq_stages, mesh_scaling, tunnel_micro) on the CPU, against the JAX
package's tools of the same names (evals/*.py) and the port's production
calls.

* host_floor: the port's floor (instant aligner and MSA on
  ``Engine(device="cpu")``) and the JAX floor, set up as
  ``evals/host_floor.py:main`` does from that module's own classes, write
  byte-identical records on 48 synth_read reads (seed 42, chunks of 64).
* seed_chain_micro / offload_micro2: the staged hits and chains equal
  ``Engine._device_seed``'s (v1 route) and
  ``device_seed_chain(chain_mode="device")``'s on 16 reads, exactly (the
  tools' own checks, which exit 1 on a difference).
* offload_micro: 0 reads whose device-route chains differ from the host's.
* msa_micro: ``make_regions`` equals the JAX tool's array for array (seed
  42, 8 regions), and one ``round`` equals its steps run apart.
* dtype_micro: the port draws the JAX tool's inputs (its main run with a
  recording timer), value for value at (512, 1024) and of the same element
  types; on their first (8, 64) block the plain version equals the JAX
  tool's own jitted step (CHAIN = 64) on JAX's CPU backend, exactly at
  every type (bfloat16 too: every value is an integer below 256, which
  bfloat16 holds exactly, so no rounding can differ).
* testfq_stages runs on a small FASTQ and prints one line a rep;
  mesh_scaling over n = 1, 2 at 4 reads a device exits 0 with equal
  records; tunnel_micro runs at 1 MB.
* Every tool raises on ``--device cuda`` without a card.
Tolerance: exact everywhere.
"""

import contextlib
import io
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from tidehunter_tpu_torch.evals import dtype_micro as DM
from tidehunter_tpu_torch.evals import host_floor as HF
from tidehunter_tpu_torch.evals import mesh_scaling as MS
from tidehunter_tpu_torch.evals import msa_micro as MM
from tidehunter_tpu_torch.evals import offload_micro as OM
from tidehunter_tpu_torch.evals import offload_micro2 as OM2
from tidehunter_tpu_torch.evals import seed_chain_micro as SCM
from tidehunter_tpu_torch.evals import testfq_stages as TQ
from tidehunter_tpu_torch.evals import tunnel_micro as TU
from tidehunter_tpu_torch.evals.synth import synth_read

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

torch.set_num_threads(1)

TOOLS = {"host_floor": HF, "seed_chain_micro": SCM, "offload_micro": OM,
         "offload_micro2": OM2, "msa_micro": MM, "tunnel_micro": TU,
         "dtype_micro": DM, "testfq_stages": TQ, "mesh_scaling": MS}


def run_main(mod, argv):
    """(exit code, standard output) of a tool's main."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = mod.main(argv)
    return rc, out.getvalue()


@pytest.fixture(autouse=True)
def no_route_env(monkeypatch):
    for k in ("TH_DEVICE_SEED", "TH_DEVICE_CHAIN", "TH_OFFLOAD_V1",
              "TH_MESH", "TH_MSA", "TH_HOST_ALN_CAP", "TH_HOST_WALK"):
        monkeypatch.delenv(k, raising=False)


def test_host_floor_records_match_jax_floor():
    from evals import host_floor as J
    from tidehunter_tpu import engine as E
    from tidehunter_tpu.params import Params
    from tidehunter_tpu.pipeline import runner

    _, _, text, _ = HF.run_floor(48, "cpu")
    mtp = Params()
    mtp.chunk_read_n = max(64, 48 // 2)
    engine = E.Engine(mtp, platform="cpu")
    engine.aligner = J.InstantAligner()
    engine._device_msa = J.InstantMSA()
    engine.msa_mode = "profile"
    engine._resolve_msa = (
        lambda regions: engine._device_msa.consensus_batch(regions))
    with tempfile.TemporaryDirectory() as tmp:
        fa = os.path.join(tmp, "reads.fa")
        HF.write_reads(fa, 48)
        want = io.StringIO()
        runner.run(fa, mtp, out=want, process_chunk=engine)
    assert text and text == want.getvalue()
    assert text.count(">r2c2_") >= 48


@pytest.mark.parametrize("mod,check", [
    (SCM, "Engine._device_seed (v1 route): 0/16 reads differ"),
    (OM2, "device_seed_chain(chain_mode='device'): 0/16 reads differ")],
    ids=["seed_chain_micro", "offload_micro2"])
def test_staged_seed_and_chain_equal_the_route(mod, check):
    rc, out = run_main(mod, ["16", "--device", "cpu", "--reps", "1"])
    assert rc == 0, out
    assert check in out
    assert "chain fallback rows" in out


def test_offload_micro_chains_match_host():
    rc, out = run_main(OM, ["6", "--device", "cpu"])
    assert rc == 0, out
    assert "chain mismatches vs host: 0/6" in out


def test_msa_micro_regions_match_jax_tool():
    from evals import msa_micro as J

    got, want = MM.make_regions(8), J.make_regions(8)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert len(g) == len(w) == 9
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_msa_micro_round_equals_its_steps():
    dev = torch.device("cpu")
    msa = MM.make_msa(dev)
    regions = MM.make_regions(8)
    _, _, _, T, W = MM.shape_of(msa, regions)
    assert (T, W) == (640, 128)
    state, units, ulen, nunits = MM.batch_inputs(msa, regions, T, dev)
    unit, qlen, active = MM.gather(units, ulen, nunits, MM.UNIT_K)
    assert MM.round_mismatch(msa, state, unit, qlen, active, T, W) == []


@pytest.fixture(scope="module")
def jax_dtype_runs():
    """{variant: (the JAX tool's jitted step, its inputs)}, recorded by
    running evals/dtype_micro.py's main with its timer replaced by one
    that keeps what it is handed and runs nothing."""
    from evals import dtype_micro as J

    runs = []

    def record(fn, args, n_iter=50):
        runs.append((fn, args))
        return 1.0

    saved, J._bench = J._bench, record
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            assert J.main() == 0
    finally:
        J._bench = saved
    assert len(runs) == len(DM.VARIANTS)
    return dict(zip(DM.VARIANTS, runs))


@pytest.mark.parametrize("name", list(DM.VARIANTS))
def test_dtype_micro_plain_equals_jax_step(name, jax_dtype_runs):
    """The port's inputs are the JAX tool's draws at its full shape, value
    for value; its plain steps equal the JAX tool's own jitted step on
    their first (8, 64) block."""
    fn, want_in = jax_dtype_runs[name]
    got_in = DM.inputs(*DM.SHAPE)[name]
    for g, w in zip(DM.tensors(name, got_in, "cpu"), want_in):
        w = np.asarray(w)
        assert g.shape == w.shape == DM.SHAPE
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
        # compare as int64: every value is an integer (SWAR words too)
        assert np.array_equal(g.to(torch.int64).numpy(), w.astype(np.int64))
    block = (slice(0, 8), slice(0, 64))
    got = DM.step(name, *(t[block] for t in DM.tensors(name, got_in,
                                                         "cpu")))
    want = fn(*(w[block] for w in want_in))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape == (8, 64)
        assert np.array_equal(g.to(torch.int64).numpy(), w.astype(np.int64))


def test_testfq_stages_prints_a_line_a_rep(tmp_path):
    rng = np.random.default_rng(5)
    fq = tmp_path / "reads.fq"
    with open(fq, "w") as f:
        for i in range(6):
            s = synth_read(rng, 120, 5, 0.05, 30)
            f.write(f"@q{i}\n{s}\n+\n{'5' * len(s)}\n")
    res = subprocess.run(
        [sys.executable, "-m", "tidehunter_tpu_torch.evals.testfq_stages",
         str(fq), "2", "--device", "cpu"], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    reps = [ln for ln in res.stdout.splitlines() if ln.startswith("rep")]
    assert [ln.split(":")[0] for ln in reps] == ["rep0", "rep1"]
    assert all("reads/s" in ln and "consensus=" in ln for ln in reps)


def test_mesh_scaling_holds_records_on_cpu():
    rc, out = run_main(MS, ["--device", "cpu", "--sizes", "1,2",
                            "--reads-per-device", "4"])
    assert rc == 0, out
    assert "byte-identical at every size" in out
    assert '"n": 2, "reads": 8' in out


def test_tunnel_micro_runs_on_cpu():
    rc, out = run_main(TU, ["--device", "cpu", "--max-mb", "1"])
    assert rc == 0
    assert "push 1MB uint8 flat" in out and "pull 1MB int32 flat" in out


@pytest.mark.parametrize("name", list(TOOLS))
def test_tool_needs_a_card_for_cuda(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        TOOLS[name].main(["--device", "cuda"])
