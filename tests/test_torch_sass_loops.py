"""tidehunter_tpu_torch.evals.sass_loops on disassembly text: the loops it
finds and what it counts in them, in both forms cuobjdump gives a branch
target (a label, an address).  No toolkit is needed: the text is written
here."""

import pytest

from tidehunter_tpu_torch.evals import sass_loops as SL

# a kernel with a row loop (a barrier, two shuffles, a shared load and
# store, a byte store) around an inner wait loop, then a short exit loop
LABELS = """
        code for sm_90a
                Function : _Z4bandPii
        .headerflags    @"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
.L_x_2:
        /*0010*/                   SHFL.DOWN PT, R8, R12, 0x1, 0x1f ;
        /*0020*/                   SHFL.UP PT, R4, R4, 0x1, RZ ;
.L_x_1:
        /*0030*/                   SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [R3+URZ], RZ ;
        /*0040*/               @!P0 BRA `(.L_x_1) ;
        /*0050*/                   LDS R25, [R4] ;
        /*0060*/                   IMAD.IADD R6, R5, 0x1, -R20 ;
        /*0070*/                   STG.E.U8 desc[UR42][R2.64], R19 ;
        /*0080*/              @!P4 STS.128 [R22], R8 ;
        /*0090*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*00a0*/               @!P2 BRA `(.L_x_2) ;
        /*00b0*/                   EXIT ;
.L_x_3:
        /*00c0*/                   BRA `(.L_x_3);
"""
ADDRESSES = LABELS.replace("`(.L_x_1)", "0x30").replace(
    "`(.L_x_2)", "0x10").replace("`(.L_x_3)", "0xc0")


@pytest.mark.parametrize("text", [LABELS, ADDRESSES],
                         ids=["labels", "addresses"])
def test_loops_and_their_counts(text):
    fns = SL.functions(text)
    assert list(fns) == ["_Z4bandPii"]
    assert len(fns["_Z4bandPii"]) == 13
    loops = {(r["from"], r["to"]): r for r in SL.loops(fns["_Z4bandPii"])}
    # the spin on the barrier, the row loop around it; a branch to itself
    # (the padding after EXIT) is no loop
    assert set(loops) == {("0x0030", "0x0040"), ("0x0010", "0x00a0")}
    spin = loops[("0x0030", "0x0040")]
    assert (spin["insns"], spin["SYNCS"], spin["BRA"]) == (2, 1, 1)
    row = loops[("0x0010", "0x00a0")]
    assert row["insns"] == 10
    assert (row["BAR"], row["SHFL"], row["LDS"], row["STS"], row["STG"],
            row["LDG"], row["BRA"], row["SYNCS"]) == (1, 2, 1, 1, 1, 0, 2, 1)


def test_loop_opcode_counts():
    """Each loop's opcodes with their counts, modifiers kept: the row
    loop of LABELS holds one SHFL.DOWN, one SHFL.UP, one barrier and the
    two branches, ten instructions in all."""
    loops = {(r["from"], r["to"]): r
             for r in SL.loops(SL.functions(LABELS)["_Z4bandPii"])}
    row = loops[("0x0010", "0x00a0")]["ops"]
    assert row["SHFL.DOWN"] == 1 and row["SHFL.UP"] == 1
    assert row["BAR.SYNC.DEFER_BLOCKING"] == 1 and row["BRA"] == 2
    assert sum(row.values()) == 10
