"""`eval/sass.py` on canned `cuobjdump -sass` text: opcodes to pipes, one
function picked out of a library's listing, and its largest innermost
loop found from the backward branches (B7's pair loop on the card)."""

import pytest

from bflc_demo_tpu_torch.eval import sass

LISTING = """
\tcode for sm_90a
\t\tFunction : _Z5otherv
        /*0000*/                   IADD3 R1, R1, 0x1, RZ ;
        /*0010*/                   EXIT ;
\t\tFunction : _ZN12_GLOBAL__N_118secure_mask_kernelEPKNS_8LeafDescEi
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;        /* 0x00000a00ff017b82 */
                                                                 /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;
        /*0020*/                   ULDC UR4, c[0x0][0x218] ;
        /*0030*/                   LDS.128 R4, [R3] ;
        /*0040*/                   IMAD.WIDE.U32 R6, R2, R8, RZ ;
        /*0050*/                   LOP3.LUT R2, R6, R7, R4, 0x1e, !PT ;
        /*0060*/                   SHF.L.W.U32.HI R2, R2, 0xd, R2 ;
        /*0070*/                   IMAD.IADD R9, R2, 0x1, R9 ;
        /*0080*/                   ISETP.GE.AND P0, PT, R9, R10, PT ;
        /*0090*/                   IADD3 R11, R11, 0x1, RZ ;
        /*00a0*/              @!P0 BRA 0x90 ;
        /*00b0*/               @P1 BRA 0x30 ;
        /*00c0*/                   F2I.NTZ R2, R3 ;
        /*00d0*/                   STG.E [R4.64], R2 ;
        /*00e0*/                   EXIT ;
        /*00f0*/                   BRA 0xf0;
"""


@pytest.mark.parametrize("op,pipe", [
    ("IADD3", "alu"), ("LOP3", "alu"), ("SHF", "alu"), ("ISETP", "alu"),
    ("IMAD", "fma"), ("FFMA", "fma"), ("LDS", "mio"), ("STG", "mio"),
    ("S2R", "mio"), ("F2I", "xu"), ("ULDC", "uniform"), ("BRA", "control"),
    ("EXIT", "control"), ("VIADD", "other")])
def test_pipe_of_each_opcode(op, pipe):
    assert sass.pipe(op) == pipe


def test_function_picked_out_and_counted():
    rows = sass.function_sass(LISTING, "secure_mask_kernel")
    assert [r[0] for r in rows] == list(range(0, 0x100, 0x10))
    assert rows[4][2] == "IMAD.WIDE.U32" and rows[4][1] == "IMAD"
    assert rows[10][3] == 0x90 and rows[15][3] == 0xF0
    whole = sass.counts(rows)
    assert whole["total"] == 16
    assert (whole["alu"], whole["fma"], whole["mio"], whole["xu"],
            whole["uniform"], whole["control"], whole["other"]) == \
        (4, 2, 4, 1, 1, 4, 0)
    assert whole["opcodes"]["IADD3"] == 1
    assert sass.function_sass(LISTING, "absent") == []


def test_largest_innermost_loop():
    """Two loops nest (0x30-0xb0 holds 0x90-0xa0) and the tail's self
    branch is a loop of one: of the loops holding no other, tied on the
    opcode (one BRA each), the inner one is larger."""
    rows = sass.function_sass(LISTING, "secure_mask_kernel")
    assert sass.innermost_loop(rows, "BRA") == (9, 10)
    rows = [r for r in rows if r[0] != 0xA0]      # drop the inner loop
    first, last = sass.innermost_loop(rows, "BRA")
    assert (rows[first][0], rows[last][0]) == (0x30, 0xB0)
    loop = sass.counts(rows[first:last + 1])
    assert (loop["alu"], loop["fma"], loop["mio"]) == (4, 2, 1)


def test_loop_chosen_by_opcode():
    """With an opcode the innermost loop holding the most of it wins over
    a larger one (B7 at one element a thread: the unrolled encode loop
    is larger than the pair loop, which holds the LOP3s)."""
    rows = [(0x00, "LOP3", "LOP3.LUT", None), (0x10, "BRA", "BRA", 0x00),
            (0x20, "IADD3", "IADD3", None), (0x30, "FMNMX", "FMNMX", None),
            (0x40, "IADD3", "IADD3", None), (0x50, "BRA", "BRA", 0x20)]
    assert sass.innermost_loop(rows, "BRA") == (2, 5)
    assert sass.innermost_loop(rows, "LOP3") == (0, 1)
