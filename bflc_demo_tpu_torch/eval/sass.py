"""A kernel's SASS counted by the pipe each instruction issues to.

`cuobjdump -sass` of a built library, one function's instructions, each
opcode assigned to the pipe that executes it on Hopper (sm_90):

- `alu`: the INT pipe (IADD3, LOP3, SHF, ISETP, ...; 16 lanes a
  sub-partition, a warp instruction every 2 clocks);
- `fma`: the FMA pipes (IMAD in every form — .WIDE, .IADD, .MOV, .SHL —
  and FFMA, FADD, FMUL; IMAD on the heavy one, 16 lanes);
- `mio`: shared, global and constant memory, shuffles and special
  registers; `xu`: conversions and MUFU; `uniform`: the U* datapath;
  `control`: branches, barriers and waits; `other`: an opcode none of
  these names (sm_90's VIADD among them).

`loop` is the innermost loop (a backward branch with no other backward
branch inside it) holding the most instructions of a given opcode: for
B7, the one with the most LOP3, the pair loop, each pass of which draws
one mask word for each of a thread's elements.
"""

from __future__ import annotations

import re
import shutil
import subprocess
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional, Tuple

ALU = {"IADD3", "LOP3", "SHF", "ISETP", "LEA", "SEL", "PRMT", "IABS",
       "IMNMX", "VIMNMX", "BMSK", "SGXT", "FLO", "POPC", "BREV", "PLOP3",
       "P2R", "R2P", "LOP", "SHL", "SHR", "IADD", "ISCADD", "MOV", "FSEL",
       "FSETP", "FMNMX", "FCHK", "CSET", "CSETP", "HSETP2", "HMNMX2"}
FMA = {"IMAD", "FFMA", "FADD", "FMUL", "HFMA2", "HADD2", "HMUL2", "IDP",
       "IMUL", "FSWZADD"}
MIO = {"LDS", "STS", "LDG", "STG", "LD", "ST", "LDC", "LDL", "STL", "ATOM",
       "ATOMS", "ATOMG", "RED", "SHFL", "S2R", "CS2R", "LDSM", "LDGSTS",
       "MEMBAR", "ERRBAR", "CCTL", "S2UR", "LDGDEPBAR", "DEPBAR"}
XU = {"MUFU", "F2I", "I2F", "F2F", "FRND", "I2I", "F2FP"}
CONTROL = {"BRA", "BRX", "JMP", "EXIT", "RET", "CALL", "BSSY", "BSYNC",
           "BAR", "NOP", "WARPSYNC", "YIELD", "BPT", "KILL", "NANOSLEEP"}

_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_]*)((?:\.[A-Z0-9_]+)*)([^;]*);")
_TARGET = re.compile(r"0x([0-9a-f]+)|`\(\.L_x_(\d+)\)")
_LABEL = re.compile(r"^\s*\.L_x_(\d+):")


def pipe(op: str) -> str:
    """The pipe of an opcode (its name before the first dot)."""
    if op.startswith("U"):
        return "uniform"
    for name, group in (("alu", ALU), ("fma", FMA), ("mio", MIO),
                        ("xu", XU), ("control", CONTROL)):
        if op in group:
            return name
    return "other"


def function_sass(text: str, kernel: str) -> List[Tuple[int, str, str,
                                                        Optional[int]]]:
    """[(address, opcode, opcode with modifiers, branch target)] of the
    first function in `cuobjdump -sass` output whose name holds
    `kernel`."""
    out, inside, labels, pending = [], False, {}, []
    for line in text.splitlines():
        if "Function :" in line:
            if inside:
                break
            inside = kernel in line
            continue
        if not inside:
            continue
        label = _LABEL.match(line)
        if label:
            pending.append(label.group(1))
            continue
        m = _LINE.search(line)
        if not m:
            continue
        addr = int(m.group(1), 16)
        for name in pending:
            labels[name] = addr
        pending = []
        op, full, rest = m.group(2), m.group(2) + m.group(3), m.group(4)
        target = None
        if op in ("BRA", "BRX", "JMP"):
            t = _TARGET.search(rest)
            if t:
                target = int(t.group(1), 16) if t.group(1) else \
                    ("L", t.group(2))
        out.append([addr, op, full, target])
    for row in out:
        if isinstance(row[3], tuple):
            row[3] = labels.get(row[3][1])
    return [tuple(row) for row in out]


def counts(rows) -> Dict[str, object]:
    """Instructions by pipe, and by opcode with its modifiers."""
    by_pipe = Counter(pipe(op) for _, op, _, _ in rows)
    return {"total": len(rows), **{k: by_pipe.get(k, 0) for k in
                                   ("alu", "fma", "mio", "xu", "uniform",
                                    "control", "other")},
            "opcodes": dict(Counter(full for _, _, full, _ in rows)
                            .most_common())}


def innermost_loop(rows, opcode: str) -> Optional[Tuple[int, int]]:
    """(first, last) index of the loop holding no other loop with the
    most `opcode` instructions (of those tied, the largest)."""
    index = {addr: i for i, (addr, _, _, _) in enumerate(rows)}
    loops = [(index[t], i) for i, (_, _, _, t) in enumerate(rows)
             if t is not None and t in index and index[t] <= i]
    inner = [(a, b) for a, b in loops
             if not any(a <= c and d <= b and (c, d) != (a, b)
                        for c, d in loops)]
    return max(inner, key=lambda ab: (
        sum(op == opcode for _, op, _, _ in rows[ab[0]:ab[1] + 1]),
        ab[1] - ab[0]), default=None)


def pipe_counts(library: str, kernel: str,
                opcode: str) -> Dict[str, object]:
    """The function's counts by pipe, whole and in the innermost loop
    with the most `opcode` instructions, from `cuobjdump -sass` of the
    built `library`."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        raise RuntimeError("cuobjdump not found (PATH or "
                           "/usr/local/cuda/bin)")
    text = subprocess.run([tool, "-sass", library], capture_output=True,
                          text=True, check=True).stdout
    rows = function_sass(text, kernel)
    if not rows:
        raise RuntimeError(f"no function named like {kernel!r} in "
                           f"{library}")
    loop = innermost_loop(rows, opcode)
    return {"kernel": kernel, "whole": counts(rows),
            "loop": None if loop is None else
            counts(rows[loop[0]:loop[1] + 1])}
