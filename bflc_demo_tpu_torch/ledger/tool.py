"""Ledger ops CLI: inspect, verify and replay WAL files.

Copy of `bflc_demo_tpu/ledger/tool.py` (`wal_base`, `iter_wal_ops`,
`main`; `decode_op` is `ledger.base.decode_op`, which also renders
opcode 13, where the reference's tool says unknown):

    python -m bflc_demo_tpu_torch.ledger.tool inspect run.wal
    python -m bflc_demo_tpu_torch.ledger.tool verify  run.wal --client-num 20
    python -m bflc_demo_tpu_torch.ledger.tool head    run.wal --backend native

`inspect` decodes records without applying protocol rules (it stops at
the first torn record, as WAL recovery does); `verify` replays every op
through a fresh ledger of `--backend` (native, python or auto) and
reports the chained head, `verify_log` and the final protocol state;
`head` prints just the head, which two replicas share iff they agree.
Exit code 3 when the chain does not verify.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import struct
import sys
from typing import Iterator, Tuple

from bflc_demo_tpu_torch.ledger import make_ledger
from bflc_demo_tpu_torch.ledger.base import decode_op
from bflc_demo_tpu_torch.ledger.pyledger import PyLedger
from bflc_demo_tpu_torch.protocol.constants import ProtocolConfig


def wal_base(path: str) -> int:
    """Chain offset of a WAL's first record: 0 for a full (WAL1) journal,
    the GC base for a compacted (WAL2) one."""
    with open(path, "rb") as f:
        head = f.read(len(PyLedger._WAL2_MAGIC) + 8)
    if not head.startswith(PyLedger._WAL2_MAGIC):
        return 0
    if len(head) < len(PyLedger._WAL2_MAGIC) + 8:
        raise ValueError(f"truncated WAL2 header: {path}")
    (base,) = struct.unpack_from("<q", head, len(PyLedger._WAL2_MAGIC))
    return base


def iter_wal_ops(path: str) -> Iterator[Tuple[int, bytes]]:
    """(index, op bytes) of each WAL record, stopping at the first torn
    or corrupt one; a compacted WAL's records start at its base."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob.startswith(PyLedger._WAL2_MAGIC):
        # compacted journal: skip magic + base + head + state
        off = len(PyLedger._WAL2_MAGIC)
        if off + 48 > len(blob):
            return
        (i,) = struct.unpack_from("<q", blob, off)
        (n_state,) = struct.unpack_from("<q", blob, off + 40)
        off += 48 + max(n_state, 0)
        if n_state < 0 or off > len(blob):
            return
    elif blob.startswith(PyLedger._WAL_MAGIC):
        off, i = len(PyLedger._WAL_MAGIC), 0
    else:
        raise ValueError(f"not a bflc WAL: {path}")
    while off + 8 <= len(blob):
        (n,) = struct.unpack_from("<Q", blob, off)
        if n > (1 << 26) or off + 8 + n > len(blob):
            return                          # torn tail: recovery stops here
        yield i, blob[off + 8:off + 8 + n]
        off += 8 + n
        i += 1


def _cfg_from(args) -> ProtocolConfig:
    kw = {f.name: getattr(args, f.name)
          for f in dataclasses.fields(ProtocolConfig)
          if getattr(args, f.name, None) is not None}
    return ProtocolConfig(**kw).validate()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bflc_demo_tpu_torch.ledger.tool",
        description=__doc__.splitlines()[0])
    ap.add_argument("command", choices=["inspect", "verify", "head"])
    ap.add_argument("path", help="WAL file (attach_wal output)")
    ap.add_argument("--backend", default="python",
                    choices=["python", "native", "auto"])
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output (one JSON object a line)")
    for f in dataclasses.fields(ProtocolConfig):
        flag = "--" + f.name.replace("_", "-")
        ap.add_argument(flag, type=type(f.default), default=None)
    args = ap.parse_args(argv)

    if args.command == "inspect":
        count = 0
        for i, op in iter_wal_ops(args.path):
            rec = {"i": i, **decode_op(op)}
            print(json.dumps(rec) if args.json else
                  f"[{i:05d}] " + ", ".join(f"{k}={v}" for k, v in
                                            rec.items() if k != "i"))
            count += 1
        if not args.json:
            print(f"{count} record(s) decoded")
        return 0

    ledger = make_ledger(_cfg_from(args), backend=args.backend)
    applied = ledger.replay_wal(args.path)
    ok = ledger.verify_log()
    head = ledger.log_head().hex()
    if args.command == "head":
        print(head)
        return 0 if ok else 3
    summary = {
        "applied_ops": applied,
        "log_size": ledger.log_size(),
        "log_head": head,
        "chain_verified": ok,
        "epoch": ledger.epoch,
        "num_registered": ledger.num_registered,
        "update_count": ledger.update_count,
        "score_count": ledger.score_count,
        "round_closed": ledger.round_closed,
        "last_global_loss": ledger.last_global_loss,
        "committee": ledger.committee(),
    }
    print(json.dumps(summary) if args.json else
          "\n".join(f"{k:18} {v}" for k, v in summary.items()))
    return 0 if ok else 3


if __name__ == "__main__":
    sys.exit(main())
