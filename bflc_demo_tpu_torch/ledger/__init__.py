"""The committee ledger (port of `bflc_demo_tpu/ledger`, python backend).

`make_ledger` builds the pure-Python `PyLedger`, whose op log matches the
reference ledger's bit for bit on the same ops, at the genome's block
geometry (`base.reduce_blocks`: a blocked genome's commit ops carry the
REDUCTION SPEC v2 claim).  `backend` is the reference's: "auto" and
"python" give the python ledger; "native", the reference's C++ `.so`,
raises (ROADMAP A9: the native ledger), blocked genome or not.
`clone_prefix` (reference :66-) is the rollback-to-prefix primitive a
standby's promotion uses; a source compacted behind a snapshot does not
exist here (ROADMAP A9: snapshots).
"""

from __future__ import annotations

from bflc_demo_tpu_torch.ledger.base import (  # noqa: F401
    LedgerStatus, PendingInfo, UpdateInfo, blocked_enabled, blocked_legacy,
    reduce_blocks)
from bflc_demo_tpu_torch.ledger.pyledger import PyLedger
from bflc_demo_tpu_torch.protocol.constants import (DEFAULT_PROTOCOL,
                                                    ProtocolConfig)


LEDGER_BACKENDS = ("auto", "python")


def check_backend(backend: str) -> None:
    """Raise unless `backend` names a ledger the port has."""
    if backend == "native":
        raise NotImplementedError(
            "the native C++ ledger backend is not ported yet (ROADMAP A9: "
            "the native ledger); use backend 'auto' or 'python'")
    if backend not in LEDGER_BACKENDS:
        raise ValueError(f"ledger backend must be one of "
                         f"{LEDGER_BACKENDS + ('native',)}, got {backend!r}")


def make_ledger(cfg: ProtocolConfig = DEFAULT_PROTOCOL, *,
                backend: str = "auto") -> PyLedger:
    check_backend(backend)
    cfg.validate()
    return PyLedger(cfg.client_num, cfg.comm_count, cfg.aggregate_count,
                    cfg.needed_update_count, cfg.genesis_epoch,
                    reduce_blocks=reduce_blocks(cfg))


def clone_prefix(src, upto: int, cfg: ProtocolConfig, *,
                 backend: str = "auto") -> PyLedger:
    """A fresh ledger that replayed ops[0..upto) of `src`.  Raises
    RuntimeError if the prefix does not replay, which cannot happen on a
    chain the source ledger itself accepted."""
    fresh = make_ledger(cfg, backend=backend)
    for j in range(upto):
        st = fresh.apply_op(src.log_op(j))
        if st != LedgerStatus.OK:
            raise RuntimeError(f"prefix replay rejected op {j}: {st.name}")
    return fresh
