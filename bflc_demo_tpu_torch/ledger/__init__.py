"""The committee ledger (port of `bflc_demo_tpu/ledger`, python backend).

`make_ledger` builds the pure-Python `PyLedger`, whose op log matches the
reference ledger's bit for bit on the same ops, at the genome's block
geometry (`base.reduce_blocks`: a blocked genome's commit ops carry the
REDUCTION SPEC v2 claim) and, when `base.async_enabled(cfg)`, with the
async buffered family armed (`async_buffer`, `max_staleness`,
`async_reseat_every`, reference :23-52; `BFLC_ASYNC_LEGACY=1` keeps the
synchronous ledger, byte for byte) and, when `base.adapt_enabled(cfg)`,
with the closed compression loop armed (`delta_density`,
`density_floor`, `adapt_every`; `BFLC_ADAPT_LEGACY=1` keeps the static
knobs).  `backend` is the reference's:
"auto" and "python" give the python ledger; "native", the reference's
C++ `.so`, raises (ROADMAP A9: the native ledger), blocked genome or
not.
`clone_prefix` (reference :66-92) is the rollback-to-prefix primitive a
standby's promotion and a validator's repair use; a source compacted
behind a certified snapshot clones from its base state and replays only
the retained tail.
"""

from __future__ import annotations

from bflc_demo_tpu_torch.ledger.base import (  # noqa: F401
    AsyncUpdateInfo, LedgerStatus, PendingInfo, UpdateInfo, adapt_enabled,
    adapt_legacy, async_enabled, async_legacy, blocked_enabled,
    blocked_legacy, reduce_blocks)
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
    kw = {}
    if async_enabled(cfg):
        kw = dict(async_buffer=cfg.async_buffer,
                  max_staleness=cfg.max_staleness,
                  async_reseat_every=cfg.async_reseat_every)
    if adapt_enabled(cfg):
        kw.update(delta_density=cfg.delta_density,
                  density_floor=cfg.density_floor,
                  adapt_every=cfg.adapt_every)
    return PyLedger(cfg.client_num, cfg.comm_count, cfg.aggregate_count,
                    cfg.needed_update_count, cfg.genesis_epoch,
                    reduce_blocks=reduce_blocks(cfg), **kw)


def clone_prefix(src, upto: int, cfg: ProtocolConfig, *,
                 backend: str = "auto") -> PyLedger:
    """A fresh ledger that replayed ops[0..upto) of `src`.  Raises
    RuntimeError if the prefix does not replay, which cannot happen on a
    chain the source ledger itself accepted, and below a compacted
    source's GC base (certified history is never rolled back past a
    certified snapshot)."""
    base = src.log_base
    if base:
        if upto < base:
            raise RuntimeError(
                f"clone_prefix({upto}) below GC base {base}: the prefix "
                f"was compacted behind a certified snapshot")
        from bflc_demo_tpu_torch.ledger.snapshot import restore_snapshot
        fresh = restore_snapshot(src._base_state, cfg, base, src._base_head)
    else:
        fresh = make_ledger(cfg, backend=backend)
    for j in range(base, upto):
        st = fresh.apply_op(src.log_op(j))
        if st != LedgerStatus.OK:
            raise RuntimeError(f"prefix replay rejected op {j}: {st.name}")
    return fresh
