"""The committee ledger (port of `bflc_demo_tpu/ledger`).

`make_ledger` (reference :19-63) returns the native C++ ledger
(`bindings.NativeLedger`, the port's own copy of the reference's
`ledger/src/`, built by `bindings.build_library`) for `backend="auto"`
whenever the library builds and loads and the config is synchronous,
unblocked and not adaptive, as the reference's does; otherwise the
pure-Python `PyLedger`, whose op log matches the native one byte for
byte.  `PyLedger` runs at the genome's block geometry
(`base.reduce_blocks`: a blocked genome's commit ops carry the REDUCTION
SPEC v2 claim), with the async buffered family armed when
`base.async_enabled(cfg)` (`async_buffer`, `max_staleness`,
`async_reseat_every`; `BFLC_ASYNC_LEGACY=1` keeps the synchronous
ledger, byte for byte) and with the closed compression loop armed when
`base.adapt_enabled(cfg)` (`delta_density`, `density_floor`,
`adapt_every`; `BFLC_ADAPT_LEGACY=1` keeps the static knobs): the
native ledger has no ABI for those op families, so `native` there
raises the reference's `ValueError`, and `native` without a library
raises `RuntimeError`.  Each ledger names itself in `backend`
("native" or "python").
`clone_prefix` (reference :66-96) is the rollback-to-prefix primitive a
standby's promotion and a validator's repair use; a source compacted
behind a certified snapshot clones from its base state and replays only
the retained tail.
"""

from __future__ import annotations

from bflc_demo_tpu_torch.ledger.base import (  # noqa: F401
    ADDR_CAP, AsyncUpdateInfo, LedgerStatus, PendingInfo, UpdateInfo,
    adapt_enabled, adapt_legacy, async_enabled, async_legacy,
    blocked_enabled, blocked_legacy, reduce_blocks)
from bflc_demo_tpu_torch.ledger.pyledger import PyLedger
from bflc_demo_tpu_torch.protocol.constants import (DEFAULT_PROTOCOL,
                                                    ProtocolConfig)


LEDGER_BACKENDS = ("auto", "native", "python")


def check_backend(backend: str) -> None:
    """Raise unless `backend` names a ledger backend."""
    if backend not in LEDGER_BACKENDS:
        raise ValueError(f"ledger backend must be one of "
                         f"{LEDGER_BACKENDS}, got {backend!r}")


def make_ledger(cfg: ProtocolConfig = DEFAULT_PROTOCOL, *,
                backend: str = "auto"):
    """A committee ledger.  backend: 'auto' | 'native' | 'python'."""
    check_backend(backend)
    cfg.validate()
    args = (cfg.client_num, cfg.comm_count, cfg.aggregate_count,
            cfg.needed_update_count, cfg.genesis_epoch)
    if async_enabled(cfg) or reduce_blocks(cfg) > 1 or adapt_enabled(cfg):
        if backend == "native":
            raise ValueError(
                "async_buffer > 0 / reduce_blocks > 1 / adapt_every > 0 "
                "need the python ledger backend (the native ledger has "
                "no async-op, geometry-claim or genome-update ABI)")
        kw = {}
        if async_enabled(cfg):
            kw = dict(async_buffer=cfg.async_buffer,
                      max_staleness=cfg.max_staleness,
                      async_reseat_every=cfg.async_reseat_every)
        if adapt_enabled(cfg):
            kw.update(delta_density=cfg.delta_density,
                      density_floor=cfg.density_floor,
                      adapt_every=cfg.adapt_every)
        return PyLedger(*args, reduce_blocks=reduce_blocks(cfg), **kw)
    if backend in ("auto", "native"):
        from bflc_demo_tpu_torch.ledger import bindings
        if bindings.native_available():
            return bindings.NativeLedger(*args)
        if backend == "native":
            raise RuntimeError(f"native ledger requested but it could not "
                               f"be built or loaded: "
                               f"{bindings.load_error()}")
    return PyLedger(*args)


def clone_prefix(src, upto: int, cfg: ProtocolConfig, *,
                 backend: str = "auto"):
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
