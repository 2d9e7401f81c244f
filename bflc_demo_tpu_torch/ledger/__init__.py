"""The committee ledger (port of `bflc_demo_tpu/ledger`, python backend).

`make_ledger` builds the pure-Python `PyLedger`, whose op log matches the
reference ledger's bit for bit on the same ops.  The reference's native
`.so` backend is not bound by the port.
"""

from __future__ import annotations

from bflc_demo_tpu_torch.ledger.base import (  # noqa: F401
    LedgerStatus, PendingInfo, UpdateInfo)
from bflc_demo_tpu_torch.ledger.pyledger import PyLedger
from bflc_demo_tpu_torch.protocol.constants import (DEFAULT_PROTOCOL,
                                                    ProtocolConfig)


def make_ledger(cfg: ProtocolConfig = DEFAULT_PROTOCOL) -> PyLedger:
    cfg.validate()
    return PyLedger(cfg.client_num, cfg.comm_count, cfg.aggregate_count,
                    cfg.needed_update_count, cfg.genesis_epoch)
