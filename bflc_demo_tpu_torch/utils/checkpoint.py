"""Checkpoint / resume: the op log is the checkpoint.

Port of `bflc_demo_tpu/utils/checkpoint.py` (:37-109), byte for byte.
A checkpoint directory holds three files:

- `model.bflct`: the global model in the canonical blob layout
  (`utils.codecs.pack_pytree`; no JSON, no pickle);
- `ledger.oplog`: `BFLCLOG1`, the op count (int64), each accepted op
  length-prefixed (int64), then the 32-byte log head;
- `meta.json`: `{"epoch", "log_size", "log_head"}` and the caller's
  extra fields, as `json.dump(..., indent=2)` writes them.

`load_checkpoint` replays the ops into a fresh ledger (`make_ledger`:
native where `auto` picks it) and raises ValueError if an op is refused
or the replayed head differs from the recorded one (a tampered or
corrupt checkpoint), so a resumed run continues at the same epoch with
the same committee, as the reference's chain restart does.
`restore_params_like` pours the loaded leaves into a template's keys,
dtypes and device.  Each package loads the other's checkpoints.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from bflc_demo_tpu_torch.ledger import LedgerStatus, make_ledger
from bflc_demo_tpu_torch.models.base import Params
from bflc_demo_tpu_torch.protocol.constants import ProtocolConfig
from bflc_demo_tpu_torch.utils.serialization import (pack_pytree,
                                                     restore_pytree,
                                                     unpack_pytree)

_OPLOG_MAGIC = b"BFLCLOG1"


def save_checkpoint(directory: str, params: Mapping[str, Any], ledger,
                    extra: Optional[Dict] = None) -> None:
    """Write `model.bflct`, `ledger.oplog` and `meta.json` into
    `directory` (created if missing)."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "model.bflct"), "wb") as f:
        f.write(pack_pytree(params))
    with open(os.path.join(directory, "ledger.oplog"), "wb") as f:
        f.write(_OPLOG_MAGIC)
        n = ledger.log_size()
        f.write(struct.pack("<q", n))
        for i in range(n):
            op = ledger.log_op(i)
            f.write(struct.pack("<q", len(op)))
            f.write(op)
        f.write(ledger.log_head())
    meta = {"epoch": ledger.epoch, "log_size": ledger.log_size(),
            "log_head": ledger.log_head().hex(), **(extra or {})}
    with open(os.path.join(directory, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)


def load_checkpoint(directory: str, cfg: ProtocolConfig,
                    ledger_backend: str = "auto",
                    ) -> Tuple[Dict[str, np.ndarray], Any, Dict]:
    """(flat params {keystr: numpy array}, the replayed ledger, meta)."""
    with open(os.path.join(directory, "model.bflct"), "rb") as f:
        flat_params = unpack_pytree(f.read())
    with open(os.path.join(directory, "ledger.oplog"), "rb") as f:
        blob = f.read()
    if not blob.startswith(_OPLOG_MAGIC):
        raise ValueError("not a bflc ledger oplog")
    off = len(_OPLOG_MAGIC)
    (n,) = struct.unpack_from("<q", blob, off)
    off += 8
    ledger = make_ledger(cfg, backend=ledger_backend)
    for _ in range(n):
        (sz,) = struct.unpack_from("<q", blob, off)
        off += 8
        op = blob[off:off + sz]
        off += sz
        st = ledger.apply_op(op)
        if st != LedgerStatus.OK:
            raise ValueError(f"oplog replay rejected an op: {st.name}")
    recorded_head = blob[off:off + 32]
    if ledger.log_head() != recorded_head:
        raise ValueError("oplog head mismatch after replay — corrupt or "
                         "tampered checkpoint")
    with open(os.path.join(directory, "meta.json")) as f:
        meta = json.load(f)
    return flat_params, ledger, meta


def restore_params_like(template: Mapping[str, torch.Tensor],
                        flat: Mapping[str, np.ndarray]) -> Params:
    """The checkpoint's leaves as tensors keyed, typed and placed like
    `template` (a `Params` dict).  KeyError on a missing leaf,
    ValueError on a shape mismatch."""
    try:
        return restore_pytree(template, flat)
    except KeyError as exc:
        raise KeyError(f"checkpoint missing leaf "
                       f"{str(exc.args[0]).split()[-1]}") from None
