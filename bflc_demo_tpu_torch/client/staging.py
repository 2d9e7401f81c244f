"""Data-plane staging and the ledger's round audit.

Port of `bflc_demo_tpu/client/staging.py` — `stage_padded_arrays`,
`cyc_pad` and `cast_features` (:21-67) and `audit_round` (:79-116) —
with the same outputs: numpy staging (cyclic padding to the largest
shard, integer features kept int32, everything else float32, empty
shards rejected) and the replay of one device round's artifacts into the
ledger, which raises on any ledger/device divergence.  Dropped:
`largest_divisor_device_count`; the port's mesh round runs on one card.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np

from bflc_demo_tpu_torch.data.partition import one_hot
from bflc_demo_tpu_torch.ledger import LedgerStatus
from bflc_demo_tpu_torch.ops.fingerprint import fingerprint_to_bytes


def stage_padded_arrays(shard_xs: Sequence[np.ndarray],
                        shard_ys: Sequence[np.ndarray],
                        num_classes: int,
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad every shard to the largest by cyclic repetition, so all of a
    client's data stays and the shapes are uniform; FedAvg weighs by the
    TRUE sizes (returned), so padding never distorts the aggregate.

    Returns (xs (N, S_pad, *feat), ys_onehot (N, S_pad, C), sizes (N,)).
    """
    empties = [i for i, sx in enumerate(shard_xs) if len(sx) == 0]
    if empties:
        raise ValueError(f"shards {empties} are empty; every client needs "
                         f"at least one sample")
    sizes = np.asarray([len(sx) for sx in shard_xs], np.int64)
    s_pad = int(sizes.max())
    xs = cast_features(np.stack([cyc_pad(sx, s_pad) for sx in shard_xs]))
    ys = np.stack([one_hot(cyc_pad(sy, s_pad), num_classes)
                   for sy in shard_ys])
    return xs, ys, sizes


def cyc_pad(a: np.ndarray, s_pad: int) -> np.ndarray:
    """Cyclically repeat `a` along axis 0 to exactly s_pad rows."""
    reps = -(-s_pad // len(a))
    return np.concatenate([np.asarray(a)] * reps)[:s_pad]


def cast_features(xs: np.ndarray) -> np.ndarray:
    """Integer features (token ids) stay int32; everything else float32."""
    return (xs.astype(np.int32) if np.issubdtype(xs.dtype, np.integer)
            else xs.astype(np.float32))


def audit_round(ledger, addr_of: Callable[[int], str], epoch: int,
                uploader_ids: List[int], committee_ids: List[int],
                up_slots: List[int], comm_slots: List[int],
                delta_fps: np.ndarray, sizes_of: Callable[[int], int],
                avg_costs: np.ndarray, score_rows: np.ndarray,
                sel_device: np.ndarray, params_fp: np.ndarray) -> None:
    """Replay one device round's artifacts into the ledger and audit the
    decision: the op log stays the authority and any ledger-vs-device
    divergence raises.

    uploader_ids/committee_ids are CLIENT indices (ledger identity
    order); up_slots/comm_slots the matching DEVICE slot rows of
    delta_fps/score_rows (identical lists under full participation).
    """
    for j, cid in enumerate(uploader_ids):
        st = ledger.upload_local_update(
            addr_of(cid), fingerprint_to_bytes(delta_fps[up_slots[j]]),
            int(sizes_of(cid)), float(avg_costs[up_slots[j]]), epoch)
        if st != LedgerStatus.OK:
            raise RuntimeError(f"upload rejected: {st.name}")
    for j, cid in enumerate(committee_ids):
        st = ledger.upload_scores(
            addr_of(cid), epoch,
            [float(score_rows[comm_slots[j], u]) for u in up_slots])
        if st != LedgerStatus.OK:
            raise RuntimeError(f"scores rejected: {st.name}")
    pending = ledger.pending()
    sel_ledger = np.sort([up_slots[s] for s in pending.selected])
    if not np.array_equal(sel_ledger, np.sort(np.asarray(sel_device))):
        raise RuntimeError(
            f"ledger/device decision divergence at epoch {epoch}: "
            f"ledger={sel_ledger} device={np.sort(np.asarray(sel_device))}")
    st = ledger.commit_model(fingerprint_to_bytes(np.asarray(params_fp)),
                             epoch)
    if st != LedgerStatus.OK:
        raise RuntimeError(f"commit rejected: {st.name}")
