"""The per-client state machine, the compute plane, and the sponsor.

Port of `bflc_demo_tpu/client/runtime.py` (`FLNode`, `ComputePlane`,
`Sponsor`), same protocol steps:
- `FLNode.step`: a trainer trains once per epoch and uploads its delta's
  hash (first-come cap at the ledger); a committee member scores every
  collected candidate once the round is full;
- `ComputePlane`: applies the ledger-decided selection on the device and
  commits the new model's content hash;
- `Sponsor`: held-out accuracy after every commit.

`FLNode.optimizer` is the reference's local optimizer (a `core.optim`
transform; None = plain SGD).  `FLNode.keyring` (:53-61, :91-95,
:128-132): a `comm.identity.KeyRing` (or a wallet, the same signer
surface) signs every client op, register, upload and scores, for an
`AuthenticatedLedger`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import numpy as np
import torch

from bflc_demo_tpu_torch.comm.store import UpdateStore
from bflc_demo_tpu_torch.core import (apply_selection, evaluate, local_train,
                                      score_candidates)
from bflc_demo_tpu_torch.ledger.base import LedgerStatus
from bflc_demo_tpu_torch.models.base import Model, Params
from bflc_demo_tpu_torch.protocol.constants import ProtocolConfig
from bflc_demo_tpu_torch.utils.serialization import hash_pytree


def feature_tensor(x: np.ndarray, device) -> torch.Tensor:
    """Features on `device`: token ids index the embedding, so integer
    features become int64; everything else float32."""
    x = np.asarray(x)
    return torch.as_tensor(x, dtype=torch.long if np.issubdtype(
        x.dtype, np.integer) else torch.float32, device=device)


def _stack(trees: List[Params]) -> Params:
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


@dataclasses.dataclass
class FLNode:
    """One logical client: address, local shard, round bookkeeping."""

    address: str
    x: torch.Tensor              # local shard features
    y: torch.Tensor              # local shard labels, one-hot
    model: Model
    cfg: ProtocolConfig
    trained_epoch: int = -1
    scored_epoch: int = -1
    optimizer: Any = None        # core.optim transform; None = plain SGD
    keyring: Any = None          # comm.identity.KeyRing: every client op
                                 # then carries a tag

    def register(self, ledger) -> LedgerStatus:
        if self.keyring is not None:
            from bflc_demo_tpu_torch.comm.identity import sign_register
            return ledger.register_node(
                self.address, sign_register(self.keyring, self.address))
        return ledger.register_node(self.address)

    def step(self, ledger, store: UpdateStore,
             global_params: Params) -> Optional[str]:
        """One event-driven turn; returns the action taken or None."""
        role, epoch = ledger.query_state(self.address)
        if epoch == self.cfg.genesis_epoch or epoch > self.cfg.max_epoch:
            return None
        if role == "trainer":
            if epoch <= self.trained_epoch:
                return None
            return self._train(ledger, store, global_params, epoch)
        if epoch <= self.scored_epoch:
            return None
        return self._score(ledger, store, global_params, epoch)

    def _train(self, ledger, store, global_params, epoch) -> Optional[str]:
        delta, avg_cost = local_train(
            self.model, global_params, self.x, self.y,
            lr=self.cfg.learning_rate, batch_size=self.cfg.batch_size,
            local_epochs=self.cfg.local_epochs, optimizer=self.optimizer)
        payload_hash = store.put(delta)
        n_samples, cost = int(self.x.shape[0]), float(avg_cost)
        if self.keyring is not None:
            from bflc_demo_tpu_torch.comm.identity import sign_upload
            st = ledger.upload_local_update(
                self.address, payload_hash, n_samples, cost, epoch,
                sign_upload(self.keyring, self.address, payload_hash,
                            n_samples, cost, epoch))
        else:
            st = ledger.upload_local_update(self.address, payload_hash,
                                            n_samples, cost, epoch)
        if st == LedgerStatus.OK:
            self.trained_epoch = epoch
            return "train:OK"
        store.drop(payload_hash)
        if st in (LedgerStatus.CAP_REACHED, LedgerStatus.DUPLICATE):
            # the round did not need us (first-come cap); done this epoch
            self.trained_epoch = epoch
            return f"train:{st.name}"
        # e.g. WRONG_EPOCH: retrain against the fresh model next event
        return None

    def _score(self, ledger, store, global_params, epoch) -> Optional[str]:
        updates = ledger.query_all_updates()
        if not updates:     # round not full yet
            return None
        stacked = _stack([store.get(u.payload_hash) for u in updates])
        scores = score_candidates(self.model, global_params, stacked,
                                  self.cfg.learning_rate, self.x, self.y)
        # accuracies are finite by construction; the nan_to_num keeps an
        # honest node from ever emitting a row the ledger rejects
        score_list = [float(s) for s in np.nan_to_num(
            scores.cpu().numpy(), nan=0.0, posinf=1.0, neginf=0.0)]
        if self.keyring is not None:
            from bflc_demo_tpu_torch.comm.identity import sign_scores
            st = ledger.upload_scores(
                self.address, epoch, score_list,
                sign_scores(self.keyring, self.address, epoch, score_list))
        else:
            st = ledger.upload_scores(self.address, epoch, score_list)
        self.scored_epoch = epoch
        return f"score:{st.name}" if st == LedgerStatus.OK else None


class ComputePlane:
    """Applies ledger-decided aggregations on device and commits the hash."""

    def __init__(self, cfg: ProtocolConfig):
        self.cfg = cfg

    def maybe_aggregate(self, ledger, store: UpdateStore,
                        global_params: Params) -> Optional[Params]:
        if not ledger.aggregate_ready():
            return None
        pending = ledger.pending()
        updates = ledger.query_all_updates()
        epoch = ledger.epoch
        stacked = _stack([store.get(u.payload_hash) for u in updates])
        device = next(iter(global_params.values())).device
        n_samples = torch.tensor([u.n_samples for u in updates],
                                 dtype=torch.int32, device=device)
        sel = torch.zeros(len(updates), dtype=torch.bool, device=device)
        sel[list(pending.selected)] = True
        new_params = apply_selection(global_params, stacked, n_samples, sel,
                                     self.cfg.learning_rate)
        st = ledger.commit_model(hash_pytree(new_params), epoch)
        if st != LedgerStatus.OK:
            raise RuntimeError(f"model commit rejected: {st.name}")
        for u in updates:   # round payloads are dead after aggregation
            store.drop(u.payload_hash)
        return new_params


class Sponsor:
    """Held-out global eval — the system's quality metric."""

    def __init__(self, model: Model, x_test: torch.Tensor,
                 y_test: torch.Tensor):
        self.model = model
        self.x = x_test
        self.y = y_test
        self.history: List[tuple] = []       # (epoch, accuracy)

    def observe(self, epoch: int, global_params: Params) -> float:
        acc = float(evaluate(self.model, global_params, self.x, self.y))
        self.history.append((epoch, acc))
        return acc
