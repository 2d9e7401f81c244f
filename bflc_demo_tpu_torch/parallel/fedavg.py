"""The FL round as one program on one card: train, score, decide, merge.

Port of `bflc_demo_tpu/parallel/fedavg.py:make_sharded_protocol_round`
(:261-494) with the committee scoring schedule (`committee_score_matrix`
:187-240, `_score_block` :101-122), on one card.  The reference's
`shard_map` over a client axis becomes batch dimensions on one device:

1. every client trains, all in lockstep (`core.local_train_stacked`);
2. the K uploaders' candidates `params - lr * delta` are scored on the C
   committee members' padded shards as ONE stacked apply of C*K models,
   into a sparse (N, N) matrix, nonzero only at (committee row, uploader
   column);
3. the decision — medians over the committee rows, the specified total
   order, top-k under the uploader mask — is `core.aggregate.decide`;
4. FedAvg is `_psum_fedavg_body` (:59-78) over one shard,
   `core.aggregate.apply_selection` given the trained models (on CPU
   tensors it takes the order XLA:CPU compiles into the round program);
5. the payload ids of all N deltas and of the new model come from the
   fingerprint kernel (`ops/fingerprint.py`, two launches);
6. with `expose_candidates` the K uploaded deltas, stacked in ascending
   uploader id (:425-433): the reference all-gathers them over the
   client axis, one card indexes its stacked deltas with the scoring's
   own `_first_k_indices`.  They are the evidence committee members
   re-score to attest their rows (`comm/executor_service.py`).

`make_sharded_protocol_round` checks what the reference checks (the
scoring schedule, the static committee geometry, client_chunk
divisibility) and raises
`NotImplementedError`, naming the ROADMAP item, for what is not ported:
ring scoring, secure aggregation and local optimizers.  The memory controls are ported: `client_chunk` trains the
slots, and scores the committee, in sequential chunks, and `remat`
recomputes each training step's forward in its backward
(`core.local_train.sgd_stacked`).  The returned function checks the masks'
popcounts against the static counts, as the reference's `_check_masks`
(:448-472) does.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from bflc_demo_tpu_torch.core.aggregate import apply_selection, decide
from bflc_demo_tpu_torch.core.local_train import sgd_stacked, wire_deltas
from bflc_demo_tpu_torch.core.losses import xla_mean
from bflc_demo_tpu_torch.models.base import Model, Params
from bflc_demo_tpu_torch.ops.fingerprint import (fingerprint_pytree,
                                                 fingerprint_stacked)


class ShardedRoundResult(NamedTuple):
    params: Params              # new global model
    score_matrix: torch.Tensor  # (N, N) scorer x candidate; nonzero only
                                # at (committee row, uploader column)
    medians: torch.Tensor       # (N,)
    selected: torch.Tensor      # (N,) bool
    order: torch.Tensor         # (N,) candidate slots best-first
    avg_costs: torch.Tensor     # (N,) per-client mean local loss
    global_loss: torch.Tensor   # mean avg_cost of the selected
    delta_fps: torch.Tensor     # (N, 8) payload fingerprints (uint32 words)
    params_fp: torch.Tensor     # (8,) fingerprint of the new model
    cand_deltas: Params = ()    # expose_candidates: the K uploaded deltas,
                                # stacked ascending-uploader-id; else ()


def _first_k_indices(mask: torch.Tensor, k: int) -> torch.Tensor:
    """(k,) ascending indices of the first k True entries of a mask."""
    return torch.sort((~mask).to(torch.int32), stable=True).indices[:k]


@torch.no_grad()
def score_block(model: Model, params: Params, block: Params, lr: float,
                xs: torch.Tensor, ys: torch.Tensor,
                chunk: int = 0) -> torch.Tensor:
    """(n_scorers, n_block) accuracies of the candidates `params - lr *
    delta_k` on each scorer's shard, as one stacked apply of
    n_scorers * n_block models (model c * n_block + k); with 0 < chunk <
    n_scorers dividing n_scorers, as one such apply per chunk of
    scorers, one after another (`_score_block` :102-125)."""
    n_scorers = xs.shape[0]
    if chunk and chunk < n_scorers and n_scorers % chunk == 0:
        return torch.cat([score_block(model, params, block, lr,
                                      xs[i:i + chunk], ys[i:i + chunk])
                          for i in range(0, n_scorers, chunk)])
    n_block = next(iter(block.values())).shape[0]
    reps = lambda t: t.repeat((n_scorers,) + (1,) * (t.ndim - 1))  # noqa
    cands = {k: reps(params[k][None] - lr * block[k]) for k in params}
    x = xs.repeat_interleave(n_block, dim=0)
    y = ys.repeat_interleave(n_block, dim=0)
    logits = model.apply_stacked(cands, x)
    hits = (logits.argmax(-1) == y.argmax(-1)).to(torch.float32)
    return xla_mean(hits, dim=1).reshape(n_scorers, n_block)


def committee_score_matrix(model: Model, params: Params, deltas: Params,
                           lr: float, xs: torch.Tensor, ys: torch.Tensor,
                           committee_mask: torch.Tensor,
                           uploader_mask: torch.Tensor, comm_count: int,
                           k_up: int, chunk: int = 0) -> torch.Tensor:
    """The reference's C x K scoring: only committee shards evaluate, only
    the K uploaded candidates are evaluated; returns the (N, N) matrix,
    nonzero exactly at (committee row, uploader column)."""
    n = xs.shape[0]
    up_idx = _first_k_indices(uploader_mask, k_up)
    comm_idx = _first_k_indices(committee_mask, comm_count)
    part = score_block(model, params, candidate_deltas(deltas, up_idx), lr,
                       xs[comm_idx], ys[comm_idx], chunk)
    mat = torch.zeros((n, n), dtype=torch.float32, device=xs.device)
    mat[comm_idx[:, None], up_idx[None, :]] = part
    return mat


def candidate_deltas(deltas: Params, up_idx: torch.Tensor) -> Params:
    """The uploaders' rows of the stacked deltas, in `up_idx` order."""
    return {k: d[up_idx] for k, d in deltas.items()}


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet ({item}); the "
                               f"port's mesh round runs the committee "
                               f"schedule, plain FedAvg and plain SGD")


def make_sharded_protocol_round(model: Model, *, client_num: int, lr: float,
                                batch_size: int, local_epochs: int,
                                aggregate_count: int, client_chunk: int = 0,
                                remat: bool = False, local_optimizer=None,
                                secure: bool = False,
                                scoring: str = "auto", comm_count: int = 0,
                                needed_update_count: int = 0,
                                expose_candidates: bool = False,
                                ) -> Callable[..., ShardedRoundResult]:
    """Build the round for a fixed geometry.

    Returned fn(params, xs, ys, n_samples, uploader_mask, committee_mask):
    xs (N, S, *feat) and ys (N, S, C) the padded shards, n_samples (N,)
    the true sizes, the masks (N,) bool (tensors or numpy) picking the
    round's K uploaders and C committee members; all tensors on one
    device.  Every client trains.
    """
    if scoring not in ("auto", "committee", "ring"):
        raise ValueError(f"scoring must be 'auto'|'committee'|'ring', "
                         f"got {scoring!r}")
    if scoring == "auto":
        if bool(comm_count) != bool(needed_update_count):
            raise ValueError(
                f"scoring='auto' got a half-specified committee geometry "
                f"(comm_count={comm_count}, needed_update_count="
                f"{needed_update_count}): pass both for the C×K committee "
                f"schedule or neither for the ring fallback")
        scoring = "committee" if comm_count else "ring"
    if scoring == "committee" and not (comm_count and needed_update_count):
        raise ValueError("scoring='committee' needs static comm_count and "
                         "needed_update_count")
    if expose_candidates and scoring != "committee":
        raise ValueError("expose_candidates requires the committee "
                         "scoring schedule (static K)")
    if not (0 <= comm_count <= client_num
            and 0 <= needed_update_count <= client_num):
        raise ValueError(
            f"comm_count {comm_count} / needed_update_count "
            f"{needed_update_count} must be in [0, client_num="
            f"{client_num}]")
    if client_chunk and client_chunk < client_num \
            and client_num % client_chunk:
        raise ValueError(f"clients/device {client_num} not divisible by "
                         f"client_chunk {client_chunk}")
    for asked, what, item in (
            (scoring == "ring", "scoring='ring'", "ROADMAP A7"),
            (secure, "secure aggregation", "ROADMAP A12"),
            (local_optimizer is not None, "local_optimizer", "ROADMAP A11")):
        if asked:
            raise _unported(what, item)
    k = aggregate_count

    def check_masks(uploader_mask: np.ndarray,
                    committee_mask: np.ndarray) -> None:
        # the committee schedule gathers exactly the static C/K slots; a
        # mask whose popcount disagrees would score the wrong clients
        for name, m, want in (("uploader_mask", uploader_mask,
                               needed_update_count),
                              ("committee_mask", committee_mask,
                               comm_count)):
            got = int(m.sum())
            if got != want:
                raise ValueError(
                    f"{name} has {got} True entries but the program was "
                    f"built for a static count of {want}")

    def as_mask(m) -> np.ndarray:
        if isinstance(m, torch.Tensor):
            m = m.detach().cpu().numpy()
        m = np.asarray(m, bool)
        if m.shape != (client_num,):
            raise ValueError(f"masks must be ({client_num},) bool, got "
                             f"{m.shape}")
        return m

    def round_fn(params: Params, xs: torch.Tensor, ys: torch.Tensor,
                 n_samples: torch.Tensor,
                 uploader_mask: Sequence[bool],
                 committee_mask: Sequence[bool]) -> ShardedRoundResult:
        if xs.shape[0] != client_num:
            raise ValueError(f"round built for {client_num} clients, got "
                             f"{xs.shape[0]} shards")
        dev = xs.device
        up_np = as_mask(uploader_mask)
        comm_np = as_mask(committee_mask)
        check_masks(up_np, comm_np)
        up = torch.as_tensor(up_np, device=dev)
        comm = torch.as_tensor(comm_np, device=dev)

        # 1. local training, every client in lockstep (or in sequential
        #    chunks of client_chunk, each step's forward recomputed in the
        #    backward under remat)
        trained, costs = sgd_stacked(model, params, xs, ys, lr=lr,
                                     batch_size=batch_size,
                                     local_epochs=local_epochs,
                                     client_chunk=client_chunk, remat=remat)
        deltas = wire_deltas(params, trained, lr)
        with torch.no_grad():
            # 2. C x K committee scoring -> sparse (N, N) matrix
            score = committee_score_matrix(
                model, params, deltas, lr, xs, ys, comm, up, comm_count,
                needed_update_count, client_chunk)
            # 3. the decision, as the reference takes it replicated
            med, order, sel, g_loss = decide(score, comm, up, costs, k)
            # 4. masked sample-weighted FedAvg (one shard: no psum)
            new_params = apply_selection(params, deltas, n_samples, sel,
                                         lr, trained=trained)
            # 5. payload ids of every delta and of the new model
            delta_fps = fingerprint_stacked(deltas)
            params_fp = fingerprint_pytree(new_params)
            # 6. the K uploaded deltas, ascending uploader id
            cands = (candidate_deltas(deltas, _first_k_indices(
                up, needed_update_count)) if expose_candidates else ())
        return ShardedRoundResult(new_params, score, med, sel, order, costs,
                                  g_loss, delta_fps, params_fp, cands)

    return round_fn
