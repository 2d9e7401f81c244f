"""The FL round as one program on one card: train, score, decide, merge.

Port of `bflc_demo_tpu/parallel/fedavg.py:make_sharded_protocol_round`
(:261-494) with both scoring schedules (`committee_score_matrix`
:187-240, `ring_score_matrix` :125-153, `_score_block` :101-122), and
of `make_multi_round_program` (:497-697), on one card.  The reference's
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
   with `secure` it is the pairwise-masked fixed-point merge
   (`parallel/secure.py:secure_fedavg_body`, kernel B7 on the card,
   :407-414), keyed by the round's trailing argument: a `utils.prng` key
   (shared-key mode) or, with `secure_dh`, the (N, N, 8) X25519 pair
   seeds;
5. the payload ids of all N deltas and of the new model come from the
   fingerprint kernel (`ops/fingerprint.py`, two launches);
6. with `expose_candidates` the K uploaded deltas, stacked in ascending
   uploader id (:425-433): the reference all-gathers them over the
   client axis, one card indexes its stacked deltas with the scoring's
   own `_first_k_indices`.  They are the evidence committee members
   re-score to attest their rows (`comm/executor_service.py`).

Scoring: "committee" is the reference's C x K; "ring" has every client
score every candidate, the dense (N, N) matrix, which on one card is the
reference's ring in one step (`ring_score_matrix`); "auto" is committee
when both static counts are given, else ring.

`make_sharded_protocol_round` checks what the reference checks (the
scoring schedule, the static committee geometry, client_chunk
divisibility).  `local_optimizer` (a
`core.optim` transform) drives every client's local steps, one
optimizer state a client stacked on the client axis and fresh each
round, as the reference's per-client `local_train_impl` (:334-340); the
deltas stay `(params - trained) / lr`.
The memory controls are ported: `client_chunk` trains the slots, and
scores, in sequential chunks, and `remat` recomputes each training
step's forward in its backward (`core.local_train.sgd_stacked`).  Under
the committee schedule the returned function checks the masks'
popcounts against the static counts, as the reference's `_check_masks`
(:448-472) does.

`make_multi_round_program` runs R protocol rounds a dispatch with no
host sync inside: each round draws its K uploaders on the device (the
host draws the dispatch's R uniform vectors with `utils/prng`, which do
not depend on device state, and uploads them once; the committee's
entries go to -inf on the card and the top K of a stable sort win),
trains, scores (committee or ring), decides, merges, fingerprints,
elects the next committee (`order[:comm_count]`) and evaluates the
sponsor's accuracy; every gather is a static-K stable sort, never a
boolean mask.  With `secure` each round's merge is the masked one
(:518-552, :641-649), keyed by the dispatch's trailing argument (a fresh
key, or one pair-seed matrix) with round r of the dispatch folded in as
`round_tweak`: into the key in shared-key mode, into each pair's chain
in DH mode.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from bflc_demo_tpu_torch.core.aggregate import (apply_selection, decide,
                                                rank_desc_stable)
from bflc_demo_tpu_torch.core.local_train import (evaluate, sgd_stacked,
                                                  wire_deltas)
from bflc_demo_tpu_torch.core.losses import xla_mean
from bflc_demo_tpu_torch.core.optim import check_optimizer
from bflc_demo_tpu_torch.device import upload
from bflc_demo_tpu_torch.models.base import Model, Params
from bflc_demo_tpu_torch.ops.fingerprint import (fingerprint_pytree,
                                                 fingerprint_stacked)
from bflc_demo_tpu_torch.parallel.secure import secure_fedavg_body
from bflc_demo_tpu_torch.utils import prng


class MultiRoundResult(NamedTuple):
    params: Params              # model after the last round
    uploader_masks: torch.Tensor   # (R, N) bool, the device's draw
    committee_masks: torch.Tensor  # (R, N) bool, the committee a round
    score_matrices: torch.Tensor   # (R, N, N)
    medians: torch.Tensor       # (R, N)
    selected: torch.Tensor      # (R, N) bool
    orders: torch.Tensor        # (R, N)
    avg_costs: torch.Tensor     # (R, N)
    global_losses: torch.Tensor  # (R,)
    delta_fps: torch.Tensor     # (R, N, 8) fingerprints (uint32 words)
    params_fps: torch.Tensor    # (R, 8) the model's after each round
    test_accs: torch.Tensor     # (R,) sponsor accuracy after each round


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
    # each scorer's shard n_block times, scorer-major (an expand: no
    # repeat count to read back)
    x = xs[:, None].expand(n_scorers, n_block, *xs.shape[1:]).reshape(
        n_scorers * n_block, *xs.shape[1:])
    y = ys[:, None].expand(n_scorers, n_block, *ys.shape[1:]).reshape(
        n_scorers * n_block, *ys.shape[1:])
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


def ring_score_matrix(model: Model, params: Params, deltas: Params,
                      lr: float, xs: torch.Tensor, ys: torch.Tensor,
                      chunk: int = 0) -> torch.Tensor:
    """(N, N) scorer x candidate: every client scores every candidate.
    The reference passes candidate blocks around a ring of devices; on
    one card the ring has one step, the whole block, scored as one
    stacked apply (in chunks of `chunk` scorers)."""
    return score_block(model, params, deltas, lr, xs, ys, chunk)


def candidate_deltas(deltas: Params, up_idx: torch.Tensor) -> Params:
    """The uploaders' rows of the stacked deltas, in `up_idx` order."""
    return {k: d[up_idx] for k, d in deltas.items()}


def make_sharded_protocol_round(model: Model, *, client_num: int, lr: float,
                                batch_size: int, local_epochs: int,
                                aggregate_count: int, client_chunk: int = 0,
                                remat: bool = False, local_optimizer=None,
                                secure: bool = False,
                                secure_dh: bool = False,
                                secure_clip: float = 64.0,
                                scoring: str = "auto", comm_count: int = 0,
                                needed_update_count: int = 0,
                                expose_candidates: bool = False,
                                ) -> Callable[..., ShardedRoundResult]:
    """Build the round for a fixed geometry.

    Returned fn(params, xs, ys, n_samples, uploader_mask, committee_mask)
    — plus a trailing `secure_key` with `secure`: a `utils.prng` key, or
    the (N, N, 8) pair seeds with `secure_dh` — xs (N, S, *feat) and ys
    (N, S, C) the padded shards, n_samples (N,) the true sizes, the
    masks (N,) bool (tensors or numpy) picking the round's K uploaders
    and C committee members; all tensors on one device.  Every client
    trains.
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
    check_optimizer(local_optimizer)
    k = aggregate_count

    def check_masks(uploader_mask: np.ndarray,
                    committee_mask: np.ndarray) -> None:
        # the committee schedule gathers exactly the static C/K slots; a
        # mask whose popcount disagrees would score the wrong clients
        if scoring != "committee":
            return
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
                 committee_mask: Sequence[bool],
                 *secure_key) -> ShardedRoundResult:
        if len(secure_key) != int(secure):
            raise TypeError("the secure round takes one trailing key (a "
                            "prng key or the pair seeds); the plain round "
                            "none")
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
                                     client_chunk=client_chunk, remat=remat,
                                     optimizer=local_optimizer)
        deltas = wire_deltas(params, trained, lr)
        with torch.no_grad():
            # 2. C x K committee scoring -> sparse (N, N) matrix, or the
            #    dense ring
            if scoring == "committee":
                score = committee_score_matrix(
                    model, params, deltas, lr, xs, ys, comm, up, comm_count,
                    needed_update_count, client_chunk)
            else:
                score = ring_score_matrix(model, params, deltas, lr, xs, ys,
                                          client_chunk)
            # 3. the decision, as the reference takes it replicated
            med, order, sel, g_loss = decide(score, comm, up, costs, k)
            # 4. masked sample-weighted FedAvg (one shard: no psum),
            #    pairwise-blinded fixed point in secure mode
            if secure:
                new_params = secure_fedavg_body(
                    params, deltas, n_samples, sel, lr, secure_key[0],
                    clip=secure_clip, dh_mode=secure_dh)
            else:
                new_params = apply_selection(params, deltas, n_samples,
                                             sel, lr, trained=trained)
            # 5. payload ids of every delta and of the new model
            delta_fps = fingerprint_stacked(deltas)
            params_fp = fingerprint_pytree(new_params)
            # 6. the K uploaded deltas, ascending uploader id
            cands = (candidate_deltas(deltas, _first_k_indices(
                up, needed_update_count)) if expose_candidates else ())
        return ShardedRoundResult(new_params, score, med, sel, order, costs,
                                  g_loss, delta_fps, params_fp, cands)

    return round_fn


def draw_uniforms(rng_key: np.ndarray, rounds: int, n: int) -> np.ndarray:
    """(rounds, n) float32: `jax.random.uniform(k, (n,))` for each key k
    of `jax.random.split(rng_key, rounds)`, the reference's per-round
    uploader draw (:590, :680)."""
    return np.stack([prng.uniform(k, (n,))
                     for k in prng.split(rng_key, rounds)])



def make_multi_round_program(model: Model, *, client_num: int, lr: float,
                             batch_size: int, local_epochs: int,
                             aggregate_count: int, comm_count: int,
                             needed_update_count: int,
                             rounds_per_dispatch: int,
                             client_chunk: int = 0, remat: bool = False,
                             secure: bool = False,
                             secure_dh: bool = False,
                             secure_clip: float = 1024.0,
                             scoring: str = "committee",
                             ) -> Callable[..., MultiRoundResult]:
    """R protocol rounds as one dispatch, the amortised data plane.

    Returned fn(params, xs, ys, n_samples, committee_mask0, rng_key,
    xte, yte) — plus a trailing mask key (or, with `secure_dh`, the pair
    seeds) with `secure`, never derived from `rng_key`, the public
    uploader draw's key — the padded shards and true sizes as for the
    one-round
    program, committee_mask0 (N,) bool the ledger's committee at the
    dispatch's start, rng_key a `utils.prng` key (the reference's
    `jax.random.PRNGKey` split per dispatch), (xte, yte) the sponsor's
    test set (one-hot labels).  Per round, in the reference's order
    (:586-668): the uploader draw, training, scoring, the decision, the
    FedAvg merge, the fingerprints, the next committee, the sponsor's
    accuracy.  The host ledger replays and audits every round afterwards
    (`client/mesh_runtime.py`), as in the reference.
    """
    if needed_update_count < comm_count:
        # the device election takes the top comm_count of the K uploader
        # slots; with K < comm_count it would seat non-uploaders the
        # ledger never elects, a certain audit divergence
        raise ValueError(
            f"needed_update_count ({needed_update_count}) must be >= "
            f"comm_count ({comm_count}) for the batched multi-round program")
    if client_num - comm_count < needed_update_count:
        # committee members are excluded from the draw: with fewer than K
        # candidates the top-K mask would hold fewer than K entries
        raise ValueError(
            f"client_num - comm_count ({client_num - comm_count}) must be "
            f">= needed_update_count ({needed_update_count}): the uploader "
            f"draw excludes committee members")
    if scoring not in ("committee", "ring"):
        raise ValueError(f"scoring must be 'committee'|'ring', "
                         f"got {scoring!r}")
    if client_chunk and client_chunk < client_num \
            and client_num % client_chunk:
        raise ValueError(f"clients/device {client_num} not divisible by "
                         f"client_chunk {client_chunk}")
    n, k_up, rounds = client_num, needed_update_count, rounds_per_dispatch

    def program(params: Params, xs: torch.Tensor, ys: torch.Tensor,
                n_samples: torch.Tensor, committee_mask0,
                rng_key: np.ndarray, xte: torch.Tensor,
                yte: torch.Tensor, *mask_arg) -> MultiRoundResult:
        if len(mask_arg) != int(secure):
            raise TypeError("the secure program takes one trailing mask "
                            "key (or the pair seeds); the plain one none")
        if xs.shape[0] != n:
            raise ValueError(f"program built for {n} clients, got "
                             f"{xs.shape[0]} shards")
        dev = xs.device
        comm0 = np.asarray(committee_mask0, bool)
        if comm0.shape != (n,) or int(comm0.sum()) != comm_count:
            raise ValueError(f"committee_mask0 must be ({n},) bool with "
                             f"{comm_count} True entries")
        # the dispatch's inputs from the host, once: R uniform vectors
        # and the starting committee
        draws = upload(draw_uniforms(rng_key, rounds, n), dev)
        comm = upload(comm0, dev)
        outs = []
        for r in range(rounds):
            # the uploader draw: top K of the uniforms over the trainers
            # (committee at -inf), the index-ascending stable order
            not_comm = ~comm
            up = (torch.sort(rank_desc_stable(draws[r], not_comm),
                             stable=True).indices < k_up) & not_comm
            trained, costs = sgd_stacked(
                model, params, xs, ys, lr=lr, batch_size=batch_size,
                local_epochs=local_epochs, client_chunk=client_chunk,
                remat=remat)
            deltas = wire_deltas(params, trained, lr)
            with torch.no_grad():
                if scoring == "committee":
                    score = committee_score_matrix(
                        model, params, deltas, lr, xs, ys, comm, up,
                        comm_count, k_up, client_chunk)
                else:
                    score = ring_score_matrix(model, params, deltas, lr,
                                              xs, ys, client_chunk)
                med, order, sel, g_loss = decide(score, comm, up, costs,
                                                 aggregate_count)
                if secure:
                    # the round counter re-keys every round's masks
                    new_params = secure_fedavg_body(
                        params, deltas, n_samples, sel, lr, mask_arg[0],
                        clip=secure_clip, dh_mode=secure_dh, round_tweak=r)
                else:
                    new_params = apply_selection(params, deltas, n_samples,
                                                 sel, lr, trained=trained)
                delta_fps = fingerprint_stacked(deltas)
                params_fp = fingerprint_pytree(new_params)
                # the next committee (.cpp:443-455): the top comm_count
                # uploader slots; K >= comm_count, so all are uploaders
                electees = order[:comm_count]
                comm_next = torch.zeros(n, dtype=torch.bool,
                                        device=dev).scatter(
                    0, electees, torch.ones_like(electees, dtype=torch.bool))
                acc = evaluate(model, new_params, xte, yte)
            outs.append((up, comm, score, med, sel, order, costs, g_loss,
                         delta_fps, params_fp, acc))
            params, comm = new_params, comm_next
        return MultiRoundResult(params, *(torch.stack(f) for f in zip(*outs)))

    return program
