"""The mesh runtime: the protocol with a device-resident data plane.

Port of `bflc_demo_tpu/client/mesh_runtime.py:run_federated_mesh`
(:271-561) and `_run_batched` (:141-268), on one card: each round is one
call of `parallel.fedavg`'s round (the slots train, the committee scores
the K uploaders, the decision, the FedAvg and the payload ids, all on
the device), and the host exchanges only the committee's score rows, the
32-byte ids and the commit hash.  The ledger stays the authority:
`client.staging.audit_round` replays every round into it and raises if
its decision differs from the device's.

participation (:309-313):
- 'full': every registered client trains each round; device slots are
  client ids, and the shards go to the card once;
- 'active': only the round's K uploaders and C committee members hold
  slots, uploaders first, each group in ascending client order, so the
  round's masks are static (`[True]*K + [False]*C` and the reverse).
  Every client is staged once (the padding is the largest shard of ALL
  clients, so it does not depend on the round, :495-499) and each round
  copies its participants' padded shards and true sizes to the card.
  The audit maps slot rows back to client ids (`up_slots`,
  `comm_slots`).

Uploader choice keeps the reference's numpy draw — a seeded permutation
of the round's trainers, first K, in ascending client order — so ledger
slot order equals the device's index-ascending tiebreak.

`client_chunk` and `remat` go to the round (`parallel/fedavg.py`).

Score attestation (:73-98, :341-353, :524-528): with `attest_wallets`
(one `comm.identity.Wallet` per client) every committee member's
wallet signs its score row — the `scores` op payload, the row as
little-endian f64 — before the round reaches the ledger; each signature
is verified and `SimulationResult.attest_log[epoch]` holds them by
address.  `attest_scores=None` means on exactly when wallets exist,
True without wallets raises, False opts out.  In process this is
signature evidence, not a second trust domain: the mesh executor
(`comm/executor_service.py`) has members re-score on their own shards.

`local_optimizer` (a `core.optim` transform) drives every client's
local steps in the round program, one state a client, fresh each round
(:398).

rounds_per_dispatch R > 1 (full participation only, no local
optimizer, `rounds % R == 0`, as in the reference): R rounds run as one
dispatch of `parallel.fedavg.make_multi_round_program` (the uploader
draw, the election and the sponsor's evaluation on the device, one key
of `utils.prng.split(PRNGKey(seed))` a dispatch); the dispatch's stacked
artifacts come to the host in one copy, and each round is replayed into
the ledger, which raises on any committee or selection divergence (the
reference's audit), its committee rows attested first when attestation
is on.  `SimulationResult.round_times_s` gives each round of a dispatch
the dispatch's seconds over R, the replay and audit included.

`ledger_backend` is the reference's: "auto" gives the native ledger
where `ledger.make_ledger` does.

Checkpoints and resume (:250-254, :407-413, :540-543): with
`checkpoint_dir` and `checkpoint_every` N the model and the ledger's op
log go to `checkpoint_dir` (`utils/checkpoint.py`, extra `{"acc"}`)
after every round whose next epoch is a multiple of N, and with R > 1
after every dispatch (the state is consistent only at a dispatch's
end).  `resume_ledger` (from `load_checkpoint`) continues a run: it
needs `initial_params`, registers no one, and the run goes on at the
ledger's epoch with its committee.

Secure aggregation (:101-116, :144-186, :439-503): with
`secure_aggregation` every round's merge is the pairwise-masked
fixed-point one (`parallel/secure.py`, kernel B7 on the card), clipped at
`secure_clip`.  With `secure_wallets` (one `comm.identity.Wallet` a
client) the masks are keyed by per-pair X25519 seeds over the round's
slot occupants (`derive_pair_seeds`, the epoch bound into the KDF), so
the aggregator cannot strip them; without, by one shared key drawn from
OS entropy at the run's start (`_fresh_mask_key`, never from `seed`: its
mask bits are not reproducible, by design; the merged model is, because
the masks cancel) with the epoch folded in.  A dispatch of R rounds
takes one pair-seed matrix (or one fresh key) and re-keys each round by
its counter.  Attestation wallets default to `secure_wallets`, so the
score rows of a secure run are signed whenever wallets exist.

Not ported, and refused with the ROADMAP item rather than ignored:
`estimate_flops` (A11).
"""

from __future__ import annotations

import os
import struct
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from bflc_demo_tpu_torch.client.runtime import Sponsor, feature_tensor
from bflc_demo_tpu_torch.client.simulation import SimulationResult
from bflc_demo_tpu_torch.client.staging import (audit_round,
                                                stage_padded_arrays)
from bflc_demo_tpu_torch.data.partition import one_hot
from bflc_demo_tpu_torch.device import DeviceLike, resolve_device
from bflc_demo_tpu_torch.ledger import LedgerStatus, make_ledger
from bflc_demo_tpu_torch.models.base import Model, Params
from bflc_demo_tpu_torch.ops.fingerprint import fingerprint_to_bytes
from bflc_demo_tpu_torch.parallel.fedavg import (make_multi_round_program,
                                                 make_sharded_protocol_round)
from bflc_demo_tpu_torch.parallel.secure import derive_pair_seeds
from bflc_demo_tpu_torch.protocol.constants import (DEFAULT_PROTOCOL,
                                                    ProtocolConfig)
from bflc_demo_tpu_torch.utils import prng
from bflc_demo_tpu_torch.utils.checkpoint import save_checkpoint


def _addr(i: int) -> str:
    return f"0x{i:040x}"


def _attest_rows(wallets, committee_ids, comm_slots, up_slots, score_rows,
                 epoch: int, attest_log: dict) -> None:
    """Wallet-sign each committee member's score row before it reaches
    the ledger; each signature verified, recorded in attest_log[epoch].
    A signature that does not verify aborts the round."""
    from bflc_demo_tpu_torch.comm.identity import (_op_bytes,
                                                   verify_signature)
    sigs = {}
    for cid, cs in zip(committee_ids, comm_slots):
        row = [float(score_rows[cs, us]) for us in up_slots]
        payload = struct.pack(f"<{len(row)}d", *row)
        msg = _op_bytes("scores", _addr(cid), epoch, payload)
        w = wallets[cid]
        tag = w.sign(msg)
        if not verify_signature(w.public_bytes, msg, tag):
            raise RuntimeError(
                f"epoch {epoch}: committee member {cid}'s score-row "
                f"attestation failed verification — refusing the round")
        sigs[_addr(cid)] = tag.hex()
    attest_log[epoch] = sigs


def _fresh_mask_key() -> np.ndarray:
    """A shared-key secure run's mask key from 64 bits of OS entropy:
    never from the public run seed (a seed-derived key would let anyone
    who knows the config unmask a delta)."""
    w = int.from_bytes(os.urandom(8), "little")
    return prng.fold_in(np.array([0, w & 0xFFFFFFFF], np.uint32), w >> 32)


def to_host(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """numpy copies of `tensors` through one device-to-host copy: their
    bytes are concatenated on the device, copied once, and split."""
    flat = [t.detach().contiguous().reshape(-1).view(torch.uint8)
            for t in tensors]
    blob = torch.cat(flat).cpu().numpy()
    out, off = [], 0
    for t, f in zip(tensors, flat):
        dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
        out.append(blob[off:off + f.numel()].view(dtype)
                   .reshape(tuple(t.shape)))
        off += f.numel()
    return out


def _run_batched(model, cfg, ledger, params, xs, ys, ns, sponsor, rounds,
                 rounds_per_dispatch, seed, client_chunk, remat, sizes_np,
                 attest_scores, attest_wallets, attest_log, checkpoint_dir,
                 checkpoint_every, verbose, secure=False,
                 secure_wallets=None,
                 secure_clip=1024.0) -> SimulationResult:
    """R rounds a dispatch, each replayed into the ledger and audited
    afterwards: the ledger stays the authority, and a ledger decision
    that differs from the device's raises.  A secure dispatch takes one
    pair-seed matrix (the dispatch's first epoch bound in) or one fresh
    mask key."""
    n = cfg.client_num
    dh = secure_wallets is not None
    program = make_multi_round_program(
        model, client_num=n, lr=cfg.learning_rate,
        batch_size=cfg.batch_size, local_epochs=cfg.local_epochs,
        aggregate_count=cfg.aggregate_count, comm_count=cfg.comm_count,
        needed_update_count=cfg.needed_update_count,
        rounds_per_dispatch=rounds_per_dispatch,
        client_chunk=client_chunk, remat=remat, secure=secure,
        secure_dh=dh, secure_clip=secure_clip)
    loss_history, round_times = [], []
    t0 = time.perf_counter()
    key = prng.PRNGKey(seed)
    for _ in range(rounds // rounds_per_dispatch):
        dt0 = time.perf_counter()
        comm_mask0 = np.zeros(n, bool)
        comm_mask0[[int(a, 16) for a in ledger.committee()]] = True
        key, sub = prng.split(key)
        mask_arg = ()
        if secure:
            # the mask argument, independent of the public sampling key
            mask_arg = ((derive_pair_seeds(secure_wallets, ledger.epoch)
                         if dh else _fresh_mask_key()),)
        res = program(params, xs, ys, ns, comm_mask0, sub, sponsor.x,
                      sponsor.y, *mask_arg)
        params = res.params
        # the dispatch's artifacts to the host, in one copy
        up_masks, comm_masks, score_ms, sels, costs, dfps, pfps, accs = \
            to_host([res.uploader_masks, res.committee_masks,
                     res.score_matrices, res.selected, res.avg_costs,
                     res.delta_fps, res.params_fps, res.test_accs])
        for r in range(rounds_per_dispatch):
            epoch = ledger.epoch
            ledger_comm = sorted(int(a, 16) for a in ledger.committee())
            device_comm = np.flatnonzero(comm_masks[r]).tolist()
            if ledger_comm != device_comm:
                raise RuntimeError(
                    f"committee divergence at epoch {epoch}: "
                    f"ledger={ledger_comm} device={device_comm}")
            uploader_ids = np.flatnonzero(up_masks[r]).tolist()
            if attest_scores:
                # full participation: slot ids are client ids
                _attest_rows(attest_wallets, ledger_comm, ledger_comm,
                             uploader_ids, score_ms[r], epoch, attest_log)
            for cid in uploader_ids:
                st = ledger.upload_local_update(
                    _addr(cid), fingerprint_to_bytes(dfps[r, cid]),
                    int(sizes_np[cid]), float(costs[r, cid]), epoch)
                if st != LedgerStatus.OK:
                    raise RuntimeError(f"upload rejected: {st.name}")
            for cid in ledger_comm:
                st = ledger.upload_scores(
                    _addr(cid), epoch,
                    [float(score_ms[r, cid, u]) for u in uploader_ids])
                if st != LedgerStatus.OK:
                    raise RuntimeError(f"scores rejected: {st.name}")
            pending = ledger.pending()
            sel_ledger = np.sort([uploader_ids[s] for s in pending.selected])
            sel_device = np.flatnonzero(sels[r])
            if not np.array_equal(sel_ledger, sel_device):
                raise RuntimeError(
                    f"selection divergence at epoch {epoch}: "
                    f"ledger={sel_ledger} device={sel_device}")
            st = ledger.commit_model(fingerprint_to_bytes(pfps[r]), epoch)
            if st != LedgerStatus.OK:
                raise RuntimeError(f"commit rejected: {st.name}")
            loss_history.append((epoch, ledger.last_global_loss))
            sponsor.history.append((epoch, float(accs[r])))
            if verbose:
                print(f"Epoch: {epoch:03d}, test_acc: {float(accs[r]):.4f}, "
                      f"global_loss: {ledger.last_global_loss:.5f}")
        # each round's share of the dispatch, the replay and audit
        # included, comparable with the one-round-a-dispatch path
        total = time.perf_counter() - dt0
        round_times.extend([total / rounds_per_dispatch]
                           * rounds_per_dispatch)
        if checkpoint_dir and checkpoint_every:
            # dispatch-granular: params and ledger agree at a dispatch's
            # end (the epoch after its last replayed round)
            save_checkpoint(checkpoint_dir, params, ledger,
                            extra={"acc": float(accs[-1])})
    return SimulationResult(
        accuracy_history=sponsor.history,
        loss_history=loss_history,
        final_params=params,
        rounds_completed=rounds,
        wall_time_s=time.perf_counter() - t0,
        round_times_s=round_times,
        ledger_log_head=ledger.log_head(),
        ledger_log_size=ledger.log_size(),
        ledger=ledger,
        n_devices=1,
        attest_log=attest_log or None)


def run_federated_mesh(model: Model,
                       shards: Sequence[Tuple[np.ndarray, np.ndarray]],
                       test_set: Tuple[np.ndarray, np.ndarray],
                       cfg: ProtocolConfig = DEFAULT_PROTOCOL,
                       rounds: int = 10,
                       ledger_backend: str = "auto",
                       seed: int = 0,
                       init_seed: int = 0,
                       participation: str = "full",
                       client_chunk: int = 0,
                       remat: bool = False,
                       rounds_per_dispatch: int = 1,
                       initial_params: Optional[Params] = None,
                       resume_ledger=None,
                       checkpoint_dir: str = "",
                       checkpoint_every: int = 0,
                       secure_aggregation: bool = False,
                       secure_wallets=None,
                       # each delta's clip: above honest update
                       # magnitudes, below the 2**15 fixed-point capacity
                       secure_clip: float = 1024.0,
                       attest_scores: Optional[bool] = None,
                       attest_wallets=None,
                       estimate_flops: bool = False,
                       local_optimizer=None,
                       device: DeviceLike = None,
                       verbose: bool = False) -> SimulationResult:
    """Run `rounds` protocol rounds, one device round each.

    shards: per-client (x, y) with integer class labels; test_set likewise.
    initial_params: start from these values (for example the
    reference's, through `Model.params_from_jax`, or a checkpoint's)
    instead of `model.init_params`.
    resume_ledger: a replayed ledger (`utils.checkpoint.load_checkpoint`)
    to continue from; needs the params.
    device: None means `cuda` (raises without a card); "cpu" runs the
    plain versions of the kernels on the CPU.
    """
    cfg.validate()
    if estimate_flops and (secure_aggregation or rounds_per_dispatch > 1):
        raise ValueError("estimate_flops is only supported on the plain "
                         "per-round path (rounds_per_dispatch=1, no "
                         "secure aggregation)")
    if secure_wallets is not None and len(secure_wallets) != cfg.client_num:
        raise ValueError(f"need {cfg.client_num} wallets, "
                         f"got {len(secure_wallets)}")
    # attestation: on exactly when wallets exist (the secure run's too);
    # an explicit False opts out
    if attest_wallets is None:
        attest_wallets = secure_wallets
    if attest_scores is None:
        attest_scores = attest_wallets is not None
    if attest_scores and attest_wallets is None:
        raise ValueError("attest_scores=True needs wallets "
                         "(attest_wallets or secure_wallets)")
    if attest_wallets is not None and len(attest_wallets) != cfg.client_num:
        raise ValueError(f"need {cfg.client_num} attest wallets, "
                         f"got {len(attest_wallets)}")
    attest_log: dict = {}
    if participation not in ("full", "active"):
        raise ValueError(f"participation must be 'full'|'active', "
                         f"got {participation!r}")
    if rounds_per_dispatch > 1:
        # fail fast, before any staging or program construction
        if local_optimizer is not None:
            raise ValueError("local_optimizer requires "
                             "rounds_per_dispatch=1")
        if participation != "full":
            raise ValueError("rounds_per_dispatch requires "
                             "participation='full'")
        if rounds % rounds_per_dispatch:
            raise ValueError(f"rounds {rounds} must be a multiple of "
                             f"rounds_per_dispatch {rounds_per_dispatch}")
    if resume_ledger is not None and initial_params is None:
        raise ValueError("resume_ledger requires initial_params")
    if estimate_flops:
        raise NotImplementedError("estimate_flops is not ported yet "
                                  "(ROADMAP A11); the port's mesh runtime "
                                  "measures no flops")
    dev = resolve_device(device)
    n = cfg.client_num
    if len(shards) != n:
        raise ValueError(f"need {n} shards, got {len(shards)}")
    k, c = cfg.needed_update_count, cfg.comm_count
    n_slots = n if participation == "full" else k + c

    nc = model.num_classes
    model = model.to(dev)
    xs_np, ys_np, sizes_np = stage_padded_arrays(
        [sx for sx, _ in shards], [sy for _, sy in shards], nc)

    def to_card(slots):
        """The slots' padded shards, one-hot labels and true sizes."""
        return (feature_tensor(xs_np[slots], dev),
                torch.as_tensor(ys_np[slots], device=dev),
                torch.as_tensor(sizes_np[slots], dtype=torch.int32,
                                device=dev))

    if participation == "full":
        xs, ys, ns = to_card(slice(None))
    else:
        static_uploader = np.array([True] * k + [False] * c)
        static_committee = ~static_uploader
    if rounds_per_dispatch <= 1:    # the batched path builds its own
        round_fn = make_sharded_protocol_round(
            model, client_num=n_slots, lr=cfg.learning_rate,
            batch_size=cfg.batch_size, local_epochs=cfg.local_epochs,
            aggregate_count=cfg.aggregate_count, client_chunk=client_chunk,
            remat=remat, local_optimizer=local_optimizer,
            secure=secure_aggregation,
            secure_dh=secure_wallets is not None, secure_clip=secure_clip,
            comm_count=c, needed_update_count=k)

    xte, yte = test_set
    sponsor = Sponsor(model, feature_tensor(xte, dev),
                      torch.as_tensor(one_hot(yte, nc), device=dev))
    rng = np.random.default_rng(seed)
    params = ({key: v.to(dev) for key, v in initial_params.items()}
              if initial_params is not None else model.init_params(
                  init_seed, dev))
    if resume_ledger is not None:
        # continue from a replayed ledger and its saved model: the
        # reference's "chain restart resumes exactly"
        ledger = resume_ledger
        if ledger.epoch < 0:
            raise RuntimeError("resume ledger has not started FL")
    else:
        ledger = make_ledger(cfg, backend=ledger_backend)
        for i in range(n):
            ledger.register_node(_addr(i))
        if ledger.epoch != 0:
            raise RuntimeError(f"FL did not start (epoch={ledger.epoch})")
    if rounds_per_dispatch > 1:
        return _run_batched(model, cfg, ledger, params, xs, ys, ns, sponsor,
                            rounds, rounds_per_dispatch, seed, client_chunk,
                            remat, sizes_np, attest_scores, attest_wallets,
                            attest_log, checkpoint_dir, checkpoint_every,
                            verbose, secure_aggregation, secure_wallets,
                            secure_clip)
    # shared-key secure mode: one OS-entropy run key, the epoch folded in
    # each round
    run_mask_key = (_fresh_mask_key()
                    if secure_aggregation and secure_wallets is None
                    else None)

    loss_history, round_times = [], []
    t0 = time.perf_counter()
    for _ in range(rounds):
        rt0 = time.perf_counter()
        epoch = ledger.epoch
        committee_ids = sorted(int(a, 16) for a in ledger.committee())
        trainer_ids = [i for i in range(n) if i not in committee_ids]
        pick = rng.permutation(len(trainer_ids))[:k]
        uploader_ids = sorted(trainer_ids[int(j)] for j in pick)
        slot_clients = (list(range(n)) if participation == "full"
                        else uploader_ids + committee_ids)
        secure_key = ()
        if secure_aggregation:
            # keyed over the round's slot occupants: every slot takes
            # part in the masked sum, so the pairs span exactly them
            secure_key = ((derive_pair_seeds(
                [secure_wallets[i] for i in slot_clients], epoch)
                if secure_wallets is not None
                else prng.fold_in(run_mask_key, epoch)),)
        if participation == "full":
            uploader_mask = np.zeros(n, bool)
            uploader_mask[uploader_ids] = True
            committee_mask = np.zeros(n, bool)
            committee_mask[committee_ids] = True
            res = round_fn(params, xs, ys, ns, uploader_mask, committee_mask,
                           *secure_key)
            up_slots, comm_slots = uploader_ids, committee_ids
        else:
            # this round's participants onto the card; slots [uploaders
            # asc | committee asc], so the masks stay static
            res = round_fn(params, *to_card(slot_clients),
                           static_uploader, static_committee, *secure_key)
            up_slots, comm_slots = list(range(k)), list(range(k, k + c))
        params = res.params
        # host side: the tiny artifacts only; slot rows map to client ids
        score_rows = res.score_matrix.cpu().numpy()
        if attest_scores:
            # the ledger only accepts attested rounds
            _attest_rows(attest_wallets, committee_ids, comm_slots,
                         up_slots, score_rows, epoch, attest_log)
        audit_round(ledger, _addr, epoch, uploader_ids, committee_ids,
                    up_slots, comm_slots, res.delta_fps.cpu().numpy(),
                    lambda cid: sizes_np[cid], res.avg_costs.cpu().numpy(),
                    score_rows,
                    np.flatnonzero(res.selected.cpu().numpy()),
                    res.params_fp.cpu().numpy())
        loss_history.append((epoch, ledger.last_global_loss))
        acc = sponsor.observe(epoch, params)     # syncs the device
        round_times.append(time.perf_counter() - rt0)
        if checkpoint_dir and checkpoint_every and \
                ledger.epoch % checkpoint_every == 0:
            save_checkpoint(checkpoint_dir, params, ledger,
                            extra={"acc": acc})
        if verbose:
            print(f"Epoch: {epoch:03d}, test_acc: {acc:.4f}, "
                  f"global_loss: {ledger.last_global_loss:.5f}")

    return SimulationResult(
        accuracy_history=sponsor.history,
        loss_history=loss_history,
        final_params=params,
        rounds_completed=rounds,
        wall_time_s=time.perf_counter() - t0,
        round_times_s=round_times,
        ledger_log_head=ledger.log_head(),
        ledger_log_size=ledger.log_size(),
        ledger=ledger,
        n_devices=1,
        attest_log=attest_log or None)
