"""In-process federated simulation — the host runtime.

Port of `bflc_demo_tpu/client/simulation.py` (`run_federated`,
`SimulationResult`): coordinator in-process, N logical clients
time-multiplexed on one device, the full committee protocol and the
sponsor's eval.  Client visit order per round comes from
`np.random.default_rng(seed).permutation`, as in the reference — the
order is protocol (it decides who beats the first-come cap), so it stays
numpy.

Added for cross-framework runs: `init_params` starts from given values
(for example the reference's, through `Model.params_from_jax`) instead of
the port's own seeded init.  `SimulationResult.n_devices` is 1: the port
runs every runtime on one card; `attest_log` is the mesh runtime's
signed committee rows (`client/mesh_runtime.py`).  `local_optimizer` is
the reference's: a `core.optim` transform for every client's local
steps (None = plain SGD).  Dropped: the mesh-only result fields
`flops_per_round` and `mfu` (their features are not ported).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bflc_demo_tpu_torch.client.runtime import (ComputePlane, FLNode, Sponsor,
                                                feature_tensor)
from bflc_demo_tpu_torch.comm.store import UpdateStore
from bflc_demo_tpu_torch.core.optim import check_optimizer
from bflc_demo_tpu_torch.data.partition import one_hot
from bflc_demo_tpu_torch.device import DeviceLike, resolve_device
from bflc_demo_tpu_torch.ledger import make_ledger
from bflc_demo_tpu_torch.models.base import Model, Params
from bflc_demo_tpu_torch.protocol.constants import (DEFAULT_PROTOCOL,
                                                    ProtocolConfig)


@dataclasses.dataclass
class SimulationResult:
    accuracy_history: List[Tuple[int, float]]   # sponsor (epoch, test_acc)
    loss_history: List[Tuple[int, float]]       # ledger (epoch, global_loss)
    final_params: Params
    rounds_completed: int
    wall_time_s: float
    round_times_s: List[float]
    ledger_log_head: bytes
    ledger_log_size: int
    ledger: Any = None          # the live ledger (for inspection)
    n_devices: int = 1          # devices the data plane used
    attest_log: Any = None      # {epoch: {addr: sig_hex}} of the wallet-
    # signed committee score rows (mesh runtime attestation), else None

    @property
    def final_accuracy(self) -> float:
        return self.accuracy_history[-1][1] if self.accuracy_history else 0.0

    def best_accuracy(self) -> float:
        return max((a for _, a in self.accuracy_history), default=0.0)


def run_federated(model: Model,
                  shards: Sequence[Tuple[np.ndarray, np.ndarray]],
                  test_set: Tuple[np.ndarray, np.ndarray],
                  cfg: ProtocolConfig = DEFAULT_PROTOCOL,
                  rounds: int = 10,
                  seed: int = 0,
                  init_seed: int = 0,
                  init_params: Optional[Params] = None,
                  ledger_backend: str = "auto",
                  local_optimizer=None,
                  device: DeviceLike = None,
                  verbose: bool = False) -> SimulationResult:
    """Run the committee-consensus protocol for `rounds` aggregations.

    shards: per-client (x, y) with integer class labels; test_set likewise.
    ledger_backend: 'auto' (native where `ledger.make_ledger` gives it),
    'native' or 'python'.
    local_optimizer: a `core.optim` transform for the clients' local
    steps (None = the reference's plain SGD).
    device: None means `cuda` (raises without a card); pass "cpu" to run
    on the CPU.
    """
    dev = resolve_device(device)
    cfg.validate()
    check_optimizer(local_optimizer)
    if len(shards) != cfg.client_num:
        raise ValueError(f"need {cfg.client_num} shards, got {len(shards)}")

    nc = model.num_classes
    model = model.to(dev)

    def tensors(x, y):
        return (feature_tensor(x, dev),
                torch.as_tensor(one_hot(y, nc), device=dev))

    nodes = [FLNode(f"0x{i:040x}", *tensors(sx, sy), model=model, cfg=cfg,
                    trained_epoch=cfg.initial_trained_epoch,
                    optimizer=local_optimizer)
             for i, (sx, sy) in enumerate(shards)]
    sponsor = Sponsor(model, *tensors(*test_set))
    ledger = make_ledger(cfg, backend=ledger_backend)
    store = UpdateStore()
    plane = ComputePlane(cfg)
    rng = np.random.default_rng(seed)

    if init_params is None:
        global_params = model.init_params(init_seed, dev)
    else:
        global_params = {k: v.to(dev) for k, v in init_params.items()}
    for node in nodes:
        ledger.register_node(node.address)
    if ledger.epoch != 0:
        raise RuntimeError("registration did not start FL "
                           f"(epoch={ledger.epoch})")

    loss_history: List[Tuple[int, float]] = []
    round_times: List[float] = []
    t0 = time.perf_counter()
    completed = 0
    while completed < rounds and ledger.epoch <= cfg.max_epoch:
        rt0 = time.perf_counter()
        epoch = ledger.epoch
        # trainers act in a seeded arbitrary order (first-come cap)
        order = rng.permutation(len(nodes))
        for i in order:
            nodes[i].step(ledger, store, global_params)
        # committee scores (they see the full round now)
        for i in order:
            nodes[i].step(ledger, store, global_params)
        new_params = plane.maybe_aggregate(ledger, store, global_params)
        if new_params is None:
            raise RuntimeError(
                f"round {epoch} stalled: updates={ledger.update_count} "
                f"scores={ledger.score_count}")
        global_params = new_params
        loss_history.append((epoch, ledger.last_global_loss))
        acc = sponsor.observe(epoch, global_params)   # syncs the device
        round_times.append(time.perf_counter() - rt0)
        if verbose:
            print(f"Epoch: {epoch:03d}, test_acc: {acc:.4f}, "
                  f"global_loss: {ledger.last_global_loss:.5f}")
        completed += 1

    return SimulationResult(
        accuracy_history=sponsor.history,
        loss_history=loss_history,
        final_params=global_params,
        rounds_completed=completed,
        wall_time_s=time.perf_counter() - t0,
        round_times_s=round_times,
        ledger_log_head=ledger.log_head(),
        ledger_log_size=ledger.log_size(),
        ledger=ledger)
