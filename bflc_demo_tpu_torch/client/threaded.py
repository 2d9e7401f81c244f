"""Threaded concurrent runtime: N real client threads against one ledger.

Port of `bflc_demo_tpu/client/threaded.py`: every client is a thread
running the port's `FLNode` state machine; the ledger, wrapped in
`LockingLedger`, is the one serialization point, so the first-come cap,
the duplicate and the epoch guards meet real racing uploads; a shared
condition wakes clients on ledger transitions; and a failure detector
drives the ledger's recovery ops when a round stalls — `close_round`
when trainers die short of the cap, `reseat_committee` when the whole
committee is dead, `force_aggregate` when committee rows stop arriving.
`crash_at` kills chosen clients at chosen epochs; a client thread that
raises is recorded in `client_errors` and treated as dead, and an
exception in the aggregator thread fails `run()` instead of timing it
out.  The aggregator
thread applies each round's merge with the port's `ComputePlane` on the
run's device (`cuda` unless the caller asks for the CPU) and the
sponsor evaluates every committed model.  `ledger_backend` is
`make_ledger`'s ("auto" takes the native ledger where the reference
does).  With `keyring` (:72, :87, :93-97) every node signs its ops and
the ledger is wrapped in `comm.identity.AuthenticatedLedger`, inside the
lock: an op whose tag does not verify is refused (BAD_ARG), a replayed
one answers DUPLICATE.

Not ported: the tracer hook (ROADMAP A14).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bflc_demo_tpu_torch.client.runtime import (ComputePlane, FLNode, Sponsor,
                                                feature_tensor)
from bflc_demo_tpu_torch.client.simulation import SimulationResult
from bflc_demo_tpu_torch.comm.store import UpdateStore
from bflc_demo_tpu_torch.data.partition import one_hot
from bflc_demo_tpu_torch.device import DeviceLike, resolve_device
from bflc_demo_tpu_torch.ledger import make_ledger
from bflc_demo_tpu_torch.models.base import Model
from bflc_demo_tpu_torch.protocol.constants import (DEFAULT_PROTOCOL,
                                                    ProtocolConfig)


class LockingLedger:
    """Serializes every ledger call behind one lock — the consensus
    point.  The getattr itself runs under the lock: properties execute
    ledger code when read."""

    def __init__(self, inner):
        self._inner = inner
        self._lock = threading.RLock()

    def __getattr__(self, name):
        with self._lock:
            attr = getattr(self._inner, name)
        if callable(attr):
            def locked(*a, **kw):
                with self._lock:
                    return getattr(self._inner, name)(*a, **kw)
            return locked
        return attr


class ThreadedFederation:
    def __init__(self, model: Model,
                 shards: Sequence[Tuple[np.ndarray, np.ndarray]],
                 test_set: Tuple[np.ndarray, np.ndarray],
                 cfg: ProtocolConfig = DEFAULT_PROTOCOL,
                 ledger_backend: str = "auto",
                 crash_at: Optional[Dict[int, int]] = None,
                 stall_timeout_s: float = 5.0,
                 init_seed: int = 0,
                 keyring=None,
                 device: DeviceLike = None):
        cfg.validate()
        if len(shards) != cfg.client_num:
            raise ValueError(f"need {cfg.client_num} shards, "
                             f"got {len(shards)}")
        dev = resolve_device(device)
        self.cfg = cfg
        self.model = model.to(dev)
        self.crash_at = crash_at or {}       # client index -> epoch to die
        self.stall_timeout_s = stall_timeout_s
        nc = model.num_classes

        def tensors(x, y):
            return (feature_tensor(x, dev),
                    torch.as_tensor(one_hot(np.asarray(y), nc), device=dev))

        self.nodes = [FLNode(f"0x{i:040x}", *tensors(sx, sy),
                             model=self.model, cfg=cfg,
                             trained_epoch=cfg.initial_trained_epoch,
                             keyring=keyring)
                      for i, (sx, sy) in enumerate(shards)]
        self.sponsor = Sponsor(self.model, *tensors(*test_set))
        inner = make_ledger(cfg, backend=ledger_backend)
        if keyring is not None:
            # origin authentication inside the serialization lock
            from bflc_demo_tpu_torch.comm.identity import AuthenticatedLedger
            inner = AuthenticatedLedger(inner, keyring)
        self.ledger = LockingLedger(inner)
        self.store = UpdateStore()
        self.plane = ComputePlane(cfg)
        self.params = self.model.init_params(init_seed, dev)
        self._params_lock = threading.Lock()
        self._cv = threading.Condition()
        self._stop = threading.Event()
        self._last_progress = time.monotonic()
        self._busy = 0                       # clients inside step() now
        self._busy_lock = threading.Lock()
        self._alive = {i: True for i in range(len(self.nodes))}
        self.loss_history: List[Tuple[int, float]] = []
        self.recoveries: List[str] = []
        # a client thread that raises is a dead client (the detector
        # carries its round); the aggregator's exception fails run()
        self.client_errors: List[Tuple[int, str]] = []
        self.error: Optional[BaseException] = None

    def _get_params(self):
        with self._params_lock:
            return self.params

    def _touch(self):
        self._last_progress = time.monotonic()
        with self._cv:
            self._cv.notify_all()

    def _client_loop(self, idx: int):
        node = self.nodes[idx]
        try:
            while not self._stop.is_set():
                epoch = self.ledger.epoch
                if epoch > self.cfg.max_epoch:
                    return
                crash_epoch = self.crash_at.get(idx)
                if crash_epoch is not None and epoch >= crash_epoch:
                    return                  # simulated hard crash
                # busy tells the detector someone is working: slow != dead
                with self._busy_lock:
                    self._busy += 1
                try:
                    acted = node.step(self.ledger, self.store,
                                      self._get_params())
                finally:
                    with self._busy_lock:
                        self._busy -= 1
                if acted:
                    self._touch()
                else:
                    with self._cv:
                        self._cv.wait(timeout=0.05)
        except Exception as e:              # noqa: BLE001 — a dead client
            self.client_errors.append((idx, repr(e)))
        finally:
            self._alive[idx] = False

    def _aggregator_loop(self, rounds: int):
        completed = 0
        try:
            while completed < rounds and not self._stop.is_set():
                if self.ledger.aggregate_ready():
                    epoch = self.ledger.epoch
                    with self._params_lock:
                        new_params = self.plane.maybe_aggregate(
                            self.ledger, self.store, self.params)
                        if new_params is not None:
                            self.params = new_params
                    if new_params is not None:
                        self.loss_history.append(
                            (epoch, self.ledger.last_global_loss))
                        self.sponsor.observe(epoch, new_params)
                        completed += 1
                        self._touch()
                        continue
                stalled_for = time.monotonic() - self._last_progress
                with self._busy_lock:
                    anyone_busy = self._busy > 0
                if stalled_for > self.stall_timeout_s and not anyone_busy:
                    self._recover()
                    self._touch()
                with self._cv:
                    self._cv.wait(timeout=0.05)
        except BaseException as e:          # noqa: BLE001 — surfaced by run
            self.error = e
        finally:
            self._stop.set()
            with self._cv:
                self._cv.notify_all()

    def _recover(self):
        """Drive the recovery op for whatever phase is stuck: close an
        under-filled round -> reseat a dead committee with live clients
        -> force the merge over the rows present."""
        led = self.ledger
        if led.aggregate_ready():
            return
        if 0 < led.update_count < self.cfg.needed_update_count \
                and not led.round_closed:
            if led.close_round().name == "OK":
                self.recoveries.append(f"close_round@{led.epoch}")
                return
        committee = set(led.committee())
        comm_alive = [i for i in range(len(self.nodes))
                      if self.nodes[i].address in committee
                      and self._alive.get(i)]
        if led.update_count > 0 and not comm_alive:
            uploaders = {u.sender for u in led.query_all_updates()}
            live = [i for i, a in self._alive.items() if a]
            pool = ([i for i in live
                     if self.nodes[i].address not in uploaders] or live)
            seats = [self.nodes[i].address
                     for i in pool[: self.cfg.comm_count]]
            if seats and led.reseat_committee(seats).name == "OK":
                self.recoveries.append(f"reseat@{led.epoch}")
                return
        if led.score_count > 0 and led.force_aggregate().name == "OK":
            self.recoveries.append(f"force_aggregate@{led.epoch}")

    def run(self, rounds: int = 5, timeout_s: float = 300.0
            ) -> SimulationResult:
        t0 = time.perf_counter()
        for node in self.nodes:
            node.register(self.ledger)
        if self.ledger.epoch != 0:
            raise RuntimeError("registration did not start FL")
        threads = [threading.Thread(target=self._client_loop, args=(i,),
                                    daemon=True)
                   for i in range(len(self.nodes))]
        agg = threading.Thread(target=self._aggregator_loop, args=(rounds,),
                               daemon=True)
        for t in threads:
            t.start()
        agg.start()
        agg.join(timeout=timeout_s)
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        for t in threads:
            t.join(timeout=5.0)
        if self.error is not None:
            raise RuntimeError("threaded federation failed") from self.error
        if agg.is_alive():
            raise RuntimeError("threaded federation timed out")
        return SimulationResult(
            accuracy_history=self.sponsor.history,
            loss_history=self.loss_history,
            final_params=self._get_params(),
            rounds_completed=len(self.loss_history),
            wall_time_s=time.perf_counter() - t0,
            round_times_s=[],
            ledger_log_head=self.ledger.log_head(),
            ledger_log_size=self.ledger.log_size(),
            ledger=self.ledger)
