"""Structured tracing + per-op cost accounting.

Copy of `bflc_demo_tpu/utils/tracing.py`, unchanged below this
docstring but for comments that told the reference's history: `Tracer` (thread-local span stacks, typed events, cost
categories), `NULL_TRACER`, and `PROC`, the process-wide control-plane
tracer enabled by `BFLC_PROC_TRACE=1` at interpreter start.  The
process fleet charges into `PROC`: the wire's send/receive time and
bytes (`comm/wire.py`), Ed25519 signing and verification
(`comm/identity.py`) and the writer's merge (`aggregate_s`,
`comm/ledger_service.py`); the writer's `info` reply returns
`PROC.summary()` as `perf`, the split that says where a process round's
time goes.  Access it as `tracing.PROC`, never `from ... import PROC`.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict
from typing import Any, Dict, Iterator, List, Optional


class Tracer:
    """Hierarchical span/event tracer with cost counters.

    Thread-safety: `charge` takes a lock (only when enabled) so the
    multi-threaded control-plane servers can account concurrently, and
    the span name stack is THREAD-LOCAL — two server threads nesting
    spans concurrently each see only their own ancestry, so span paths
    never interleave across threads.  The events list
    itself is append-only under the lock."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.events: List[Dict[str, Any]] = []
        self.costs: Dict[str, float] = defaultdict(float)
        self._local = threading.local()
        self._lock = threading.Lock()

    def _stack(self) -> List[str]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    @contextlib.contextmanager
    def span(self, name: str, **attrs) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        stack = self._stack()
        path = "/".join(stack + [name])
        stack.append(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            stack.pop()
            ev = {"type": "span", "name": path,
                  "dur_s": time.perf_counter() - t0, **attrs}
            with self._lock:
                self.events.append(ev)

    def event(self, name: str, **attrs) -> None:
        if not self.enabled:
            return
        path = "/".join(self._stack() + [name])
        ev = {"type": "event", "name": path,
              "t": time.perf_counter(), **attrs}
        with self._lock:
            self.events.append(ev)

    def charge(self, category: str, amount: float = 1.0) -> None:
        """Cost accounting — the gasPricer equivalent.  Categories in use:
        'ledger.ops', 'device.dispatches', 'host_bytes.in', 'host_bytes.out',
        'train.samples'; and, on the control-plane fast path,
        'crypto.sign_s'/'crypto.verify_s'/'crypto.verify_n',
        'wire.send_s'/'wire.recv_s'/'wire.bytes_out'/'wire.bytes_in',
        'bft.validate_s'/'bft.certify_s'/'aggregate_s'."""
        if self.enabled:
            with self._lock:
                self.costs[category] += amount

    def reset(self) -> None:
        with self._lock:
            self.events.clear()
            self.costs.clear()
            # other threads' stacks die with their thread-local storage;
            # rebinding drops THIS thread's (reset is a caller-side call
            # between runs, not a mid-flight operation)
            self._local = threading.local()

    # --- reporting ---
    def span_totals(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for e in self.events:
            if e["type"] == "span":
                out[e["name"]] += e["dur_s"]
        return dict(out)

    def summary(self) -> Dict[str, Any]:
        return {"spans": self.span_totals(), "costs": dict(self.costs),
                "n_events": len(self.events)}

    def dump_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for e in self.events:
                f.write(json.dumps(e) + "\n")
            f.write(json.dumps({"type": "summary", **self.summary()}) + "\n")


NULL_TRACER = Tracer(enabled=False)

# Process-wide control-plane tracer: comm.wire, comm.identity and
# comm.bft charge phase timings into it so a federation round's cost is
# ATTRIBUTABLE (wire vs crypto vs validate vs aggregate), not asserted.
# Disabled by default (one `enabled` check per charge site); enabled at
# interpreter start via BFLC_PROC_TRACE=1 — the federation benchmark sets
# it in the spawn environment so every child traces — or in-process by
# flipping `PROC.enabled` (tools/profile_round.py).  Access as
# `tracing.PROC` (module attribute), never `from ... import PROC`.
PROC = Tracer(enabled=bool(os.environ.get("BFLC_PROC_TRACE")))
