"""Where a preset's round spends its time on the card.

    python -m bflc_demo_tpu_torch.eval.profile_round [--config config5]
        [--runtime host|mesh] [--rounds 2]

Runs the preset (default config 5, at the preset's own geometry) on
`cuda` on the chosen runtime (default host) for two rounds to warm up
(kernel build, cuBLAS handles, the caching allocator; the second
round's time is reported as
`round_s_unprofiled`), then for `--rounds` rounds under
`torch.profiler` (CPU and CUDA activities) with host-clock timers around
each protocol phase.  Prints the card's nvidia-smi line, then one JSON
object:

- `round_s`: wall seconds of each profiled round (the profiler adds host
  time to every op, so these run slower than `round_s_unprofiled`);
- `phase_s_per_round`: host seconds per round in each protocol phase —
  host runtime: local training, payload hashing (store put/get and the
  commit hash), candidate scoring, the merge and the sponsor's eval; mesh
  runtime: stacked local training, the stacked scoring pass, the decision
  and merge, the payload fingerprints, the ledger audit and the sponsor's
  eval.  A phase that ends in a device sync (a hash copies its tensors to
  the host, the sponsor reads its accuracy) includes the wait; the others
  count the time to enqueue their work;
- `device_busy_s_per_round` and `busy_share`: the union of CUDA kernel
  and copy intervals per round, and its share of the round's wall time
  (null when the profiler records no device activity);
- `launches_per_round`: device activities per round;
- `top_device_s_per_round`: the heaviest kernel names by device time.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import time

import torch

from bflc_demo_tpu_torch.client import mesh_runtime, runtime
from bflc_demo_tpu_torch.comm import store
from bflc_demo_tpu_torch.eval.configs import CONFIGS
from bflc_demo_tpu_torch.parallel import fedavg

# runtime -> protocol phase -> (module, function) pairs whose host time
# it sums
PHASES = {
    "host": {
        "local_train": [(runtime, "local_train")],
        "hashing": [(runtime, "hash_pytree"), (store, "hash_pytree")],
        "scoring": [(runtime, "score_candidates")],
        "merge": [(runtime, "apply_selection")],
        "sponsor_eval": [(runtime, "evaluate")],
    },
    "mesh": {
        "local_train": [(fedavg, "sgd_stacked")],
        "scoring": [(fedavg, "committee_score_matrix")],
        "decide_merge": [(fedavg, "decide"), (fedavg, "apply_selection")],
        "fingerprint": [(fedavg, "fingerprint_stacked"),
                        (fedavg, "fingerprint_pytree")],
        "audit": [(mesh_runtime, "audit_round")],
        "sponsor_eval": [(runtime, "evaluate")],
    },
}


def _timed(fn, phase, totals):
    def wrapper(*args, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            totals[phase] += time.perf_counter() - t0
    return wrapper


def _device_intervals(prof):
    """(start_us, end_us, name) of every device activity the profiler saw."""
    out = []
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            out.append((evt.time_range.start, evt.time_range.end, evt.name))
    return out


def _union_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for start, stop, _ in sorted(intervals):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", choices=sorted(CONFIGS), default="config5")
    p.add_argument("--runtime", choices=sorted(PHASES), default="host")
    p.add_argument("--rounds", type=int, default=2)
    opts = p.parse_args(argv)
    preset = CONFIGS[opts.config].build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    warm = preset(rounds=2, runtime=opts.runtime, device="cuda")

    totals = collections.defaultdict(float)
    originals = []
    for phase, sites in PHASES[opts.runtime].items():
        for module, name in sites:
            fn = getattr(module, name)
            originals.append((module, name, fn))
            setattr(module, name, _timed(fn, phase, totals))
    try:
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            res = preset(rounds=opts.rounds, runtime=opts.runtime,
                         device="cuda")
    finally:
        for module, name, fn in originals:
            setattr(module, name, fn)

    n = res.rounds_completed
    intervals = _device_intervals(prof)
    busy = _union_us(intervals) / 1e6 / n if intervals else None
    by_name = collections.defaultdict(float)
    for start, stop, name in intervals:
        by_name[name] += (stop - start) / 1e6 / n
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    round_mean = sum(res.round_times_s) / n
    print(json.dumps({
        "config": opts.config,
        "runtime": opts.runtime,
        "rounds": n,
        "round_s_unprofiled": warm.round_times_s[1:],
        "round_s": res.round_times_s,
        "phase_s_per_round": {k: v / n for k, v in totals.items()},
        "device_busy_s_per_round": busy,
        "busy_share": None if busy is None else busy / round_mean,
        "launches_per_round": len(intervals) / n,
        "top_device_s_per_round": dict(top),
        "best_acc": res.best_accuracy(),
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
