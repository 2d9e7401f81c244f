"""Where a warm sequence-parallel training step spends its time on the card.

    python -m bflc_demo_tpu_torch.eval.profile_sp [--steps 2]

Runs `long_context_sp` at its defaults (config 5's transformer, seq 8192,
8 folded shards, batch 4, lr 0.05) for two steps to warm up (kernel
build, cuBLAS, the caching allocator; the second step's time is reported
as `step_s_unprofiled`), then `--steps` more steps from the final params
under `torch.profiler` (CPU and CUDA activities).  Prints the card's
nvidia-smi line, then one JSON object:

- `wall_s_per_step`: host seconds per profiled step (the profiler adds
  host time to every op, so it exceeds `step_s_unprofiled`);
- `device_busy_s_per_step`: the union of CUDA kernel and copy intervals
  per step, and `busy_share` of the unprofiled step's time and of the
  profiled one's;
- `device_s_per_step_by_kernel`: the heaviest kernel names by device
  time per step;
- `peak_mem_bytes` of the warm-up run.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import time

import torch

from bflc_demo_tpu_torch.eval.long_context import long_context_sp
from bflc_demo_tpu_torch.eval.profile_round import (_device_intervals,
                                                    _union_us)
from bflc_demo_tpu_torch.parallel.mesh import FoldedAxis
from bflc_demo_tpu_torch.parallel.ring_attention import make_sp_train_step

N_SP, LR = 8, 0.05


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=2)
    opts = p.parse_args(argv)

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    warm = long_context_sp(n_sp=N_SP, steps=2, lr=LR, device="cuda")
    step = make_sp_train_step(
        FoldedAxis(N_SP, warm.tokens.shape[0], warm.tokens.device),
        warm.model, LR)
    params = warm.params[-1]

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    walls = []
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(opts.steps):
            t0 = time.perf_counter()
            params, loss = step(params, warm.tokens, warm.labels)
            float(loss)                             # waits for the device
            walls.append(time.perf_counter() - t0)

    n = opts.steps
    intervals = _device_intervals(prof)
    busy = _union_us(intervals) / 1e6 / n if intervals else None
    by_name = collections.defaultdict(float)
    for start, stop, name in intervals:
        by_name[name] += (stop - start) / 1e6 / n
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    unprofiled = warm.step_s[1]
    print(json.dumps({
        "steps": n,
        "step_s_unprofiled": unprofiled,
        "wall_s_per_step": sum(walls) / n,
        "device_busy_s_per_step": busy,
        "busy_share_unprofiled": None if busy is None else busy / unprofiled,
        "busy_share_profiled": None if busy is None else busy * n / sum(walls),
        "device_s_per_step_by_kernel": dict(top),
        "peak_mem_bytes": warm.peak_mem_bytes,
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
