"""CLI runner: `python -m bflc_demo_tpu_torch [--config config1] [--rounds N]`.

Port of `bflc_demo_tpu/__main__.py` for the presets and runtimes ported
so far, with the reference's defaults: `--config config1 --runtime mesh
--rounds 10`.  Configs 1 and 5 run on the `mesh` or `host` runtime, on
`cuda` unless `--device cpu` (the counterpart of `JAX_PLATFORMS=cpu`).
Any other config or runtime exits 2 naming the ROADMAP item that ports
it.  Prints the reference CLI's final JSON keys.
"""

from __future__ import annotations

import argparse
import json
import sys


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m bflc_demo_tpu_torch",
        description="Committee-consensus federated learning in PyTorch on "
                    "an NVIDIA GPU (port of bflc_demo_tpu).",
        epilog="Ported so far: --config config1 and config5 on --runtime "
               "mesh (the default) and host.  Configs 0/2/3/4 are ROADMAP "
               "A8/A10, the threaded/processes/executor runtimes A9; "
               "either exits 2 until ported.")
    p.add_argument("--config", default="config1",
                   help="benchmark preset (ported: config1, config5)")
    p.add_argument("--runtime", default="mesh",
                   help="runtime (ported: mesh, host; threaded/processes/"
                        "executor are ROADMAP A9)")
    p.add_argument("--rounds", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    p.add_argument("--verbose", action="store_true")
    return p


def main(argv=None) -> int:
    opts = _parser().parse_args(argv)
    from bflc_demo_tpu_torch.eval.configs import (CONFIGS, RUNTIMES,
                                                  UNPORTED_RUNTIME)
    if opts.config not in CONFIGS:
        print(f"config {opts.config!r} is not ported yet (ROADMAP A8/A10); "
              f"have {list(CONFIGS)}", file=sys.stderr)
        return 2
    if opts.runtime not in RUNTIMES:
        print(UNPORTED_RUNTIME.format(runtime=opts.runtime), file=sys.stderr)
        return 2
    res = CONFIGS[opts.config].build(rounds=opts.rounds, seed=opts.seed,
                                     runtime=opts.runtime,
                                     device=opts.device,
                                     verbose=opts.verbose)
    print(json.dumps({
        "config": opts.config,
        "rounds": res.rounds_completed,
        "final_acc": res.final_accuracy,
        "best_acc": res.best_accuracy(),
        "wall_time_s": round(res.wall_time_s, 3),
        "ledger_log_size": res.ledger_log_size,
        "ledger_log_head": res.ledger_log_head.hex(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
