"""CLI runner: `python -m bflc_demo_tpu_torch [--config configN] [--rounds N]`.

Port of `bflc_demo_tpu/__main__.py` with the reference's defaults
(`--config config1 --runtime mesh --rounds 10`): configs 0-5 on the
`mesh` or `host` runtime, on `cuda` unless `--device cpu` (the
counterpart of `JAX_PLATFORMS=cpu`), with the protocol overridable by
`--field-name` flags and `BFLC_*` variables (`utils/flags.py`).  An
unknown config, an unported runtime or a flag of a part not ported yet
(the process fleet and codecs A9, checkpoints A11, secure aggregation
A12, traces and telemetry A14) exits 2 naming the ROADMAP item.  Prints
the reference CLI's final JSON keys.
"""

from __future__ import annotations

import argparse
import json
import sys


def _parser() -> argparse.ArgumentParser:
    from bflc_demo_tpu_torch.utils.flags import add_flags
    p = argparse.ArgumentParser(
        prog="python -m bflc_demo_tpu_torch",
        description="Committee-consensus federated learning in PyTorch on "
                    "an NVIDIA GPU (port of bflc_demo_tpu).",
        epilog="Ported: --config config0..config5 on --runtime mesh (the "
               "default) and host.  The threaded/processes/executor "
               "runtimes and the fleet and codec flags are ROADMAP A9; "
               "they exit 2 until ported.")
    p.add_argument("--config", default="config1",
                   help="benchmark preset, config0 ... config5")
    p.add_argument("--runtime", default="mesh",
                   help="runtime (ported: mesh, host; threaded/processes/"
                        "executor are ROADMAP A9)")
    p.add_argument("--rounds", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    p.add_argument("--verbose", action="store_true")
    add_flags(p)
    return p


def main(argv=None) -> int:
    opts = _parser().parse_args(argv)
    from bflc_demo_tpu_torch.eval.configs import (CONFIGS, RUNTIMES,
                                                  UNPORTED_RUNTIME)
    from bflc_demo_tpu_torch.utils.flags import parse_protocol, unported_given
    if opts.config not in CONFIGS:
        print(f"unknown config {opts.config!r}; have {list(CONFIGS)}",
              file=sys.stderr)
        return 2
    if opts.runtime not in RUNTIMES:
        print(UNPORTED_RUNTIME.format(runtime=opts.runtime), file=sys.stderr)
        return 2
    unported = unported_given(opts)
    if unported:
        print("not ported yet: " + ", ".join(
            f"{flag} (ROADMAP {item})" for flag, item in unported.items()),
            file=sys.stderr)
        return 2
    try:
        cfg = parse_protocol(opts)
    except ValueError as exc:
        print(f"protocol: {exc}", file=sys.stderr)
        return 2
    kw = dict(rounds=opts.rounds, seed=opts.seed, runtime=opts.runtime,
              device=opts.device, verbose=opts.verbose)
    if cfg is not None:
        kw["cfg"] = cfg
    res = CONFIGS[opts.config].build(**kw)
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
