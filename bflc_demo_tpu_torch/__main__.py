"""CLI runner: `python -m bflc_demo_tpu_torch [--config configN] [--rounds N]`.

Port of `bflc_demo_tpu/__main__.py` with the reference's defaults
(`--config config1 --runtime mesh --rounds 10`): configs 0-5 on the
`mesh`, `host`, `threaded` or `processes` runtime (the process fleet:
writer, clients and a replica as OS processes, with `--standbys N` hot
standbys, `--quorum Q` quorum-ack, which needs `--standbys >= Q+1`
and exits 2 otherwise, as in the reference, `--bft-validators N`
validator processes that co-sign every op, `--tls-dir D` TLS between
the roles, `--snapshot-interval K [--snapshot-dir S]` certified
snapshots and the genome's `--async-buffer K [--max-staleness S]
[--async-reseat-every R]`, asynchronous buffered aggregation, which
another runtime refuses with exit 2, and the upload codecs
`--delta-dtype f16|i8`, `--delta-density D`, `--delta-codec
topk|sketch` and `--error-feedback`: a density below 1 on another
runtime exits 2, as `--error-feedback` does there or without a lossy
encode (the reference's :141-157, :195-207), and `--error-feedback`
exports `BFLC_ERROR_FEEDBACK=1` to the children; run it from the shell
or a real file, as spawned children re-import `__main__`), on `cuda`
unless `--device cpu` (the counterpart of `JAX_PLATFORMS=cpu`), with
`--cells N`/`--cell-size M` the two-tier hier fleet (`hier/`; with
`--standbys`, `--quorum`, `--tls-dir` or `--snapshot-interval`, or on
another runtime, exit 2), with
the protocol overridable by `--field-name` flags and `BFLC_*` variables
(`utils/flags.py`) and the ledger by `--ledger-backend auto|python`.  An
unknown config, an unported runtime (the executor), the native ledger,
the fleet's flags on another runtime than `processes`, a negative
`--bft-validators` or `--snapshot-interval`, `--snapshot-dir` without
an interval, or a flag of a part not ported yet (the fleet's chaos,
rederive and the genome's `--adapt-every`/`--density-floor` A9,
checkpoints A11, secure aggregation A12, traces and telemetry A14)
exits 2 naming the ROADMAP item.
Prints the reference CLI's final JSON keys, and on `processes` a
`fleet` key besides: the round times, the spawn time, the
writer's phase split, every role's kernel launches and the writer's
merge-engine report (with `--bft-validators`, `certified_size`).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _parser() -> argparse.ArgumentParser:
    from bflc_demo_tpu_torch.utils.flags import add_flags
    p = argparse.ArgumentParser(
        prog="python -m bflc_demo_tpu_torch",
        description="Committee-consensus federated learning in PyTorch on "
                    "an NVIDIA GPU (port of bflc_demo_tpu).",
        epilog="Ported: --config config0..config5 on --runtime mesh (the "
               "default), host, threaded and processes (with --standbys, "
               "--quorum, --bft-validators, --tls-dir, --snapshot-interval "
               "and --snapshot-dir; --cells/--cell-size the hier fleet; "
               "--async-buffer runs FedBuff there, and "
               "--delta-density/--error-feedback the upload codecs), "
               "--reduce-blocks, --delta-dtype, --delta-codec.  The "
               "executor runtime, the native ledger and the fleet's "
               "other flags are ROADMAP A9; they exit 2 until ported.")
    p.add_argument("--config", default="config1",
                   help="benchmark preset, config0 ... config5")
    p.add_argument("--runtime", default="mesh",
                   help="runtime (ported: mesh, host, threaded, processes; "
                        "executor is ROADMAP A9)")
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
    if opts.ledger_backend == "native":
        unported["--ledger-backend native"] = "A9: the native ledger"
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
    from bflc_demo_tpu_torch.ledger.base import async_enabled
    if cfg is not None and async_enabled(cfg) and \
            opts.runtime != "processes":
        print("--async-buffer (async FedBuff) applies only to --runtime "
              "processes", file=sys.stderr)
        return 2
    from bflc_demo_tpu_torch.utils.codecs import sparse_enabled
    if cfg is not None and sparse_enabled(cfg) and \
            opts.runtime != "processes":
        # a wire-protocol mode: only the fleet packs and decodes blobs
        print("--delta-density < 1 applies to --runtime processes "
              "(in-memory runtimes move no upload blobs)", file=sys.stderr)
        return 2
    if opts.error_feedback:
        if opts.runtime != "processes":
            print("--error-feedback applies to the processes runtime",
                  file=sys.stderr)
            return 2
        if cfg is None or not (sparse_enabled(cfg)
                               or cfg.delta_dtype != "f32"):
            print("--error-feedback needs a lossy encode to compensate: "
                  "arm --delta-density < 1 and/or --delta-dtype f16|i8",
                  file=sys.stderr)
            return 2
        # client-local: the spawned clients inherit the decision
        os.environ["BFLC_ERROR_FEEDBACK"] = "1"
    if (opts.standbys or opts.quorum or opts.bft_validators
            or opts.tls_dir or opts.snapshot_interval
            or opts.snapshot_dir or opts.cells
            or opts.cell_size) and opts.runtime != "processes":
        print("--standbys, --quorum, --bft-validators, --tls-dir, "
              "--snapshot-interval, --snapshot-dir, --cells and "
              "--cell-size apply only to --runtime processes",
              file=sys.stderr)
        return 2
    if opts.cells or opts.cell_size:
        # hierarchical cells: one certified cell partial a cell a round
        # reaches the root (the reference's :125-137)
        if opts.standbys or opts.quorum or opts.tls_dir \
                or opts.snapshot_interval:
            print("--cells/--cell-size do not compose with "
                  "--standbys/--quorum/--tls-dir/--snapshot-interval "
                  "yet", file=sys.stderr)
            return 2
    if opts.snapshot_interval < 0:
        print(f"--snapshot-interval must be >= 0, got "
              f"{opts.snapshot_interval}", file=sys.stderr)
        return 2
    if opts.snapshot_dir and not opts.snapshot_interval:
        print("--snapshot-dir needs --snapshot-interval K > 0 (no "
              "snapshots are emitted at interval 0)", file=sys.stderr)
        return 2
    if opts.quorum and opts.standbys < opts.quorum + 1:
        print("--quorum Q needs --standbys >= Q+1 (the promoted writer "
              "must retain Q followers to keep acknowledging after a "
              "failover)", file=sys.stderr)
        return 2
    kw = dict(rounds=opts.rounds, seed=opts.seed, runtime=opts.runtime,
              device=opts.device, verbose=opts.verbose,
              ledger_backend=opts.ledger_backend)
    if opts.standbys:
        kw["standbys"] = opts.standbys
    if opts.quorum:
        kw["quorum"] = opts.quorum
    if opts.tls_dir:
        kw["tls_dir"] = opts.tls_dir
    if opts.snapshot_interval:
        kw["snapshot_interval"] = opts.snapshot_interval
        kw["snapshot_dir"] = opts.snapshot_dir
    if opts.cells or opts.cell_size:
        kw["cells"] = opts.cells
        kw["cell_size"] = opts.cell_size
    if opts.bft_validators:
        if opts.bft_validators < 1:
            print(f"--bft-validators must be positive, got "
                  f"{opts.bft_validators}", file=sys.stderr)
            return 2
        # the reference geometry is 4 (f=1); fewer than 4 still binds
        # ops to independent re-execution but tolerates no liar
        from bflc_demo_tpu_torch.protocol.constants import \
            bft_fault_tolerance
        if bft_fault_tolerance(opts.bft_validators) < 1:
            print(f"note: --bft-validators {opts.bft_validators} gives "
                  f"f=0 (no Byzantine tolerance); the reference geometry "
                  f"is 4", file=sys.stderr)
        kw["bft_validators"] = opts.bft_validators
    if cfg is not None:
        kw["cfg"] = cfg
    res = CONFIGS[opts.config].build(**kw)
    out = {
        "config": opts.config,
        "rounds": res.rounds_completed,
        "final_acc": res.final_accuracy,
        "best_acc": res.best_accuracy(),
        "wall_time_s": round(res.wall_time_s, 3),
        "ledger_log_size": res.ledger_log_size,
        # bytes from in-process ledgers, already hex from the fleet
        "ledger_log_head": (res.ledger_log_head.hex()
                            if isinstance(res.ledger_log_head, bytes)
                            else res.ledger_log_head),
    }
    if opts.runtime == "processes":
        # the fleet's own account: round times, spawn time, the writer's
        # phase split (BFLC_PROC_TRACE=1), every role's kernel launches
        out["fleet"] = {"epoch_times": res.epoch_times,
                        "spawn_s": res.spawn_s,
                        "perf": (res.final_info or {}).get("perf"),
                        "kernel_launches": res.kernel_launches,
                        "writer_engine": res.writer_engine,
                        "writer_merges": res.writer_merges,
                        "client_reads": res.client_reads,
                        "client_counts": res.client_counts,
                        "failover": res.failover,
                        "certified_size": res.certified_size,
                        "validator_spawn_s": res.validator_spawn_s,
                        "ed25519_backend": res.ed25519_backend,
                        "replica_head_ok": bool(
                            res.replica_report and res.replica_report["head"]
                            == res.ledger_log_head)}
        if res.cell_plan is not None:
            # the hier fleet: the plan, each member's exit code, every
            # root op (name, sender, epoch) and each cell's partials
            out["fleet"]["hier"] = {
                "cells": [list(m) for m in res.cell_plan.members],
                "client_exitcodes": res.client_exitcodes,
                "root_ops": res.root_ops,
                "cell_merges": res.cell_merges}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
