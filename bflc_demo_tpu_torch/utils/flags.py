"""Protocol overrides from the environment and the command line.

Port of the protocol part of `bflc_demo_tpu/utils/flags.py` (:96-172,
:196-209): `protocol_from_env` reads `BFLC_<FIELD>=value` for every
`ProtocolConfig` field (a string field, such as `delta_dtype`, as it
stands), each field has a `--field-name` flag, a flag beats the
environment, and when neither changes anything the preset keeps its own
protocol (`parse_protocol` returns None).  As in the reference, an
override starts from `ProtocolConfig()`'s defaults, not from the
preset's.

The process fleet's `--standbys N`, `--quorum Q`, `--bft-validators N`,
`--tls-dir D`, `--snapshot-interval K` and `--snapshot-dir S` are ported
(the processes runtime's hot standbys, quorum-ack, BFT commit quorum,
TLS and certified snapshots), the hier cells (`--cells N`,
`--cell-size M`, the reference's int flags: `hier/`), and so are the
genome's asynchronous
buffered aggregation (`--async-buffer K`, `--max-staleness S`,
`--async-reseat-every R` and their `BFLC_*` variables, plain int flags
as in the reference; `BFLC_ASYNC_LEGACY=1` pins the synchronous chain,
`ledger/base.async_enabled`), `--reduce-blocks B`
(`BFLC_REDUCE_BLOCKS`, REDUCTION SPEC v2; the flag's help is the
reference's, :174-181, and `BFLC_BLOCKED_LEGACY=1` pins one block,
`ledger/base.reduce_blocks`) and the upload codecs: `--delta-dtype
f32|f16|i8` (choices checked at parse time), `--delta-density`
(a float), `--delta-codec topk|sketch` (the reference's flags and
help, :152-172; `BFLC_SPARSE_LEGACY=1` pins the dense protocol) and the
client-local `--error-feedback` / `--no-error-feedback`
(`BFLC_ERROR_FEEDBACK=1` in the children), the closed compression loop's
genome fields (`--adapt-every`, `--density-floor` and their `BFLC_*`
variables, plain flags as in the reference; `BFLC_ADAPT_LEGACY=1` pins
the static knobs) and the validator re-derivation plane (`--rederive
off|shard|full`, the reference's choices, :136-143).  The reference's other run
options belong to parts not ported yet.  Each such flag is accepted by
the parser so that the CLI can refuse it by name (exit 2 with the
ROADMAP item) rather than fail on an unknown argument or drop it.
Checkpoints are ported: `--checkpoint-dir D` and `--checkpoint-every N`
(the reference's :33-34; the CLI saves at a run's end, and every N
rounds on the mesh runtime).  `--ledger-backend` is ported (auto,
native and python).  `--secure` is ported: config 4's
secure-aggregation variant (the CLI refuses it on another config).
Still dropped: the device profiler (A11) and chaos, traces, plots and
telemetry (A14, where the fleet's own `UNPORTED_FLEET_OPTIONS` puts
them).  Score attestation is ported: `--attest-scores` /
`--no-attest-scores`, the reference's tri-state (:48-51; not given = on
wherever wallets exist), for the mesh and executor runtimes.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Dict, Optional

from bflc_demo_tpu_torch.protocol.constants import ProtocolConfig
from bflc_demo_tpu_torch.rederive import REDERIVE_MODES

_ENV_PREFIX = "BFLC_"

# reference run options -> the ROADMAP item that ports them
UNPORTED_OPTIONS: Dict[str, str] = {
    **{name: "A14" for name in ("chaos_seed", "chaos_profile")},
    "xprof_window": "A11",
    **{name: "A14" for name in ("trace_path", "plot_path", "telemetry_dir",
                                "trace_sample")},
}


def protocol_from_env(base: Optional[ProtocolConfig] = None
                      ) -> ProtocolConfig:
    """`base` (default `ProtocolConfig()`) with every field that has a
    `BFLC_<FIELD>` variable set to its value, validated."""
    values = dataclasses.asdict(base or ProtocolConfig())
    for name in values:
        raw = os.environ.get(_ENV_PREFIX + name.upper())
        if raw is None:
            continue
        current = values[name]
        if isinstance(current, str):        # e.g. delta_dtype
            values[name] = raw
        else:
            values[name] = type(current)(
                float(raw) if isinstance(current, float) else int(raw))
    return ProtocolConfig(**values).validate()


def add_flags(p: argparse.ArgumentParser) -> None:
    """One `--field-name` flag per protocol field (default None: not
    given), and the unported run options, each recorded if given."""
    for name, default in dataclasses.asdict(ProtocolConfig()).items():
        help_ = f"protocol: {name} (default {default})"
        if name == "delta_dtype":
            # a typo dies at parse time, not mid-federation
            p.add_argument("--delta-dtype", choices=["f32", "f16", "i8"],
                           default=None,
                           help="protocol: upload delta encoding "
                                "(default f32 = dense float32; f16/i8 "
                                "quantize client uploads, certified "
                                "hash over the quantized bytes)")
            continue
        if name == "delta_density":
            help_ = ("protocol: deterministic top-k upload "
                     "sparsification — keep this fraction of each float "
                     "leaf's largest-|value| entries (default 1.0 = "
                     "dense; certified hash over the sparse bytes, "
                     "composes with --delta-dtype)")
        if name == "reduce_blocks":
            help_ = ("protocol: partition the flattened param axis into "
                     "this many contiguous blocks for aggregation "
                     "(REDUCTION SPEC v2; default 1 = v1 single block; "
                     "result bytes are identical for any value — this is "
                     "an execution-shape knob the quorum certifies, needs "
                     "the python ledger backend; BFLC_BLOCKED_LEGACY=1 "
                     "pins v1)")
        p.add_argument("--" + name.replace("_", "-"), type=type(default),
                       default=None, help=help_)
    p.add_argument("--ledger-backend", default="auto",
                   choices=("auto", "python", "native"),
                   help="ledger backend (auto: the native C++ ledger "
                        "where the config allows it, else python)")
    p.add_argument("--standbys", type=int, default=0,
                   help="processes runtime: hot standbys that promote "
                        "when the writer dies")
    p.add_argument("--quorum", type=int, default=0,
                   help="processes runtime: acknowledge a mutation once "
                        "Q standbys applied it (needs --standbys >= Q+1)")
    p.add_argument("--bft-validators", type=int, default=0,
                   help="processes runtime: BFT commit-quorum validator "
                        "processes (4 = the reference's f=1 geometry)")
    p.add_argument("--tls-dir", default="",
                   help="processes runtime: TLS certificate directory "
                        "(provisioned when empty)")
    p.add_argument("--snapshot-interval", type=int, default=0,
                   help="processes runtime: a certified snapshot op every "
                        "K rounds, with log and WAL GC behind it (0 = off)")
    p.add_argument("--snapshot-dir", default="",
                   help="processes runtime: snapshot artifacts, a "
                        "directory per role")
    p.add_argument("--cells", type=int, default=0,
                   help="processes runtime: hierarchical cell federation — "
                        "cohort the clients into N cells, each aggregator "
                        "submitting one certified cell partial a round to "
                        "the root (0 = the single-tier fleet)")
    p.add_argument("--cell-size", type=int, default=0,
                   help="processes runtime: cells of at most M members "
                        "(with --cells the two must agree)")
    p.add_argument("--rederive", choices=list(REDERIVE_MODES),
                   default="off",
                   help="validator re-derivation plane mode (processes "
                        "runtime with --bft-validators; default off)")
    p.add_argument("--error-feedback", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="processes runtime: client-local error feedback "
                        "(fold what the lossy encode dropped into the "
                        "next delta; needs --delta-density < 1 or "
                        "--delta-dtype f16|i8)")
    p.add_argument("--checkpoint-dir", default="",
                   help="save the final model and the ledger's op log "
                        "here (model.bflct, ledger.oplog, meta.json)")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="mesh runtime: also checkpoint every N rounds "
                        "(0 = only at the end)")
    p.add_argument("--attest-scores", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="mesh/executor runtimes: score attestation (not "
                        "given: on wherever wallets exist; "
                        "--no-attest-scores opts out)")
    p.add_argument("--secure", action="store_true",
                   help="config4 on the mesh runtime: secure aggregation "
                        "(pairwise-masked merges keyed by X25519 pair "
                        "seeds; wallets provisioned per run)")
    for name, item in UNPORTED_OPTIONS.items():
        p.add_argument("--" + name.replace("_", "-"), nargs="?", const=True,
                       default=None, help=f"not ported yet (ROADMAP {item})")


def unported_given(ns: argparse.Namespace) -> Dict[str, str]:
    """{flag: ROADMAP item} of the unported options the command line
    set."""
    return {"--" + name.replace("_", "-"): item
            for name, item in UNPORTED_OPTIONS.items()
            if getattr(ns, name) is not None}


def parse_protocol(ns: argparse.Namespace) -> Optional[ProtocolConfig]:
    """The run's protocol: the flags over the `BFLC_*` variables over
    `ProtocolConfig()`; None when neither overrides anything (the
    preset's own protocol)."""
    overrides = {name: getattr(ns, name)
                 for name in dataclasses.asdict(ProtocolConfig())
                 if getattr(ns, name) is not None}
    env_base = protocol_from_env()
    if overrides or env_base != ProtocolConfig():
        return dataclasses.replace(env_base, **overrides).validate()
    return None
