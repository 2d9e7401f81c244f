"""`chip_smoke.py`'s `rederive_config5` leg on the CPU, in either
package: the accuracy trajectory and the density schedule its bar and
rounds are set from.

Config 5 on the processes runtime (20 clients, committee 4, 10
admitted, top-6, lr 0.05, batch 16; the transformer at full width), 4
validators armed `--rederive shard` at 8 blocks, a sparse genome with
the closed compression loop (top-k from density 0.1 with i8 values,
`adapt_every` 2, `density_floor` 0.01) and the clients' error feedback.

Prints one JSON line: the sponsor's accuracy by round, the best, the
genome ops' densities, the log and certified sizes, each validator's
re-derivations (ok, refused, skipped) and the wall time.

    python tests/rederive_trajectory.py --package port
    JAX_PLATFORMS=cpu python tests/rederive_trajectory.py \\
        --package reference

Run it from the repository root, as a file (spawned children re-import
`__main__`).  A helper script, not a test: pytest collects `test_*.py`
only.
"""

import argparse
import json
import os
import sys

PROTO = dict(client_num=20, comm_count=4, aggregate_count=6,
             needed_update_count=10, learning_rate=0.05, batch_size=16,
             local_epochs=1, reduce_blocks=8, delta_density=0.1,
             delta_codec="topk", delta_dtype="i8", adapt_every=2,
             density_floor=0.01)
FLEET = dict(bft_validators=4, rederive="shard")
ROUNDS = 12
ARCH = dict(vocab_size=1000, seq_len=64, num_classes=2, dim=128, depth=2,
            heads=4)


def _export_reference_transformer() -> None:
    """The reference's fleet builds its model by name from
    `bflc_demo_tpu.models`, which does not export the transformer's
    factory: register it there (at import, so the spawned children see
    it too)."""
    import bflc_demo_tpu.models as models
    from bflc_demo_tpu.models.transformer import make_transformer_classifier
    models.make_transformer_classifier = make_transformer_classifier


if "reference" in sys.argv:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    _export_reference_transformer()


def _data(package: str):
    if package == "port":
        from bflc_demo_tpu_torch.eval.configs import config5_data
        return config5_data(0, 4000, 20)
    from bflc_demo_tpu.data import iid_shards
    from bflc_demo_tpu.data.synthetic import synthetic_text_classification
    from bflc_demo_tpu.eval.configs import _split
    x, y = synthetic_text_classification(4000, seq_len=64, vocab_size=1000,
                                         num_classes=2, seed=0)
    xtr, ytr, xte, yte = _split(x, y)
    return iid_shards(xtr, ytr, 20), (xte, yte)


def _genomes(package: str, res) -> list:
    """(epoch, density) of every genome op on the writer's chain."""
    if package == "port":
        return [[g["epoch"], g["new_density"]] for g in res.writer_genomes]
    return None                          # the reference reports none


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("port", "reference"),
                    required=True)
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    os.environ["BFLC_ERROR_FEEDBACK"] = "1"
    os.environ["BFLC_PROC_TRACE"] = "1"
    shards, test_set = _data(args.package)
    kw = dict(FLEET, factory_kw=ARCH, timeout_s=3600.0)
    if args.package == "port":
        from bflc_demo_tpu_torch.client.process_runtime import \
            run_federated_processes
        from bflc_demo_tpu_torch.protocol import ProtocolConfig
        kw["device"] = "cpu"
    else:
        from bflc_demo_tpu.client.process_runtime import \
            run_federated_processes
        from bflc_demo_tpu.protocol.constants import ProtocolConfig
    res = run_federated_processes("make_transformer_classifier", shards,
                                  test_set, ProtocolConfig(**PROTO),
                                  rounds=args.rounds, **kw)
    info = res.final_info or {}
    print(json.dumps({
        "leg": "rederive_config5", "package": args.package,
        "accuracy": [[int(e), round(float(a), 5)]
                     for e, a in res.accuracy_history],
        "best": float(res.best_accuracy()),
        "rounds": int(res.rounds_completed),
        "eff_density": info.get("eff_density"),
        "genome_epoch": info.get("genome_epoch"),
        "genomes": _genomes(args.package, res),
        "log_size": info.get("log_size"),
        "certified_size": info.get("certified_size"),
        "validators": {r: {k: v.get(k) for k in ("ok", "refused",
                                                 "skipped")}
                       for r, v in ((r, (rep or {}).get("rederive") or {})
                                    for r, rep in getattr(
                                        res, "validator_reports",
                                        {}).items())},
        "wall_s": round(float(res.wall_time_s), 1)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
