"""`chip_smoke.py`'s `executor_config5` leg on the CPU, in either
package: the accuracy trajectory its rounds are set from.

Config 5 on the mesh-executor runtime (20 thin client processes,
committee 4, 10 admitted, top-6, lr 0.05, batch 16; the transformer at
full width), every round one program in the executor process.  The port
runs with score attestation on (its default).  The reference runs with
it off: its thin clients fetch the evidence through a reader that
checks SHA-256 against keys that are payload fingerprints, so no
attested round of its fleet commits (ROADMAP C18); attestation gates a
round's commit and changes nothing in it, so the trajectory is the one
an attested fleet would take.

Prints one JSON line: the sponsor's accuracy by round, the best, the
log size and the wall time.

    python tests/executor_trajectory.py --package port
    JAX_PLATFORMS=cpu python tests/executor_trajectory.py \\
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
             local_epochs=1)
ROUNDS = 10
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("port", "reference"),
                    required=True)
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    shards, test_set = _data(args.package)
    kw = dict(factory_kw=ARCH, timeout_s=3600.0)
    if args.package == "port":
        from bflc_demo_tpu_torch.client.process_runtime import \
            run_federated_mesh_processes
        from bflc_demo_tpu_torch.protocol import ProtocolConfig
        kw["device"] = "cpu"
    else:
        from bflc_demo_tpu.client.process_runtime import \
            run_federated_mesh_processes
        from bflc_demo_tpu.protocol.constants import ProtocolConfig
        kw["attest_scores"] = False
    res = run_federated_mesh_processes(
        "make_transformer_classifier", shards, test_set,
        ProtocolConfig(**PROTO), rounds=args.rounds, **kw)
    print(json.dumps({
        "leg": "executor_config5", "package": args.package,
        "accuracy": [[int(e), round(float(a), 5)]
                     for e, a in res.accuracy_history],
        "best": float(res.best_accuracy()),
        "rounds": int(res.rounds_completed),
        "log_size": int(res.ledger_log_size),
        "wall_s": round(float(res.wall_time_s), 1)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
