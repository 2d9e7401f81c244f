"""Config 5's async FedBuff fleet on the CPU, in either package: the
geometry of `chip_smoke.py`'s `async_config5` leg (20 clients,
committee 4, top-6, lr 0.05, batch 16; the transformer at full width;
`async_buffer` 10, `max_staleness` 20, `async_reseat_every` 2,
`reduce_blocks` 8; 4 validators, 1 standby, a snapshot every 2 epochs,
the primary SIGKILLed after epoch 3 of 7).  `--kill-at -1` runs the
fleet without the standby and the kill: the reference's drill kills the
primary before its chain is certified, and under BFT its standby, which
follows certified ops only, can then not promote.  Prints one JSON line:
the sponsor's accuracy by epoch, the best, the drains' depths and
staleness, the kill's epoch and the wall time.

    JAX_PLATFORMS=cpu python tests/async_config5_trajectory.py \
        --package reference --kill-at -1
    python tests/async_config5_trajectory.py --package port

Run it from the repository root, as a file (spawned children re-import
`__main__`).  A helper script, not a test: pytest collects `test_*.py`
only.
"""

import argparse
import json
import os
import sys
import tempfile

PROTO = dict(client_num=20, comm_count=4, aggregate_count=6,
             needed_update_count=10, learning_rate=0.05, batch_size=16,
             local_epochs=1, async_buffer=10, max_staleness=20,
             async_reseat_every=2, reduce_blocks=8)
FLEET = dict(bft_validators=4, snapshot_interval=2)
KILL_AT, EPOCHS = 3, 7


def _export_reference_transformer() -> None:
    """The reference's fleet builds its model by name from
    `bflc_demo_tpu.models`, which does not export the transformer's
    factory: register it there.  Runs at import, so the spawned children
    (which re-import this file as their `__main__`, with the parent's
    argv) see it too."""
    import bflc_demo_tpu.models as models
    from bflc_demo_tpu.models.transformer import make_transformer_classifier
    models.make_transformer_classifier = make_transformer_classifier


if "reference" in sys.argv:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    _export_reference_transformer()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("port", "reference"),
                    required=True)
    ap.add_argument("--epochs", type=int, default=EPOCHS)
    ap.add_argument("--kill-at", type=int, default=KILL_AT)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    arch = dict(vocab_size=1000, seq_len=64, num_classes=2, dim=128,
                depth=2, heads=4)
    with tempfile.TemporaryDirectory() as snap_dir:
        kw = dict(FLEET, snapshot_dir=snap_dir, factory_kw=arch,
                  timeout_s=1800.0)
        if args.kill_at >= 0:
            kw.update(standbys=1, kill_writer_at_epoch=args.kill_at)
        if args.package == "port":
            from bflc_demo_tpu_torch.client.process_runtime import \
                run_federated_processes
            from bflc_demo_tpu_torch.eval.configs import config5_data
            from bflc_demo_tpu_torch.protocol import ProtocolConfig
            shards, test_set = config5_data(0, 4000, PROTO["client_num"])
            kw["device"] = "cpu"
        else:
            from bflc_demo_tpu.client.process_runtime import \
                run_federated_processes
            from bflc_demo_tpu.data.partition import iid_shards
            from bflc_demo_tpu.data.synthetic import \
                synthetic_text_classification
            from bflc_demo_tpu.eval.configs import _split
            from bflc_demo_tpu.protocol.constants import ProtocolConfig
            x, y = synthetic_text_classification(4000, seq_len=64,
                                                 vocab_size=1000,
                                                 num_classes=2, seed=0)
            xtr, ytr, xte, yte = _split(x, y)
            shards, test_set = (iid_shards(xtr, ytr, PROTO["client_num"]),
                                (xte, yte))
        res = run_federated_processes(
            "make_transformer_classifier", shards, test_set,
            ProtocolConfig(**PROTO), rounds=args.epochs, **kw)
    merges = getattr(res, "writer_merges", None) or []
    print(json.dumps({
        "package": args.package,
        "accuracy": [[int(e), round(float(a), 5)]
                     for e, a in res.accuracy_history],
        "best": float(res.best_accuracy()),
        "epochs": int(res.rounds_completed),
        "drains": [[m.get("drained"), m.get("staleness")] for m in merges],
        "killed_at_epoch": (getattr(res, "failover", None)
                            or {}).get("killed_at_epoch"),
        "settle": (getattr(res, "failover", None) or {}).get("settle"),
        "wall_s": round(float(res.wall_time_s), 1)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
