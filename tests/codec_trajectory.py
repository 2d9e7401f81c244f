"""The two codec legs of `chip_smoke.py` on the CPU, in either package:
the accuracy trajectories their bars are set from.

- `sparse_config5`: config 5 on the processes runtime (20 clients,
  committee 4, top-6, lr 0.05, batch 16; the transformer at full width),
  top-k at density 0.01 with i8 values and the clients' error feedback,
  4 validators at 8 blocks, 1 standby, 7 rounds.
- `sketch_async_drill`: the reference process test's geometry (6
  clients, committee 2, 3 admitted, top-2, 1,500 occupancy rows), async
  with `async_buffer` 3 and `max_staleness` 20, count-sketch at density
  0.1 with f16 values and error feedback, 4 validators at 2 blocks, 4
  epochs.

Prints one JSON line: the sponsor's accuracy by round, the best, the
writer's ingress and egress bytes (under `BFLC_PROC_TRACE=1`), the
certified size and the wall time.

    python tests/codec_trajectory.py --leg sparse_config5 --package port
    JAX_PLATFORMS=cpu python tests/codec_trajectory.py \\
        --leg sketch_async_drill --package reference

Run it from the repository root, as a file (spawned children re-import
`__main__`).  A helper script, not a test: pytest collects `test_*.py`
only.
"""

import argparse
import json
import os
import sys

LEGS = {
    "sparse_config5": dict(
        proto=dict(client_num=20, comm_count=4, aggregate_count=6,
                   needed_update_count=10, learning_rate=0.05,
                   batch_size=16, local_epochs=1, reduce_blocks=8,
                   delta_density=0.01, delta_codec="topk",
                   delta_dtype="i8"),
        fleet=dict(bft_validators=4, standbys=1), rounds=7),
    "sketch_async_drill": dict(
        proto=dict(client_num=6, comm_count=2, aggregate_count=2,
                   needed_update_count=3, learning_rate=0.05,
                   batch_size=16, async_buffer=3, max_staleness=20,
                   reduce_blocks=2, delta_density=0.1,
                   delta_codec="sketch", delta_dtype="f16"),
        fleet=dict(bft_validators=4, stall_timeout_s=30.0), rounds=4),
}
DRILL_ROWS = 1500


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


def _data(package: str, leg: str):
    if package == "port":
        from bflc_demo_tpu_torch.data import iid_shards, load_occupancy
        from bflc_demo_tpu_torch.eval.configs import config5_data
        if leg == "sparse_config5":
            return config5_data(0, 4000, 20)
    else:
        from bflc_demo_tpu.data import iid_shards, load_occupancy
        if leg == "sparse_config5":
            from bflc_demo_tpu.data.synthetic import \
                synthetic_text_classification
            from bflc_demo_tpu.eval.configs import _split
            x, y = synthetic_text_classification(4000, seq_len=64,
                                                 vocab_size=1000,
                                                 num_classes=2, seed=0)
            xtr, ytr, xte, yte = _split(x, y)
            return iid_shards(xtr, ytr, 20), (xte, yte)
    xtr, ytr, xte, yte = load_occupancy()
    return (iid_shards(xtr[:DRILL_ROWS], ytr[:DRILL_ROWS], 6),
            (xte[:500], yte[:500]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--leg", choices=sorted(LEGS), required=True)
    ap.add_argument("--package", choices=("port", "reference"),
                    required=True)
    ap.add_argument("--rounds", type=int, default=0)
    ap.add_argument("--density", type=float, default=0.0,
                    help="the leg's delta_density in place of its own")
    ap.add_argument("--async-buffer", type=int, default=-1,
                    help="the leg's async_buffer in place of its own "
                         "(0: the synchronous rounds)")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    os.environ["BFLC_ERROR_FEEDBACK"] = "1"
    os.environ["BFLC_PROC_TRACE"] = "1"
    leg = LEGS[args.leg]
    shards, test_set = _data(args.package, args.leg)
    kw = dict(leg["fleet"], timeout_s=1800.0)
    if args.leg == "sparse_config5":
        model = "make_transformer_classifier"
        kw["factory_kw"] = dict(vocab_size=1000, seq_len=64, num_classes=2,
                                dim=128, depth=2, heads=4)
    else:
        model = "make_softmax_regression"
    if args.package == "port":
        from bflc_demo_tpu_torch.client.process_runtime import \
            run_federated_processes
        from bflc_demo_tpu_torch.protocol import ProtocolConfig
        kw["device"] = "cpu"
    else:
        from bflc_demo_tpu.client.process_runtime import \
            run_federated_processes
        from bflc_demo_tpu.protocol.constants import ProtocolConfig
    proto = dict(leg["proto"])
    if args.density:
        proto["delta_density"] = args.density
    if args.async_buffer >= 0:
        proto["async_buffer"] = args.async_buffer
    res = run_federated_processes(model, shards, test_set,
                                  ProtocolConfig(**proto),
                                  rounds=args.rounds or leg["rounds"], **kw)
    costs = ((res.final_info or {}).get("perf") or {}).get("costs", {})
    print(json.dumps({
        "leg": args.leg, "package": args.package,
        "delta_density": proto["delta_density"],
        "accuracy": [[int(e), round(float(a), 5)]
                     for e, a in res.accuracy_history],
        "best": float(res.best_accuracy()),
        "rounds": int(res.rounds_completed),
        "wire_bytes_in": costs.get("wire.bytes_in"),
        "wire_bytes_out": costs.get("wire.bytes_out"),
        "certified_size": getattr(res, "certified_size", None),
        "log_size": res.ledger_log_size,
        "wall_s": round(float(res.wall_time_s), 1)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
