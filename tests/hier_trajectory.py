"""The two hier legs of `chip_smoke.py` on the CPU, in either package:
the accuracy trajectories their bars are set from.

- `hier_config5`: config 5 on the processes runtime in 4 cells of 5
  (20 clients, committee 4, top-6, lr 0.05, batch 16; the transformer at
  full width), top-k at density 0.01 with i8 values and the members'
  error feedback, 4 validators at the root, 14 root rounds;
- `hier_rehome_drill`: softmax regression on 1,500 occupancy rows, 6
  clients in 3 cells (the reference process test's protocol: committee
  2, 3 admitted, top-2, lr 0.05, batch 16), dense, 4 validators, cell 1's
  aggregator SIGKILLed at root epoch 1, cell stall 3 s and root stall
  5 s, 8 root rounds.

Prints one JSON line: the sponsor's accuracy by round, the best, the
root's log and certified sizes, the members' exit codes and the wall
time.

    python tests/hier_trajectory.py --leg hier_config5 --package port
    JAX_PLATFORMS=cpu python tests/hier_trajectory.py \\
        --leg hier_rehome_drill --package reference

Run it from the repository root, as a file (spawned children re-import
`__main__`).  A helper script, not a test: pytest collects `test_*.py`
only.
"""

import argparse
import json
import os
import sys

LEGS = {
    "hier_config5": dict(
        proto=dict(client_num=20, comm_count=4, aggregate_count=6,
                   needed_update_count=10, learning_rate=0.05,
                   batch_size=16, local_epochs=1, delta_density=0.01,
                   delta_codec="topk", delta_dtype="i8"),
        fleet=dict(cells=4, bft_validators=4), rounds=14),
    "hier_rehome_drill": dict(
        proto=dict(client_num=6, comm_count=2, aggregate_count=2,
                   needed_update_count=3, learning_rate=0.05,
                   batch_size=16),
        fleet=dict(cells=3, bft_validators=4, kill_cell_at_epoch={1: 1},
                   stall_timeout_s=3.0, root_stall_timeout_s=5.0),
        rounds=8),
}
DRILL_ROWS = 1500
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


def _data(package: str, leg: str):
    if package == "port":
        from bflc_demo_tpu_torch.data import iid_shards, load_occupancy
        from bflc_demo_tpu_torch.eval.configs import config5_data
        if leg == "hier_config5":
            return config5_data(0, 4000, 20)
    else:
        from bflc_demo_tpu.data import iid_shards, load_occupancy
        if leg == "hier_config5":
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
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    leg = LEGS[args.leg]
    if leg["proto"].get("delta_density", 1.0) < 1.0:
        os.environ["BFLC_ERROR_FEEDBACK"] = "1"
    os.environ["BFLC_PROC_TRACE"] = "1"
    shards, test_set = _data(args.package, args.leg)
    kw = dict(leg["fleet"], timeout_s=1800.0)
    if args.leg == "hier_config5":
        model = "make_transformer_classifier"
        kw["factory_kw"] = ARCH
    else:
        model = "make_softmax_regression"
    if args.package == "port":
        from bflc_demo_tpu_torch.hier.runtime import run_federated_hier
        from bflc_demo_tpu_torch.protocol import ProtocolConfig
        kw["device"] = "cpu"
    else:
        from bflc_demo_tpu.hier.runtime import run_federated_hier
        from bflc_demo_tpu.protocol.constants import ProtocolConfig
    res = run_federated_hier(model, shards, test_set,
                             ProtocolConfig(**leg["proto"]),
                             rounds=args.rounds or leg["rounds"], **kw)
    info = res.final_info or {}
    print(json.dumps({
        "leg": args.leg, "package": args.package,
        "accuracy": [[int(e), round(float(a), 5)]
                     for e, a in res.accuracy_history],
        "best": float(res.best_accuracy()),
        "rounds": int(res.rounds_completed),
        "log_size": info.get("log_size"),
        "certified_size": info.get("certified_size"),
        "client_exitcodes": list(res.client_exitcodes),
        "wall_s": round(float(res.wall_time_s), 1)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
