"""Repeat `chip_smoke.py`'s `failover_config5` leg on the card: config 5
at full width as a process fleet with 2 standbys and quorum-ack 1, the
primary SIGKILLed as soon as it commits epoch 2 of 9, each run held to
the leg's own gates (`FLEET_C5_ROUNDS` = 9 rounds, best accuracy at the
config-5 bar, the promoted writer finishing the run).  The kill races
the commit op's frame (it carries the model) to the two standbys, so
repeats are what exercise a standby promoting without the dead writer's
last op.

    python3 tests/failover_config5_repeat.py [N]      # default 4 runs

Needs one CUDA card; prints an `ITER` line a run and a `SUMMARY`, and
exits 1 if any run failed.  Verbose: the standbys' lines show a
promotion and any suffix a follower dropped."""
import os
import sys
import time
import traceback

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)


def main(n):
    import chip_smoke as cs
    torch, fa, build, device = cs.load_port(ROOT)
    t0 = time.perf_counter()
    build.build_all()
    print("build", time.perf_counter() - t0, flush=True)
    card = cs.card_line()
    print(card, flush=True)
    from bflc_demo_tpu_torch.client.process_runtime import \
        run_federated_processes
    from bflc_demo_tpu_torch.eval.configs import config5_data
    from bflc_demo_tpu_torch.protocol import ProtocolConfig
    c5_shards, c5_test = config5_data(0, 4000,
                                      cs.CONFIG5_PROTO["client_num"])
    summary = []
    for i in range(n):
        t1 = time.perf_counter()
        try:
            res, *out = cs.fleet_run(
                torch, "failover_config5", card,
                lambda: run_federated_processes(
                    "make_transformer_classifier", c5_shards, c5_test,
                    ProtocolConfig(**cs.CONFIG5_PROTO),
                    rounds=cs.FLEET_C5_ROUNDS, factory_kw=cs.CONFIG5_ARCH,
                    device="cuda", timeout_s=cs.FLEET_TIMEOUT_S,
                    verbose=True, **cs.CONFIG5_FAILOVER))
            cs.config5_check("failover_config5", res, cs.FLEET_C5_ROUNDS)
            cs.failover_check("failover_config5", res, cs.FLEET_C5_ROUNDS,
                              cs.MIN_BEST_ACC)
            summary.append((i, "ok", round(time.perf_counter() - t1, 1),
                            res.best_accuracy(),
                            res.failover.get("gap_s")))
        except Exception as e:
            traceback.print_exc()
            summary.append((i, f"FAIL {e!r}",
                            round(time.perf_counter() - t1, 1)))
        print("ITER", summary[-1], flush=True)
    print("SUMMARY", summary, flush=True)
    return 0 if all(s[1] == "ok" for s in summary) else 1


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 4))
