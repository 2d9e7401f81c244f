"""A secure run against its plain twin at the full preset: the gaps
`chip_smoke.py`'s secure legs take their parameter bounds from
(`SECURE_C4_PARAM_TOL`, `SECURE_C5_PARAM_TOL`).

- `config4`: config 4's preset on the mesh runtime (ResNet-18, 32
  clients, active, client_chunk 4, remat), SECURE_C4_ROUNDS rounds,
  plain and `secure=True` (32 X25519 wallets from the preset's seed);
- `config5`: config 5 on the mesh runtime at `rounds_per_dispatch`
  DISPATCH_R, DISPATCH_ROUNDS rounds, plain and with 20 wallets from
  SECURE_C5_WALLET_SEED (the legs `dispatch_config5` and
  `secure_dispatch_config5`).

Both runs start from the same seed, so they part only where a merge's
fixed-point rounding flips a decision; past that the two trajectories
are chaotic, and the gap depends on the float summation order (the
device, the CPU's threads).  Prints one JSON line: each round's decision
(uploaders, committee, selected) in both runs, the first round whose
decisions differ (0-based, null if none), the largest |difference| of
the final parameters, both accuracy histories and the wall times.

    python tests/secure_pair.py --leg config4            # on the card
    python tests/secure_pair.py --leg config5 --device cpu

Run it from the repository root.  A helper script, not a test: pytest
collects `test_*.py` only.
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def run(leg: str, secure: bool, device: str):
    from bflc_demo_tpu_torch.comm.identity import provision_wallets
    from bflc_demo_tpu_torch.eval import configs
    tap = cs.DecisionTap()
    t0 = time.perf_counter()
    try:
        if leg == "config4":
            res = configs.config4_resnet_cifar100(
                rounds=cs.SECURE_C4_ROUNDS, secure=secure, device=device)
        else:
            kw = {}
            if secure:
                wallets, _ = provision_wallets(
                    cs.CONFIG5_PROTO["client_num"], cs.SECURE_C5_WALLET_SEED)
                kw = dict(secure_aggregation=True, secure_wallets=wallets)
            res = configs.config5_transformer_sst2(
                rounds=cs.DISPATCH_ROUNDS, runtime="mesh", device=device,
                rounds_per_dispatch=cs.DISPATCH_R, **kw)
    finally:
        tap.undo()
    return tap.rounds, res, time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--leg", choices=("config4", "config5"), required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    (plain, p, p_s), (secure, s, s_s) = (run(args.leg, False, args.device),
                                         run(args.leg, True, args.device))
    diff = max(float((p.final_params[k].float()
                      - s.final_params[k].float()).abs().max())
               for k in p.final_params)
    print(json.dumps({
        "leg": args.leg, "device": args.device, "plain_decisions": plain,
        "secure_decisions": secure,
        "first_divergent_round": cs.first_divergence(secure, plain),
        "max_param_diff": diff,
        "plain_accuracy": [a for _, a in p.accuracy_history],
        "secure_accuracy": [a for _, a in s.accuracy_history],
        "plain_s": p_s, "secure_s": s_s}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
