"""The closed compression loop's decision rule (`control/loop.py`).

Copy of `bflc_demo_tpu/control/__init__.py`: the rule that maps
certified convergence telemetry to the effective compression knobs, the
policy half of the genome-update op (ledger opcode 13).  The writer
proposes `decide(...)`'s output and every replica re-runs it inside
`PyLedger.apply_op`, refusing BAD_ARG on a mismatch.
"""

from bflc_demo_tpu_torch.control.loop import (decide,  # noqa: F401
                                              model_telemetry,
                                              score_disagreement)
