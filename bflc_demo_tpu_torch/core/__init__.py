"""FL math: local train, evaluate, score, decide, apply the selection."""

from bflc_demo_tpu_torch.core.aggregate import (  # noqa: F401
    AggregateResult, aggregate, apply_selection, elect_committee,
    median_scores, rank_desc_stable, topk_selection_mask)
from bflc_demo_tpu_torch.core.local_train import (  # noqa: F401
    evaluate, local_train, local_train_stacked)
from bflc_demo_tpu_torch.core.losses import (  # noqa: F401
    accuracy, softmax_cross_entropy)
from bflc_demo_tpu_torch.core.scoring import score_candidates  # noqa: F401
