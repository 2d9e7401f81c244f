"""FL math: local train, evaluate, score, apply the selection."""

from bflc_demo_tpu_torch.core.aggregate import apply_selection  # noqa: F401
from bflc_demo_tpu_torch.core.local_train import (  # noqa: F401
    evaluate, local_train)
from bflc_demo_tpu_torch.core.losses import (  # noqa: F401
    accuracy, softmax_cross_entropy)
from bflc_demo_tpu_torch.core.scoring import score_candidates  # noqa: F401
