"""Models (port of `bflc_demo_tpu/models`; the transformer so far)."""

from bflc_demo_tpu_torch.models.base import (  # noqa: F401
    Model, Params, canonical_params, keystr)
from bflc_demo_tpu_torch.models.transformer import (  # noqa: F401
    TransformerClassifier, TransformerConfig, make_transformer_classifier)
