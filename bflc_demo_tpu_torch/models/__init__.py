"""Models (port of `bflc_demo_tpu/models`: softmax regression and the
transformer so far)."""

from bflc_demo_tpu_torch.models.base import (  # noqa: F401
    Model, Params, canonical_params, keystr)
from bflc_demo_tpu_torch.models.transformer import (  # noqa: F401
    TransformerClassifier, TransformerConfig, make_transformer_classifier)
from bflc_demo_tpu_torch.models.softmax_regression import (  # noqa: F401
    SoftmaxRegression, make_softmax_regression)
