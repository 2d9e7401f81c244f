"""Models (port of `bflc_demo_tpu/models`): softmax regression, the MLP,
LeNet-5, the FEMNIST CNN, ResNet-18 and the transformer.

`REGISTRY` and the `make_*` entries are the reference's
(`bflc_demo_tpu/models/__init__.py:17-23`).  The MLP, the CNNs, ResNet-18
and the transformer take the reference's `dtype` knob, float32 or
bfloat16 (`base.compute_dtype`; another dtype raises ValueError).
"""

from bflc_demo_tpu_torch.models.base import (  # noqa: F401
    Model, Params, canonical_params, compute_dtype, keystr)
from bflc_demo_tpu_torch.models.cnn import (  # noqa: F401
    FemnistCNN, LeNet5, make_femnist_cnn, make_lenet5)
from bflc_demo_tpu_torch.models.mlp import MLP, make_mlp  # noqa: F401
from bflc_demo_tpu_torch.models.resnet import (  # noqa: F401
    ResNet18, make_resnet18)
from bflc_demo_tpu_torch.models.softmax_regression import (  # noqa: F401
    SoftmaxRegression, make_softmax_regression)
from bflc_demo_tpu_torch.models.transformer import (  # noqa: F401
    TransformerClassifier, TransformerConfig, make_transformer_classifier)

REGISTRY = {
    "softmax_regression": make_softmax_regression,
    "mlp": make_mlp,
    "lenet5": make_lenet5,
    "femnist_cnn": make_femnist_cnn,
    "resnet18": make_resnet18,
}
