"""Models (port of `bflc_demo_tpu/models`): softmax regression, the MLP,
LeNet-5, the FEMNIST CNN, ResNet-18 and the transformer.

`REGISTRY` and the `make_*` entries are the reference's
(`bflc_demo_tpu/models/__init__.py:17-23`).  Every model is float32: a
`dtype` other than float32 raises (the reference's bfloat16 compute path
is the remainder of ROADMAP A10).
"""

from bflc_demo_tpu_torch.models.base import (  # noqa: F401
    Model, Params, canonical_params, keystr)
from bflc_demo_tpu_torch.models.cnn import (  # noqa: F401
    FemnistCNN, LeNet5)
from bflc_demo_tpu_torch.models.cnn import make_femnist_cnn as _femnist
from bflc_demo_tpu_torch.models.cnn import make_lenet5 as _lenet5
from bflc_demo_tpu_torch.models.mlp import MLP  # noqa: F401
from bflc_demo_tpu_torch.models.mlp import make_mlp as _mlp
from bflc_demo_tpu_torch.models.resnet import ResNet18  # noqa: F401
from bflc_demo_tpu_torch.models.resnet import make_resnet18 as _resnet18
from bflc_demo_tpu_torch.models.softmax_regression import (  # noqa: F401
    SoftmaxRegression, make_softmax_regression)
from bflc_demo_tpu_torch.models.transformer import (  # noqa: F401
    TransformerClassifier, TransformerConfig, make_transformer_classifier)


def _float32_only(make):
    def build(*args, dtype="float32", **kw):
        if str(dtype).replace("torch.", "") != "float32":
            raise NotImplementedError(
                f"dtype {dtype} is not ported yet (ROADMAP A10 remainder: "
                f"the bfloat16 compute path); the port's models are "
                f"float32")
        return make(*args, **kw)
    build.__name__ = make.__name__
    build.__doc__ = make.__doc__
    return build


make_mlp = _float32_only(_mlp)
make_lenet5 = _float32_only(_lenet5)
make_femnist_cnn = _float32_only(_femnist)
make_resnet18 = _float32_only(_resnet18)

REGISTRY = {
    "softmax_regression": make_softmax_regression,
    "mlp": make_mlp,
    "lenet5": make_lenet5,
    "femnist_cnn": make_femnist_cnn,
    "resnet18": make_resnet18,
}
