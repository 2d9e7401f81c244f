"""Data pipeline (numpy; copies of `bflc_demo_tpu/data`)."""

from bflc_demo_tpu_torch.data.occupancy import (  # noqa: F401
    load_occupancy, occupancy_source)
from bflc_demo_tpu_torch.data.partition import (  # noqa: F401
    dirichlet_shards, iid_shards, one_hot)
from bflc_demo_tpu_torch.data.synthetic import (  # noqa: F401
    load_image_dataset, synthetic_cifar10, synthetic_cifar100,
    synthetic_femnist, synthetic_image_classification, synthetic_mnist,
    synthetic_text_classification)
