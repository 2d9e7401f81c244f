"""Data pipeline (numpy; copies of `bflc_demo_tpu/data`, the config-1 and
config-5 subset)."""

from bflc_demo_tpu_torch.data.occupancy import (  # noqa: F401
    load_occupancy, occupancy_source)
from bflc_demo_tpu_torch.data.partition import iid_shards, one_hot  # noqa: F401
from bflc_demo_tpu_torch.data.synthetic import (  # noqa: F401
    synthetic_text_classification)
