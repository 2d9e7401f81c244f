"""Data pipeline (numpy; copies of `bflc_demo_tpu/data`, config-5 subset)."""

from bflc_demo_tpu_torch.data.partition import iid_shards, one_hot  # noqa: F401
from bflc_demo_tpu_torch.data.synthetic import (  # noqa: F401
    synthetic_text_classification)
