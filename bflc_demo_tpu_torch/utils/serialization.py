"""Canonical tensor bytes, the 32-byte content hash and the blob codecs.

Copy of `bflc_demo_tpu/utils/serialization.py`, so a port model and a
reference model with the same values hash to the same bytes:

    magic | count | for each leaf in sorted key order:
        key | dtype string ('<f4') | ndim | shape | raw little-endian bytes

The reference flattens a JAX pytree and keys each leaf by its
`jax.tree_util.keystr` path (`['blocks'][0]['wq']`).  The port has no
pytrees: it hashes a flat `{keystr: tensor}` mapping (what
`models.base.canonical_params` returns), read through
`.detach().cpu().numpy()` in the reference's orientation.

Everything but `restore_pytree` lives in `utils/codecs.py`, which
imports no torch (a validator re-executes sparse uploads through it),
and is re-exported here: the canonical encoder and hash (:165-208), the
blob layout (`pack_pytree`, `pack_entries`, `unpack_pytree`, :211-276)
and the upload codecs (:71-163, :283-636) — f16/i8 quantization, top-k
and count-sketch sparsification, and their one decode chain
`densify_entries(dequantize_entries(...))`.  `restore_pytree` (entries
-> tensors laid out like a template `Params`) is here.  A blob's
SHA-256 is what a client signs and the ledger certifies, so all of this
is bit-exact, bfloat16 leaves included (`codecs.BF16`).  The
checkpoint format is `utils/checkpoint.py`.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from bflc_demo_tpu_torch.models.base import numpy_to_tensor

from bflc_demo_tpu_torch.utils.codecs import (  # noqa: F401 (re-exported)
    BF16, DELTA_CODECS, DELTA_DTYPES, QSCALE_SUFFIX, SKETCH_SUFFIX, TOPK_SUFFIX,
    canonical_bytes, delta_codec, densify_entries, dequantize_entries,
    error_feedback_enabled, hash_pytree, pack_entries, pack_pytree,
    pack_quantized, pack_sparse, quantize_entries, sketch_entries,
    sketch_geometry, sparse_enabled, sparse_legacy, sparsify_entries,
    topk_count, unpack_pytree)


def restore_pytree(template: Mapping[str, torch.Tensor],
                   flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """`unpack_pytree` output as tensors keyed, typed and placed like
    `template` (a `Params` dict).  KeyError on a missing leaf,
    ValueError on a shape mismatch."""
    out: Dict[str, torch.Tensor] = {}
    for key, want in template.items():
        if key not in flat:
            raise KeyError(f"blob missing leaf {key}")
        arr = np.asarray(flat[key])
        if tuple(arr.shape) != tuple(want.shape):
            raise ValueError(f"leaf {key}: shape {arr.shape} != "
                             f"{tuple(want.shape)}")
        out[key] = numpy_to_tensor(arr, want.device).to(want.dtype)
    return out
