"""The port's payload fingerprints against `bflc_demo_tpu.ops.fingerprint`.

The ids are ledger bytes, so the match is bit for bit: the same numpy
values (made from a seed) go through the reference's
`fingerprint_pytree` / `fingerprint_stacked` and the port's, for every
leaf dtype the port maps to a JAX dtype name (64-bit leaves under
`jax.enable_x64`), for ragged word counts (not a multiple of 8), scalars
and empty leaves, for stacked deltas, for a tree whose sequence indices
reach 10 (where sorting whole keystr strings would put "[10]" before
"[2]"), and for the config-5 transformer's tree at a small width.  On
the CPU the wrappers run `fingerprint_plain` and count no launch.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from bflc_demo_tpu.models.transformer import make_transformer_classifier \
    as ref_transformer
from bflc_demo_tpu.ops import fingerprint as ref
from bflc_demo_tpu_torch.models import make_transformer_classifier
from bflc_demo_tpu_torch.ops import fingerprint as fp


def _values(dtype: str, shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return rng.random(shape) < 0.5
    if dtype.startswith(("int", "uint")):
        info = np.iinfo(dtype)
        return rng.integers(info.min, info.max, shape, endpoint=True,
                            dtype=dtype)
    vals = (rng.standard_normal(shape) * 3).astype(np.float32)
    if dtype == "bfloat16":
        return vals.astype(ml_dtypes.bfloat16)
    return vals.astype(dtype)


def _torch(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))       # keeps 0-d arrays 0-d


def _flat(tree):
    """The reference's tree as the port's keystr-keyed dict."""
    return {jax.tree_util.keystr(p): _torch(np.asarray(v))
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _ref_bytes(tree, stacked=False):
    fn = ref.fingerprint_stacked if stacked else ref.fingerprint_pytree
    out = np.asarray(fn(jax.tree_util.tree_map(jnp.asarray, tree)))
    return ([ref.fingerprint_to_bytes(r) for r in out] if stacked
            else ref.fingerprint_to_bytes(out))


DTYPES = ["float32", "bfloat16", "float16", "int8", "uint8", "bool",
          "int16", "int32", "uint32"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(3, 5), (13,), (), (4, 2, 8)])
def test_one_leaf_matches_reference(dtype, shape):
    tree = {"w": _values(dtype, shape, seed=len(shape))}
    got = fp.fingerprint_pytree(_flat(tree))
    assert got.shape == (8,) and got.dtype == torch.int64
    assert fp.fingerprint_to_bytes(got) == _ref_bytes(tree)


@pytest.mark.parametrize("dtype", ["float64", "int64"])
def test_64_bit_leaves_give_two_words_each(dtype):
    with jax.enable_x64(True):
        tree = {"a": _values(dtype, (3, 3), seed=1),
                "b": _values("float32", (5,), seed=2)}
        want = _ref_bytes(tree)
    assert fp.fingerprint_to_bytes(fp.fingerprint_pytree(_flat(tree))) \
        == want


def test_mixed_tree_with_empty_leaf_and_nested_order():
    tree = {"z": _values("float32", (7,), 0),
            "a": {"y": _values("int8", (9,), 1),
                  "b": (_values("bool", (2, 3), 2),
                        _values("float16", (0,), 3),
                        _values("bfloat16", (17,), 4))},
            "m": _values("int32", (1, 1), 5)}
    assert fp.fingerprint_to_bytes(fp.fingerprint_pytree(_flat(tree))) \
        == _ref_bytes(tree)


def test_leaf_order_is_the_reference_tree_order_past_index_ten():
    blocks = tuple({"w": _values("float32", (3,), i)} for i in range(12))
    tree = {"blocks": blocks, "head": _values("float32", (2,), 99)}
    flat = _flat(tree)
    want = [jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert fp.leaf_order(list(reversed(list(flat)))) == want
    assert sorted(flat) != want            # a whole-string sort differs
    assert fp.fingerprint_to_bytes(fp.fingerprint_pytree(flat)) \
        == _ref_bytes(tree)


@pytest.mark.parametrize("k", [1, 5])
def test_stacked_deltas_match_reference(k):
    tree = {"W": _values("float32", (k, 5, 2), 7),
            "b": _values("float32", (k, 2), 8),
            "q": {"i": _values("int8", (k, 11), 9)}}
    got = fp.fingerprint_stacked(_flat(tree))
    assert got.shape == (k, 8)
    assert [fp.fingerprint_to_bytes(r) for r in got] \
        == _ref_bytes(tree, stacked=True)


def test_transformer_tree_matches_reference_and_counts_no_launch():
    cfg = dict(vocab_size=64, seq_len=16, num_classes=2, dim=16, depth=3,
               heads=2)
    ref_params = ref_transformer(attention_impl="einsum", **cfg) \
        .init_params(0)
    port = make_transformer_classifier(**cfg)
    params = port.params_from_jax(ref_params)
    fp.reset_launches()
    got = fp.fingerprint_pytree(params)
    assert fp.fingerprint_to_bytes(got) == _ref_bytes(ref_params)
    # three stacked "deltas" of the same tree
    rng = np.random.default_rng(3)
    stacked = jax.tree_util.tree_map(
        lambda v: rng.standard_normal((3,) + np.shape(v))
        .astype(np.float32), ref_params)
    rows = fp.fingerprint_stacked(_flat(stacked))
    assert [fp.fingerprint_to_bytes(r) for r in rows] \
        == _ref_bytes(stacked, stacked=True)
    assert fp.LAUNCHES["fingerprint"] == 0


def test_sensitive_to_value_dtype_and_shape():
    base = {"['w']": torch.arange(8, dtype=torch.float32)}
    ids = {fp.fingerprint_to_bytes(fp.fingerprint_pytree(t)) for t in (
        base,
        {"['w']": base["['w']"].clone().index_fill_(0, torch.tensor([3]),
                                                    7.5)},
        {"['w']": base["['w']"].view(torch.int32)},
        {"['w']": base["['w']"].reshape(2, 4)})}
    assert len(ids) == 4


def test_to_bytes_and_bad_inputs():
    fp8 = torch.arange(8, dtype=torch.int64) + (1 << 31)
    want = np.arange(8, dtype=np.uint32) + np.uint32(1 << 31)
    assert fp.fingerprint_to_bytes(fp8) == want.astype("<u4").tobytes()
    with pytest.raises(ValueError, match="expected"):
        fp.fingerprint_to_bytes(torch.zeros(7, dtype=torch.int64))
    with pytest.raises(ValueError, match="keystr"):
        fp.leaf_order(["w"])
    with pytest.raises(TypeError, match="unsupported dtype"):
        fp.fingerprint_pytree({"['c']": torch.zeros(2,
                                                     dtype=torch.complex64)})
