"""Secure aggregation: the port's `parallel/secure.py` and kernel B7's
plain version (`ops/secure_mask.py`) against the reference's
`parallel/secure.py`, on the CPU.

Bit for bit: every masked word (both key modes, with and without the
DH tweak, same-shape leaves) against the reference's `_client_mask` /
`_client_mask_dh` jitted; B7's round entry (`masked_encode_leaves`,
its plain version here) at 2-5 slots over leaves of 1 to 65,537
elements against the same, its (S, total) words against per-leaf
`masked_encode_plain`, one unmask over them against per-leaf unmasks,
the host leaf table (every element in one block, no block across two
leaves, counters from 0 a leaf) and the packed keys (`leaf_keys`' upper
triangle); `derive_pair_seeds`; `secure_fedavg` in
float32 on a 1- and an 8-device reference mesh (its psum is mod 2**32,
so the mesh changes no bit; the step ``g - lr * m`` is one FMA, as
XLA:CPU contracts it) and in bfloat16 (each step rounded to bfloat16,
as XLA:CPU rounds them); `secure_masked_sum`.  Then the reference's
`tests/test_secure.py` scenarios on the port: exact cancellation,
blinding, the capacity guard, masks distinct per round, pair and leaf,
NaN and huge deltas bounded, unselected clients, `_fresh_mask_key`; the
secure mesh runtime (shared key and DH, full and active participation,
one round a dispatch and R); the softmax secure chain against the
reference's op for op; and the slice as a whole: a tiny config-5
dispatch with DH wallets (decisions round for round, parameters within
`SLICE_TOL`, the secure model within `QUANT_TOL` of the plain one) and
config 4 with `secure=True`, narrow, one round (the decision,
parameters within `C4_SLICE_TOL`, every merge within the fixed point's
bound of the plain mean of its deltas).
"""

import inspect

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from bflc_demo_tpu.client import mesh_runtime as ref_mesh_runtime
from bflc_demo_tpu.comm.identity import provision_wallets as ref_wallets
from bflc_demo_tpu.eval import configs as ref_configs
from bflc_demo_tpu.models.transformer import make_transformer_classifier \
    as ref_transformer
from bflc_demo_tpu.parallel import client_axis_mesh
from bflc_demo_tpu.parallel import secure as ref_secure
from bflc_demo_tpu.protocol import ProtocolConfig as RefConfig
from bflc_demo_tpu_torch.client import mesh_runtime
from bflc_demo_tpu_torch.comm.identity import provision_wallets
from bflc_demo_tpu_torch.core import apply_selection
from bflc_demo_tpu_torch.data import iid_shards, load_occupancy
from bflc_demo_tpu_torch.eval import configs
from bflc_demo_tpu_torch.ledger.base import decode_op
from bflc_demo_tpu_torch.models import (make_softmax_regression,
                                        make_transformer_classifier)
from bflc_demo_tpu_torch.ops import secure_mask as sm
from bflc_demo_tpu_torch.parallel import secure
from bflc_demo_tpu_torch.protocol import ProtocolConfig
from bflc_demo_tpu_torch.utils import prng

SCALE = secure._SCALE
# a secure run against the plain run of the same package: the fixed
# point's rounding, at most N slots x 2**-17 a merged element a round,
# times lr, compounded over the rounds' training
QUANT_TOL = 5e-3


def T(a):
    return torch.as_tensor(np.asarray(a))


def _key(seed):
    return np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))


def _vals(rng, n=16, shape=(5, 2)):
    return {"W": rng.standard_normal((n,) + shape).astype(np.float32),
            "b": rng.standard_normal((n, 2)).astype(np.float32)}


def _port(tree):
    return {f"['{k}']": T(v) for k, v in tree.items()}


def _ref(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _seeds(n=8, rnd=3):
    wallets, _ = provision_wallets(n, b"secure-dh-master-000001")
    return secure.derive_pair_seeds(wallets, rnd)


# ----------------------------------------------------- bit for bit
@pytest.mark.parametrize("mode,tweak", [("shared", None), ("dh", None),
                                        ("dh", 3)])
def test_masked_words_equal_the_reference(mode, tweak):
    """Plain B7's masked words are q_i plus the reference's client mask,
    for every client of two same-shape leaves."""
    n, shape = 5, (3, 4)
    rng = np.random.default_rng(1)
    key = jax.random.PRNGKey(3)
    seeds = _seeds(n)
    d = (rng.standard_normal((n,) + shape) * 9).astype(np.float32)
    d[1, 0, 0], d[2, 1, 1], d[3, 2, 2] = np.nan, np.inf, -np.inf
    wn = rng.random(n).astype(np.float32)
    clip = 8.0
    fx = np.clip(np.clip(np.nan_to_num(d, nan=0, posinf=clip, neginf=-clip),
                         -clip, clip) * wn[:, None, None], -clip, clip)
    q = np.round(fx * SCALE).astype(np.int32).astype(np.uint32)
    keys = secure.leaf_keys(seeds if mode == "dh" else _key(3), n, 4,
                            mode == "dh", tweak)
    for leaf in (2, 3):
        got = sm.masked_encode(T(d.reshape(n, -1)), T(wn),
                               T(keys[leaf].view(np.int32)), clip)
        got = got.numpy().view(np.uint32)
        for i in range(n):
            if mode == "dh":
                mask = ref_secure._client_mask_dh(
                    jnp.asarray(seeds), jnp.int32(i), n, shape, leaf,
                    tweak=None if tweak is None else jnp.uint32(tweak))
                port = secure._client_mask_dh(seeds, i, n, shape, leaf,
                                              tweak)
            else:
                mask = ref_secure._client_mask(key, jnp.int32(i), n, shape,
                                               leaf)
                port = secure._client_mask(_key(3), i, n, shape, leaf)
            mask = np.asarray(mask)
            np.testing.assert_array_equal(port, mask)
            with np.errstate(over="ignore"):
                want = q[i] + mask
            np.testing.assert_array_equal(got[i], want.reshape(-1))


def test_masked_words_window_equals_the_whole_leaf():
    """The plain version's `offset`: a window of a leaf gives the whole
    leaf's words there (how the card holds a large leaf)."""
    rng = np.random.default_rng(2)
    d = T(rng.standard_normal((4, 300)).astype(np.float32))
    wn = T(np.full(4, 0.25, np.float32))
    keys = T(secure.leaf_pair_keys(_key(5), 4, 1, False)[0].view(np.int32))
    whole = sm.masked_encode_plain(d, wn, keys, 64.0)
    part = sm.masked_encode_plain(d[:, 173:], wn, keys, 64.0, offset=173)
    assert torch.equal(whole[:, 173:], part)


# ------------------------------------------------ B7's round entry
LEAF_SIZES = (1, 2, 127, 128, 129, 4097, 65537)


def _round(slots, sizes, seed, clip=8.0):
    """A round's (S, n) leaves with NaN, +-inf and values past the clip,
    and the slots' weights."""
    rng = np.random.default_rng(seed)
    leaves = []
    for n in sizes:
        d = (rng.standard_normal((slots, n)) * 9).astype(np.float32)
        flat = d.reshape(-1)
        flat[rng.integers(0, flat.size, 3)] = [np.nan, np.inf, -np.inf]
        leaves.append(d)
    wn = rng.random(slots).astype(np.float32)
    return leaves, wn / wn.sum()


def _ref_round_masks(mode, tweak, slots, sizes, seeds):
    """Each leaf's (S, n) uint32 client masks: the reference's
    `_client_mask` / `_client_mask_dh`, one jitted program a leaf over
    every client."""
    out = []
    for leaf, n in enumerate(sizes):
        if mode == "dh":
            fn = jax.jit(jax.vmap(lambda i, leaf=leaf, n=n:
                                  ref_secure._client_mask_dh(
                                      jnp.asarray(seeds), i, slots, (n,),
                                      leaf, tweak=None if tweak is None
                                      else jnp.uint32(tweak))))
        else:
            fn = jax.jit(jax.vmap(lambda i, leaf=leaf, n=n:
                                  ref_secure._client_mask(
                                      jax.random.PRNGKey(3), i, slots, (n,),
                                      leaf)))
        out.append(np.asarray(fn(jnp.arange(slots, dtype=jnp.int32))))
    return out


@pytest.mark.parametrize("slots", [2, 3, 4, 5])
@pytest.mark.parametrize("mode,tweak", [("shared", None), ("dh", None),
                                        ("dh", 7)])
def test_round_words_equal_the_reference(mode, tweak, slots):
    """The round entry's plain version over leaves of 1 to 65,537
    elements: each slot's words are q_i plus the reference's client mask
    of that leaf, bit for bit; the (S, total) words hold the leaves side
    by side, and each leaf's view is its columns."""
    seeds = _seeds(slots)
    leaves, wn = _round(slots, LEAF_SIZES, slots)
    keys = secure.leaf_pair_keys(seeds if mode == "dh" else _key(3), slots,
                                 len(LEAF_SIZES), mode == "dh", tweak)
    words, views = sm.masked_encode_leaves(
        [T(d) for d in leaves], T(wn), T(keys.view(np.int32)), 8.0)
    assert words.shape == (slots, sum(LEAF_SIZES))
    assert words.dtype == torch.int32
    masks = _ref_round_masks(mode, tweak, slots, LEAF_SIZES, seeds)
    col = 0
    for d, v, mask in zip(leaves, views, masks):
        n = d.shape[1]
        assert v.data_ptr() == words[:, col:].data_ptr()
        col += n
        fx = np.clip(np.clip(np.nan_to_num(d, nan=0, posinf=8.0,
                                           neginf=-8.0), -8.0, 8.0)
                     * wn[:, None], -8.0, 8.0)
        q = np.round(fx * SCALE).astype(np.int32).astype(np.uint32)
        with np.errstate(over="ignore"):
            want = q + mask
        np.testing.assert_array_equal(v.numpy().view(np.uint32), want)


def test_round_words_equal_per_leaf_masked_encode_plain():
    """(S, total) words are each leaf's `masked_encode_plain` words side
    by side, and each leaf's `masked_encode` words under its symmetric
    (S, S, 2) keys."""
    slots = 4
    leaves, wn = _round(slots, LEAF_SIZES, 11)
    full = secure.leaf_keys(_key(8), slots, len(LEAF_SIZES), False)
    packed = secure.leaf_pair_keys(_key(8), slots, len(LEAF_SIZES), False)
    words, views = sm.masked_encode_leaves_plain(
        [T(d) for d in leaves], T(wn), T(packed.view(np.int32)), 8.0)
    want = torch.cat([sm.masked_encode_plain(T(d), T(wn),
                                             T(k.view(np.int32)), 8.0)
                      for d, k in zip(leaves, packed)], 1)
    assert torch.equal(words, want)
    for d, k, v in zip(leaves, full, views):
        assert torch.equal(v, sm.masked_encode(T(d), T(wn),
                                               T(k.view(np.int32)), 8.0))


def test_one_unmask_over_the_round_equals_per_leaf_unmask():
    """`unmask_sum` once over the (S, total) words, split by leaf, is each
    leaf's own unmask bit for bit (the sum over slots is elementwise)."""
    slots = 5
    leaves, wn = _round(slots, LEAF_SIZES, 12)
    keys = secure.leaf_pair_keys(_key(9), slots, len(LEAF_SIZES), False)
    words, views = sm.masked_encode_leaves(
        [T(d) for d in leaves], T(wn), T(keys.view(np.int32)), 8.0)
    whole = torch.split(sm.unmask_sum(words), list(LEAF_SIZES))
    for got, v in zip(whole, views):
        want = sm.unmask_sum(v)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("tile", [128, 256, 512])
def test_leaf_table_covers_every_element_once(tile):
    """The host leaf table, read as the kernel reads it (block b
    belongs to the leaf whose first block is the last at or below b):
    every element of every leaf in exactly one block, no block across
    two leaves, counters from 0 in each leaf's first block, the words'
    columns side by side, and each leaf's pairs at its own rows."""
    slots = 6
    pairs = slots * (slots - 1) // 2
    sizes = list(LEAF_SIZES) + [0, 300]
    table, blocks = sm.leaf_table(sizes, slots, tile, list(range(
        100, 100 + len(sizes))))
    first = table["first_block"]
    assert blocks == sum(-(-n // tile) for n in sizes)
    seen = [np.zeros(n, np.int64) for n in sizes]
    for b in range(blocks):
        owners = [leaf for leaf in range(len(sizes))
                  if first[leaf] <= b < (first[leaf + 1]
                                         if leaf + 1 < len(sizes)
                                         else blocks)]
        assert len(owners) == 1, b            # one leaf, never two
        leaf = owners[0]
        start = (b - first[leaf]) * tile      # the block's first counter
        assert 0 <= start < sizes[leaf]
        seen[leaf][start:start + tile] += 1
    for leaf, n in enumerate(sizes):
        assert (seen[leaf] == 1).all(), leaf
        assert table["n"][leaf] == n
        assert table["out_off"][leaf] == sum(sizes[:leaf])
        assert table["key_off"][leaf] == leaf * pairs
        assert table["deltas"][leaf] == 100 + leaf
    assert first[0] == 0 and (np.diff(first) >= 0).all()
    with pytest.raises(ValueError, match="2\\*\\*32"):
        sm.leaf_table([5, 1 << 32], slots, tile)
    sm.leaf_table([(1 << 32) - 1], slots, tile)


@pytest.mark.parametrize("mode,tweak", [("shared", None), ("dh", None),
                                        ("dh", 7)])
def test_packed_keys_are_leaf_keys_upper_triangle(mode, tweak):
    """B7's packed key table, (L, S(S-1)/2, 2), is `leaf_keys`' upper
    triangle in row order, leaf by leaf, and its lower triangle too
    (each pair draws one mask)."""
    slots, n_leaves = 5, 4
    key = _seeds(slots) if mode == "dh" else _key(4)
    packed = secure.leaf_pair_keys(key, slots, n_leaves, mode == "dh",
                                   tweak)
    full = secure.leaf_keys(key, slots, n_leaves, mode == "dh", tweak)
    lo, hi = np.triu_indices(slots, k=1)
    assert packed.shape == (n_leaves, slots * (slots - 1) // 2, 2)
    np.testing.assert_array_equal(packed, full[:, lo, hi])
    np.testing.assert_array_equal(packed, full[:, hi, lo])


def test_round_entry_refuses_bad_shapes_and_mixed_inputs():
    leaves, wn = _round(3, [4, 9], 0)
    keys = T(secure.leaf_pair_keys(_key(1), 3, 2, False).view(np.int32))
    ok = [T(d) for d in leaves]
    with pytest.raises(ValueError, match="L, S"):
        sm.masked_encode_leaves(ok, T(wn), keys[:1], 8.0)
    with pytest.raises(ValueError, match="L, S"):
        sm.masked_encode_leaves([ok[0], ok[1][:2]], T(wn), keys, 8.0)
    with pytest.raises(ValueError, match="L, S"):
        sm.masked_encode_leaves(ok, T(wn[:2]), keys, 8.0)
    with pytest.raises(ValueError, match="no leaves"):
        sm.masked_encode_leaves([], T(wn), keys, 8.0)


def test_derive_pair_seeds_equal_the_reference():
    port, _ = provision_wallets(5, b"seeds-master-000001")
    ref, _ = ref_wallets(5, b"seeds-master-000001")
    for rnd in (0, 3, 2**40):
        got = secure.derive_pair_seeds(port, rnd)
        want = np.asarray(ref_secure.derive_pair_seeds(ref, rnd))
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("devices", [1, 8])
@pytest.mark.parametrize("mode", ["shared", "dh"])
def test_secure_fedavg_float32_bit_for_bit(devices, mode):
    rng = np.random.default_rng(22 + devices)
    n = 8 if devices == 1 else 16
    deltas = _vals(rng, n)
    params = {"W": rng.standard_normal((5, 2)).astype(np.float32),
              "b": rng.standard_normal((2,)).astype(np.float32)}
    ns = rng.integers(100, 400, n).astype(np.int32)
    sel = rng.random(n) < 0.5
    seeds = _seeds(n) if mode == "dh" else None
    want = ref_secure.secure_fedavg(
        client_axis_mesh(devices), _ref(deltas), jnp.asarray(ns),
        jnp.asarray(sel), _ref(params), 0.05, jax.random.PRNGKey(6),
        pair_seeds=None if seeds is None else jnp.asarray(seeds))
    got = secure.secure_fedavg(_port(deltas), T(ns), T(sel), _port(params),
                               0.05, _key(6), pair_seeds=seeds)
    for k in params:
        np.testing.assert_array_equal(
            got[f"['{k}']"].numpy().view(np.uint32),
            np.asarray(want[k]).view(np.uint32))


def test_secure_fedavg_bfloat16_bit_for_bit():
    """A bfloat16 model (the bfloat16 MLP's): bfloat16 deltas widened
    exactly, ``g - lr * m`` with each step rounded to bfloat16 — bit for
    bit (the class: bit-exact, not within an ulp)."""
    rng = np.random.default_rng(9)
    n = 8
    deltas = {k: v.astype(ml_dtypes.bfloat16)
              for k, v in _vals(rng, n).items()}
    params = {"W": rng.standard_normal((5, 2)).astype(ml_dtypes.bfloat16),
              "b": rng.standard_normal((2,)).astype(ml_dtypes.bfloat16)}
    ns = rng.integers(100, 400, n).astype(np.int32)
    sel = rng.random(n) < 0.6
    want = ref_secure.secure_fedavg(
        client_axis_mesh(1), _ref(deltas), jnp.asarray(ns),
        jnp.asarray(sel), _ref(params), 0.05, jax.random.PRNGKey(2))

    def bf16(tree):
        return {f"['{k}']": T(v.astype(np.float32)).bfloat16()
                for k, v in tree.items()}
    got = secure.secure_fedavg(bf16(deltas), T(ns), T(sel), bf16(params),
                               0.05, _key(2))
    for k in params:
        assert got[f"['{k}']"].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            got[f"['{k}']"].float().numpy(),
            np.asarray(want[k]).astype(np.float32))


def test_secure_fedavg_nested_tree_leaf_order_bit_for_bit():
    """A transformer's nested tree (dict keys inside a list of blocks,
    same-shape leaves): each leaf takes the reference's `tree_flatten`
    index (`ops.fingerprint.leaf_order`, whose numeric list order the
    fingerprint tests hold), so every merged bit agrees."""
    arch = dict(vocab_size=16, seq_len=4, num_classes=2, dim=4, depth=2,
                heads=1)
    ref_params = ref_transformer(attention_impl="einsum", **arch) \
        .init_params(0)
    rng = np.random.default_rng(31)
    n = 5
    deltas = {}

    def draw(path, leaf):
        v = rng.standard_normal((n,) + leaf.shape).astype(np.float32)
        deltas[jax.tree_util.keystr(path)] = v
        return jnp.asarray(v)
    ref_deltas = jax.tree_util.tree_map_with_path(draw, ref_params)
    ns = rng.integers(100, 400, n).astype(np.int32)
    sel = np.array([True, False, True, True, False])
    seeds = _seeds(n)
    want = ref_secure.secure_fedavg(
        client_axis_mesh(1), ref_deltas, jnp.asarray(ns), jnp.asarray(sel),
        ref_params, 0.1, jax.random.PRNGKey(0),
        pair_seeds=jnp.asarray(seeds))
    port_params = make_transformer_classifier(**arch).params_from_jax(
        ref_params)
    got = secure.secure_fedavg({k: T(v) for k, v in deltas.items()}, T(ns),
                               T(sel), port_params, 0.1, None,
                               pair_seeds=seeds)
    assert set(got) == set(deltas)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy().view(np.uint32),
                                      _ref_leaf(want, k).view(np.uint32))


@pytest.mark.parametrize("mode", ["shared", "dh"])
def test_secure_masked_sum_bit_for_bit(mode):
    rng = np.random.default_rng(21)
    vals = _vals(rng, 8)
    seeds = _seeds(8) if mode == "dh" else None
    want = ref_secure.secure_masked_sum(
        client_axis_mesh(8), _ref(vals), jax.random.PRNGKey(1),
        pair_seeds=None if seeds is None else jnp.asarray(seeds))
    got = secure.secure_masked_sum(_port(vals), _key(1), pair_seeds=seeds)
    for k in vals:
        np.testing.assert_array_equal(got[f"['{k}']"].numpy(),
                                      np.asarray(want[k]))


# ------------------------------------------ the reference's scenarios
def test_pairwise_masks_cancel_exactly():
    total = np.zeros((4, 4), np.uint32)
    with np.errstate(over="ignore"):
        for i in range(8):
            total = total + secure._client_mask(_key(0), i, 8, (4, 4), 0)
    np.testing.assert_array_equal(total, 0)


def test_sum_matches_plain_sum():
    vals = _vals(np.random.default_rng(0))
    got = secure.secure_masked_sum(_port(vals), _key(1))
    for k in vals:
        np.testing.assert_allclose(got[f"['{k}']"].numpy(),
                                   vals[k].sum(axis=0),
                                   atol=2 * len(vals[k]) / SCALE)


def test_individual_contribution_is_blinded():
    """A slot's masked words look nothing like its plaintext: no
    correlation, the top byte uniform."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((16, 64 * 64)).astype(np.float32)
    keys = secure.leaf_keys(_key(2), 16, 1, False)[0]
    masked = sm.masked_encode(T(x), T(np.ones(16, np.float32)),
                              T(keys.view(np.int32)), 64.0)
    masked = masked.numpy().view(np.uint32)[3]
    m = masked.astype(np.int64)
    m = (m - m.mean()) / (m.std() + 1e-9)
    xn = (x[3] - x[3].mean()) / x[3].std()
    assert float(np.abs((m * xn).mean())) < 0.05
    counts = np.bincount(((masked >> 24) & 0xFF), minlength=256)
    assert counts.max() < 4 * counts.mean()


def test_capacity_guard():
    vals = _vals(np.random.default_rng(9), n=16)
    with pytest.raises(ValueError, match="capacity"):
        secure.secure_masked_sum(_port(vals), _key(0), clip=4096.0)
    with pytest.raises(ValueError, match="capacity"):
        secure.secure_fedavg(_port(vals), T(np.ones(16, np.int32)),
                             T(np.ones(16, bool)),
                             {k: torch.zeros(v.shape[1:])
                              for k, v in _port(vals).items()},
                             0.1, _key(0), clip=32768.0)


def test_different_rounds_pairs_and_leaves_different_masks():
    k = _key(4)
    m1 = secure._client_mask(prng.fold_in(k, 1), 0, 8, (16,), 0)
    m2 = secure._client_mask(prng.fold_in(k, 2), 0, 8, (16,), 0)
    assert not np.array_equal(m1, m2)
    assert not np.array_equal(secure._client_mask(k, 1, 4, (8,), 0),
                              secure._client_mask(k, 1, 4, (8,), 1))
    seeds = _seeds(4)
    assert not np.array_equal(secure._client_mask_dh(seeds, 1, 4, (8,), 0),
                              secure._client_mask_dh(seeds, 1, 4, (8,), 1))
    assert not np.array_equal(
        secure._client_mask_dh(seeds, 1, 4, (8,), 0, tweak=0),
        secure._client_mask_dh(seeds, 1, 4, (8,), 0, tweak=1))


def test_dh_masks_cancel_and_seeds_are_round_bound_and_symmetric():
    seeds = _seeds(8)
    total = np.zeros((4, 4), np.uint32)
    with np.errstate(over="ignore"):
        for i in range(8):
            total = total + secure._client_mask_dh(seeds, i, 8, (4, 4), 0)
    np.testing.assert_array_equal(total, 0)
    s4 = _seeds(8, rnd=4)
    assert not np.array_equal(seeds, s4)
    np.testing.assert_array_equal(seeds, seeds.transpose(1, 0, 2))
    iu = np.triu_indices(8, k=1)
    flat = seeds[iu[0], iu[1]].reshape(-1, 8)
    assert len(np.unique(flat, axis=0)) == len(flat)


def test_dh_sum_matches_plain_sum():
    vals = _vals(np.random.default_rng(21), 8)
    got = secure.secure_masked_sum(_port(vals), None, pair_seeds=_seeds(8))
    for k in vals:
        np.testing.assert_allclose(got[f"['{k}']"].numpy(),
                                   vals[k].sum(axis=0), atol=2 * 8 / SCALE)


def test_bad_seeds_rejected():
    vals = _port(_vals(np.random.default_rng(0), 8))
    with pytest.raises(ValueError, match=r"\(8, 8, 8\)"):
        secure.secure_masked_sum(vals, None,
                                 pair_seeds=np.zeros((4, 4, 2), np.uint32))
    asym = _seeds(8)
    asym[0, 1, 0] ^= 1
    with pytest.raises(ValueError, match="symmetric"):
        secure.secure_masked_sum(vals, None, pair_seeds=asym)


@pytest.mark.parametrize("mode", ["shared", "dh"])
def test_secure_fedavg_matches_apply_selection(mode):
    rng = np.random.default_rng(5)
    n = 8
    deltas = _port(_vals(rng, n))
    params = {"['W']": T(rng.standard_normal((5, 2)).astype(np.float32)),
              "['b']": T(rng.standard_normal((2,)).astype(np.float32))}
    ns = T(rng.integers(100, 400, n).astype(np.int32))
    sel = T(rng.random(n) < 0.5)
    got = secure.secure_fedavg(deltas, ns, sel, params, 0.05, _key(6),
                               pair_seeds=_seeds(n) if mode == "dh"
                               else None)
    want = apply_selection(params, deltas, ns, sel, 0.05)
    for k in params:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=0.05 * n / SCALE + 1e-6)


def test_unselected_clients_contribute_nothing():
    rng = np.random.default_rng(7)
    n = 8
    deltas = _vals(rng, n)
    params = {"['W']": torch.zeros((5, 2)), "['b']": torch.zeros(2)}
    ns = T(np.full(n, 100, np.int32))
    sel = T(np.array([True] * 4 + [False] * 4))
    got = secure.secure_fedavg(_port(deltas), ns, sel, params, 1.0, _key(8))
    deltas2 = {k: np.concatenate([v[:4], np.full_like(v[4:], 999.0)])
               for k, v in deltas.items()}
    got2 = secure.secure_fedavg(_port(deltas2), ns, sel, params, 1.0,
                                _key(8))
    for k in params:
        assert torch.equal(got[k], got2[k])


def test_adversarial_huge_deltas_stay_bounded():
    rng = np.random.default_rng(11)
    n, clip = 16, 8.0
    deltas = {k: v * 1e6 for k, v in _vals(rng, n).items()}
    params = {"['W']": torch.zeros((5, 2)), "['b']": torch.zeros(2)}
    ns, sel = T(np.full(n, 100, np.int32)), T(np.ones(n, bool))
    got = secure.secure_fedavg(_port(deltas), ns, sel, params, 1.0,
                               _key(12), clip=clip)
    want = apply_selection(params, _port({k: np.clip(v, -clip, clip)
                                          for k, v in deltas.items()}),
                           ns, sel, 1.0)
    for k in params:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=n / SCALE + 1e-6)
        assert bool((got[k].abs() <= clip + 1e-3).all())


def test_nan_delta_cannot_corrupt_aggregate():
    rng = np.random.default_rng(13)
    n = 8
    deltas = _vals(rng, n)
    poisoned = {k: v.copy() for k, v in deltas.items()}
    zeroed = {k: v.copy() for k, v in deltas.items()}
    for k in deltas:
        poisoned[k][2] = np.nan
        zeroed[k][2] = 0.0
    params = {"['W']": torch.zeros((5, 2)), "['b']": torch.zeros(2)}
    ns, sel = T(np.full(n, 100, np.int32)), T(np.ones(n, bool))
    got = secure.secure_fedavg(_port(poisoned), ns, sel, params, 1.0,
                               _key(14))
    want = apply_selection(params, _port(zeroed), ns, sel, 1.0)
    for k in params:
        assert bool(torch.isfinite(got[k]).all())
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=n / SCALE + 1e-6)


def test_mask_keys_not_derived_from_public_seed():
    k1, k2 = mesh_runtime._fresh_mask_key(), mesh_runtime._fresh_mask_key()
    assert k1.shape == (2,) and k1.dtype == np.uint32
    assert not np.array_equal(k1, k2)
    assert inspect.signature(mesh_runtime._fresh_mask_key).parameters == {}


# ------------------------------------------------ the mesh runtime
def _occupancy_run(secure_aggregation, wallets=None, n=8, rows=1200,
                   **kw):
    cfg = ProtocolConfig(client_num=n, comm_count=2, aggregate_count=2,
                         needed_update_count=3, learning_rate=0.05,
                         batch_size=16, local_epochs=1)
    xtr, ytr, xte, yte = load_occupancy()
    shards = iid_shards(xtr[:rows], ytr[:rows], n)
    return mesh_runtime.run_federated_mesh(
        make_softmax_regression(), shards, (xte[:400], yte[:400]), cfg,
        seed=3, secure_aggregation=secure_aggregation,
        secure_wallets=wallets, device="cpu", **kw)


@pytest.mark.parametrize("kw", [
    dict(rounds=2), dict(rounds=2, wallets="provision"),
    dict(rounds=4, rounds_per_dispatch=2),
    dict(rounds=4, rounds_per_dispatch=2, wallets="provision")])
def test_secure_run_commits_plain_run_model(kw):
    """Shared-key and DH secure runs, one round a dispatch and two, commit
    the plain run's model within the fixed point's quantisation; DH runs
    attest their committee rows with the same wallets."""
    if kw.get("wallets") == "provision":
        kw = dict(kw, wallets=provision_wallets(8, b"mesh-secure-01")[0])
    plain = _occupancy_run(False, **{k: v for k, v in kw.items()
                                     if k != "wallets"})
    masked = _occupancy_run(True, **kw)
    assert masked.rounds_completed == plain.rounds_completed
    for k in plain.final_params:
        np.testing.assert_allclose(masked.final_params[k].numpy(),
                                   plain.final_params[k].numpy(),
                                   atol=QUANT_TOL)
    assert (masked.attest_log is not None) == ("wallets" in kw)


def test_secure_active_participation():
    """Active slots: the masks span exactly the round's occupants."""
    wallets, _ = provision_wallets(12, b"mesh-secure-master-02")
    res = _occupancy_run(True, wallets, n=12, rounds=2,
                         participation="active")
    assert res.rounds_completed == 2
    assert all(np.isfinite(a) for _, a in res.accuracy_history)
    assert sorted(res.attest_log) == [0, 1]


def _secure_tiny_config1(package, rounds=2, dispatch=1):
    cfg = dict(client_num=8, comm_count=2, aggregate_count=2,
               needed_update_count=3, learning_rate=0.05, batch_size=16)
    xtr, ytr, xte, yte = load_occupancy()
    shards = iid_shards(xtr[:800], ytr[:800], 8)
    if package == "ref":
        from bflc_demo_tpu.models import make_softmax_regression as ref_m
        return ref_mesh_runtime.run_federated_mesh(
            ref_m(), shards, (xte[:200], yte[:200]), RefConfig(**cfg),
            rounds=rounds, mesh=client_axis_mesh(1), seed=1,
            ledger_backend="python", rounds_per_dispatch=dispatch,
            secure_aggregation=True,
            secure_wallets=ref_wallets(8, b"slice-c1-seed-0001")[0])
    return mesh_runtime.run_federated_mesh(
        make_softmax_regression(), shards, (xte[:200], yte[:200]),
        ProtocolConfig(**cfg), rounds=rounds, seed=1, device="cpu",
        rounds_per_dispatch=dispatch, secure_aggregation=True,
        secure_wallets=provision_wallets(8, b"slice-c1-seed-0001")[0])


@pytest.mark.parametrize("dispatch", [1, 2])
def test_secure_config1_shape_matches_reference_bit_for_bit(dispatch):
    """Softmax regression, DH, both mesh programs: the port's secure chain
    is the reference's op for op — every payload id, score and model id
    bit for bit (the deltas and the masked merge are) — but for the
    uploads' `avg_cost`, within one float32 ulp: the reference's secure
    program fuses its loss sums in another order than its plain one,
    which the port mirrors."""
    got = _secure_tiny_config1("port", 4, dispatch)
    want = _secure_tiny_config1("ref", 4, dispatch)
    assert got.ledger_log_size == want.ledger_log_size == 8 + 4 * 6
    for i in range(got.ledger_log_size):
        a = decode_op(got.ledger.log_op(i))
        b = decode_op(want.ledger.log_op(i))
        ca, cb = a.pop("avg_cost", 0.0), b.pop("avg_cost", 0.0)
        assert a == b
        assert abs(ca - cb) <= 2 ** -23 * max(abs(cb), 1.0) * 2
    assert got.accuracy_history == want.accuracy_history
    assert got.attest_log == want.attest_log


def _ref_leaf(tree, key):
    """The reference pytree's leaf at the port's keystr key."""
    leaves = {jax.tree_util.keystr(p): v for p, v in
              jax.tree_util.tree_flatten_with_path(tree)[0]}
    return np.asarray(leaves[key])


# ------------------------------------------------------- the slice
# a tiny config-5 dispatch, port against reference: max |diff| of the
# final params (the transformer's attention sums in another order)
SLICE_TOL = 1e-4
TRANSFORMER = dict(vocab_size=64, seq_len=16, num_classes=2, dim=16,
                   depth=1, heads=2)


def _text(rng, n):
    x = rng.integers(1, 64, (n, 16)).astype(np.int32)
    x[::3, 11:] = 0
    return x, (x[:, 0] > 31).astype(np.int32)


def _decisions(led):
    out = []
    for i in range(led.log_size()):
        d = decode_op(led.log_op(i))
        for k in ("payload_hash", "model_hash", "avg_cost", "scores"):
            d.pop(k, None)
        out.append(d)
    return out


def test_secure_config5_dispatch_matches_reference():
    """A tiny config-5 dispatch (the transformer, DH wallets, R = 2, 4
    rounds): the port's decisions equal the reference's round for round
    (op for op but the float-derived ids), parameters within SLICE_TOL,
    the secure model within QUANT_TOL of the port's plain run."""
    rng = np.random.default_rng(0)
    x, y = _text(rng, 480)
    shards = iid_shards(x[:400], y[:400], 8)
    test = (x[400:], y[400:])
    cfg = dict(client_num=8, comm_count=2, aggregate_count=2,
               needed_update_count=3, learning_rate=0.05, batch_size=8)
    want = ref_mesh_runtime.run_federated_mesh(
        ref_transformer(attention_impl="einsum", **TRANSFORMER), shards,
        test, RefConfig(**cfg), rounds=4, mesh=client_axis_mesh(1), seed=2,
        ledger_backend="python", rounds_per_dispatch=2,
        secure_aggregation=True,
        secure_wallets=ref_wallets(8, b"slice-c5-seed-0001")[0])
    model = make_transformer_classifier(**TRANSFORMER)
    kw = dict(rounds=4, seed=2, device="cpu", rounds_per_dispatch=2)
    got = mesh_runtime.run_federated_mesh(
        model, shards, test, ProtocolConfig(**cfg), secure_aggregation=True,
        secure_wallets=provision_wallets(8, b"slice-c5-seed-0001")[0], **kw)
    assert _decisions(got.ledger) == _decisions(want.ledger)
    assert sorted(got.attest_log) == sorted(want.attest_log) == [0, 1, 2, 3]
    diff = max(float(np.abs(got.final_params[k].numpy()
                            - _ref_leaf(want.final_params, k)).max())
               for k in got.final_params)
    assert diff <= SLICE_TOL, diff
    plain = mesh_runtime.run_federated_mesh(
        model, shards, test, ProtocolConfig(**cfg), **kw)
    qdiff = max(float((got.final_params[k] - plain.final_params[k])
                      .abs().max()) for k in got.final_params)
    assert qdiff <= QUANT_TOL, qdiff


# config 4 narrow, port against reference, max |diff| of the final
# params: 10x the 2.0e-4 measured over 2 rounds (secure and plain
# alike; 4.1e-5 after one): both packages merge bit for bit (above), but
# their float32 training differs in summation order (the convolutions
# and group norms; the params' scale ~1)
C4_SLICE_TOL = 2e-3
C4 = dict(client_num=8, comm_count=2, aggregate_count=2,
          needed_update_count=2, learning_rate=0.1, batch_size=16,
          local_epochs=1)


def _record(monkeypatch, module, log):
    inner = module.audit_round

    def wrapped(ledger, addr_of, epoch, ups, comm, *rest):
        inner(ledger, addr_of, epoch, ups, comm, *rest)
        log.append((epoch, list(ups), list(comm),
                    sorted(int(s) for s in rest[6])))
    monkeypatch.setattr(module, "audit_round", wrapped)


def test_secure_config4_narrow_matches_reference(monkeypatch):
    """Config 4 with `secure=True` (ResNet-18, active slots, client_chunk
    4, remat, X25519 wallets from the preset's seed), narrow: 8 clients,
    2 + 2 slots, 200 images, one round (each of the reference's secure
    ResNet rounds takes ~80 s on the CPU; the rounds after a secure
    merge are held by the config-5 dispatch above).  The
    decision (uploaders, committee and selection, through both
    runtimes' `audit_round`) equals the reference's, parameters within
    C4_SLICE_TOL; B7 (its plain version) one call a round over the 62
    leaves, each leaf's merge within the fixed point's bound of the
    plain weighted mean of its deltas (S x 2**-17 plus float32
    rounding)."""
    ref_log, port_log, merges, calls = [], [], [], []
    _record(monkeypatch, ref_mesh_runtime, ref_log)
    _record(monkeypatch, mesh_runtime, port_log)
    real = sm.masked_encode_leaves

    def tapped(leaves, wn, keys, clip):
        words, views = real(leaves, wn, keys, clip)
        calls.append(len(leaves))
        merges.extend((d, wn, clip, v) for d, v in zip(leaves, views))
        return words, views
    monkeypatch.setattr(sm, "masked_encode_leaves", tapped)
    got = configs.config4_resnet_cifar100(
        rounds=1, n_data=200, cfg=ProtocolConfig(**C4), secure=True,
        device="cpu")
    want = ref_configs.config4_resnet_cifar100(
        rounds=1, n_data=200, cfg=RefConfig(**C4), secure=True,
        mesh=client_axis_mesh(1), ledger_backend="python")
    assert len(port_log) == 1 and port_log == ref_log
    assert got.ledger_log_size == want.ledger_log_size == 8 + 5
    assert sorted(got.attest_log) == [0]
    diff = max(float(np.abs(got.final_params[k].numpy()
                            - _ref_leaf(want.final_params, k)).max())
               for k in got.final_params)
    assert diff <= C4_SLICE_TOL, diff
    assert calls == [62] and len(merges) == 62
    for deltas, wn, clip, words in merges:
        assert deltas.shape[0] == 4
        x = np.clip(np.nan_to_num(deltas.double().numpy(), nan=0.0,
                                  posinf=clip, neginf=-clip), -clip, clip)
        x = np.clip(x * wn.double().numpy()[:, None], -clip, clip)
        gap = np.abs(sm.unmask_sum(words).double().numpy() - x.sum(0))
        bound = 4 * 2.0 ** -17 + 2.0 ** -23 * (np.abs(x).sum(0)
                                               + np.abs(x.sum(0)))
        assert (gap <= bound).all()
