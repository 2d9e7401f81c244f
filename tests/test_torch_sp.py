"""The port's sequence-parallel transformer against the JAX package.

- `FoldedAxis` on a hand-built example: the shard-major fold, the roll
  direction (shard i receives shard i-1's rows), psum and offsets.
- `make_sp_transformer_forward` logits against the reference's
  (`attention_impl="pallas_interpret"`) on the virtual CPU mesh for n_sp
  in {2, 4, 8} (seq 32, dim 32, depth 1, 2 heads), with heavy padding —
  most shards all PAD — and a randomised head: the model's zero head
  would make the logits constant and every comparison vacuous
  (tests/test_long_context.py:10-17).  The carry ring needs a shard of
  at least 8 positions, so n_sp 8 runs at seq 64.
- `make_sp_train_step`'s new params against the reference's, leaf by
  leaf, with a randomised head and a check that the body moved.
- `long_context_sp` at a tiny length on the CPU, and its guard: without
  a card it raises unless the CPU is asked for.

Reference params enter the port through `params_from_jax`; tokens come
from a numpy seed.  Tolerances are the reference's own for its ring
against the single-device model (tests/test_ring_attention.py:134,
:270-275): the two sides run the same float32 arithmetic in another
order.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bflc_demo_tpu.models.transformer import make_transformer_classifier \
    as ref_transformer
from bflc_demo_tpu.parallel.mesh import make_mesh
from bflc_demo_tpu.parallel.ring_attention import SP_AXIS
from bflc_demo_tpu.parallel.ring_attention import \
    make_sp_train_step as ref_sp_train_step
from bflc_demo_tpu.parallel.ring_attention import \
    make_sp_transformer_forward as ref_sp_forward
from bflc_demo_tpu_torch.core.losses import softmax_cross_entropy
from bflc_demo_tpu_torch.eval import long_context
from bflc_demo_tpu_torch.models import make_transformer_classifier
from bflc_demo_tpu_torch.parallel import FoldedAxis
from bflc_demo_tpu_torch.parallel.ring_attention import (
    make_sp_train_step, make_sp_transformer_forward)

SMALL = dict(vocab_size=100, seq_len=32, num_classes=3, dim=32, depth=1,
             heads=2)
LOGITS = dict(rtol=2e-4, atol=2e-5)
STEP = dict(rtol=2e-4, atol=2e-5)


class TestFoldedAxis:
    def test_shard_roll_psum_offsets(self):
        axis = FoldedAxis(3, 2, "cpu")
        tokens = torch.arange(12).reshape(2, 6)
        folded = axis.shard(tokens)
        # row r is shard r // 2, batch row r % 2
        assert folded.tolist() == [[0, 1], [6, 7], [2, 3], [8, 9],
                                   [4, 5], [10, 11]]
        # shard i now holds what shard i-1 held (shard 0: shard 2's)
        assert axis.ppermute(folded).tolist() == [[4, 5], [10, 11], [0, 1],
                                                  [6, 7], [2, 3], [8, 9]]
        per_shard = torch.tensor([[1.], [2.], [10.], [20.], [100.], [200.]])
        assert axis.psum(per_shard).tolist() == [[111.], [222.]]
        assert axis.offsets(2).tolist() == [0, 0, 2, 2, 4, 4]

    def test_bad_shapes_rejected(self):
        axis = FoldedAxis(4, 2, "cpu")
        with pytest.raises(ValueError, match="not divisible by sp axis 4"):
            axis.shard(torch.ones((2, 30), dtype=torch.long))
        with pytest.raises(ValueError, match="batch 3"):
            axis.shard(torch.ones((3, 32), dtype=torch.long))
        model = make_transformer_classifier(**dict(SMALL, seq_len=30))
        with pytest.raises(ValueError, match="seq_len 30 not divisible"):
            make_sp_transformer_forward(axis, model)
        with pytest.raises(ValueError, match="seq_len 30 not divisible"):
            make_sp_train_step(axis, model, lr=0.1)


def _pair(seed, seq_len=32):
    """Reference model (its pallas ring, in interpret mode) and params
    with a randomised head; the port's model and the same params."""
    cfg = dict(SMALL, seq_len=seq_len)
    ref = ref_transformer(attention_impl="pallas_interpret", **cfg)
    params = ref.init_params(seed)
    rng = np.random.default_rng(seed + 17)
    head_w = rng.standard_normal(params["head_w"].shape) * 0.5
    params = dict(params, head_w=jnp.asarray(head_w, jnp.float32),
                  head_b=jnp.linspace(-0.2, 0.2, 3, dtype=jnp.float32))
    port = make_transformer_classifier(**cfg)
    return ref, port, params, port.params_from_jax(params)


def _tokens(seed, b, heavy, s=32):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, 100, (b, s)).astype(np.int32)
    if heavy:           # 6 real tokens in most rows: shards 1.. all PAD
        toks[:, 6:] = 0
        toks[-1, 6:20] = rng.integers(1, 100, 14)
    else:
        for i, n in enumerate(rng.integers(s // 2, s + 1, b)):
            toks[i, n:] = 0
    return toks


@pytest.mark.parametrize("n_sp,seq_len", [(2, 32), (4, 32), (8, 64)])
def test_sp_forward_matches_reference(n_sp, seq_len):
    ref, port, params, flat = _pair(1, seq_len)
    toks = _tokens(2, 3, heavy=True, s=seq_len)
    mesh = make_mesh((n_sp,), (SP_AXIS,))
    want = np.asarray(ref_sp_forward(mesh, ref.config)(params,
                                                       jnp.asarray(toks)))
    fn = make_sp_transformer_forward(FoldedAxis(n_sp, 3, "cpu"), port)
    got = fn(flat, torch.as_tensor(toks).long())
    assert np.ptp(want) > 0.1           # the head carries the features
    np.testing.assert_allclose(got.detach().numpy(), want, **LOGITS)


@pytest.mark.parametrize("n_sp", [2, 4])
def test_sp_forward_equals_dense_forward(n_sp):
    """The port's own oracle, as on the card: the sp logits equal the
    dense model's on the unsharded sequence."""
    _, port, _, flat = _pair(3)
    toks = torch.as_tensor(_tokens(4, 4, heavy=False)).long()
    got = make_sp_transformer_forward(FoldedAxis(n_sp, 4, "cpu"), port)(
        flat, toks)
    want = port.apply(flat, toks)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               **LOGITS)


def test_forward_hooked_without_hooks_is_apply():
    _, port, _, flat = _pair(5)
    toks = torch.as_tensor(_tokens(6, 2, heavy=False)).long()
    assert torch.equal(port.forward_hooked(flat, toks),
                       port.apply(flat, toks))


@pytest.mark.parametrize("n_sp", [2, 4])
def test_sp_train_step_matches_reference(n_sp):
    ref, port, params, flat = _pair(5)
    toks = _tokens(7, 4, heavy=False)
    y = np.eye(3, dtype=np.float32)[np.random.default_rng(8)
                                    .integers(0, 3, 4)]
    mesh = make_mesh((n_sp,), (SP_AXIS,))
    want_p, want_l = ref_sp_train_step(mesh, ref.config, lr=0.1)(
        params, jnp.asarray(toks), jnp.asarray(y))
    want = port.params_from_jax(want_p)
    step = make_sp_train_step(FoldedAxis(n_sp, 4, "cpu"), port, lr=0.1)
    got, loss = step(flat, torch.as_tensor(toks).long(), torch.as_tensor(y))
    np.testing.assert_allclose(float(loss), float(want_l), rtol=2e-5)
    key = "['blocks'][0]['w1']"
    assert float((want[key] - flat[key]).abs().max()) > 1e-6, \
        "vacuous: the body did not move"
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=k, **STEP)


def test_sp_step_equals_dense_step():
    """One sp step on the folded axis equals one dense SGD step."""
    _, port, _, flat = _pair(9)
    toks = torch.as_tensor(_tokens(10, 2, heavy=False)).long()
    y = torch.eye(3)[[0, 2]]
    got, _ = make_sp_train_step(FoldedAxis(4, 2, "cpu"), port, lr=0.1)(
        flat, toks, y)
    work = {k: p.clone().requires_grad_(True) for k, p in flat.items()}
    grads = torch.autograd.grad(
        softmax_cross_entropy(port.apply(work, toks), y), list(work.values()))
    for (k, p), g in zip(flat.items(), grads):
        np.testing.assert_allclose(got[k].numpy(), (p - 0.1 * g).numpy(),
                                   err_msg=k, **STEP)


def test_long_context_sp_on_cpu():
    res = long_context.long_context_sp(seq_len=64, n_sp=4, batch=2, steps=1,
                                       device="cpu")
    assert len(res.losses) == 1 and np.isfinite(res.losses).all()
    assert res.logits.shape == (2, 2) and res.forwards == 2
    assert len(res.params) == 2 and res.peak_mem_bytes is None
    assert set(res.launches.values()) == {0}     # plain versions on the CPU
    dense = res.model.apply(res.params[-1], res.tokens)
    np.testing.assert_allclose(res.logits.numpy(), dense.detach().numpy(),
                               **LOGITS)


def test_long_context_cli_on_cpu(capsys):
    assert long_context.main(["--seq-len", "64", "--n-sp", "2", "--batch",
                              "2", "--steps", "0", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["device"] == "cpu" and out["losses"] == []
    assert np.isfinite(out["logits"]).all()


def test_long_context_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        long_context.long_context_sp(seq_len=64, n_sp=4, batch=2, steps=0)
    with pytest.raises(RuntimeError, match="--device cpu"):
        long_context.main(["--seq-len", "64", "--n-sp", "4"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FoldedAxis(4, 2)
