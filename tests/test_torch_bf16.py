"""The `dtype=bfloat16` knob: the port's models, blobs and fingerprints
against the reference's.

Bit for bit: the bfloat16 MLP's initial model (jax's bfloat16 normal
draw, `utils/prng.normal(..., "bfloat16")`), its canonical blob and
content hash (the dtype string "bfloat16", 2 bytes an element) with and
without ml_dtypes, its payload fingerprint and the stacked deltas', and
the float32 row a bfloat16 delta becomes before the certified merge.

Within a stated bfloat16 tolerance (the two packages round different
orders of bfloat16 products and sums): logits within 2e-2 x max(1,
max|reference|) (the card check's bfloat16 bound; 1.7e-2 of 3.8
measured for the transformer, 1.4e-3 for LeNet-5); one local step's
delta within `STEP_L2` relative L2 of the reference's (the MLP 0.0064,
the transformer 0.012-0.018, LeNet-5 0.060 measured: a conv's
bias gradient sums thousands of bfloat16 products) and its cost, the
mean loss over two steps, within 2e-2 relative (9.4e-3 measured for
ResNet-18, whose second step starts from the first's bfloat16 model).
The reference runs its einsum path and, for the transformer,
`pallas_interpret` as its own tests run it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bflc_demo_tpu.core.local_train import local_train as ref_local_train
from bflc_demo_tpu.meshagg import engine as ref_engine
from bflc_demo_tpu.meshagg import spec as ref_spec
from bflc_demo_tpu.models import cnn as ref_cnn
from bflc_demo_tpu.models import make_mlp as ref_mlp
from bflc_demo_tpu.models import resnet as ref_resnet
from bflc_demo_tpu.models.base import Model as RefModel
from bflc_demo_tpu.models.transformer import make_transformer_classifier \
    as ref_transformer
from bflc_demo_tpu.ops import fingerprint as ref_fp
from bflc_demo_tpu.utils import serialization as ref_ser
from bflc_demo_tpu_torch import models
from bflc_demo_tpu_torch.client.mesh_runtime import run_federated_mesh
from bflc_demo_tpu_torch.core.local_train import local_train
from bflc_demo_tpu_torch.data import iid_shards
from bflc_demo_tpu_torch.meshagg import engine, spec
from bflc_demo_tpu_torch.ops import fingerprint as fp
from bflc_demo_tpu_torch.protocol import ProtocolConfig
from bflc_demo_tpu_torch.utils import codecs
from bflc_demo_tpu_torch.utils import serialization as ser

LOGIT_TOL = 2e-2             # x max(1, max|reference logits|)
STEP_L2 = {"mlp": 2e-2, "lenet5": 0.15, "femnist": 0.15, "resnet": 0.15,
           "transformer": 5e-2, "transformer_pallas": 5e-2}
COST_RTOL = 2e-2
LR = 0.05
TEXT = dict(vocab_size=100, seq_len=16, num_classes=2, dim=32, depth=2,
            heads=2)


def _flax(module, shape, classes):
    def init(rng):
        return module.init(rng, jnp.zeros((1,) + shape, jnp.float32))[
            "params"]
    return RefModel(name="m", init=init,
                    apply=lambda p, x: module.apply({"params": p}, x),
                    input_shape=shape, num_classes=classes)


bf = jnp.bfloat16
# name: (port model, reference model, input shape or None for tokens)
ZOO = {
    "mlp": (lambda: models.make_mlp(dtype=torch.bfloat16),
            lambda: ref_mlp(dtype=bf), (28, 28, 1)),
    "lenet5": (lambda: models.make_lenet5(dtype="bfloat16"),
               lambda: _flax(ref_cnn._LeNet5(num_classes=10, dtype=bf),
                             (32, 32, 3), 10), (32, 32, 3)),
    "femnist": (lambda: models.make_femnist_cnn((12, 12, 1), 6,
                                                dtype="bfloat16"),
                lambda: _flax(ref_cnn._FemnistCNN(num_classes=6, dtype=bf),
                              (12, 12, 1), 6), (12, 12, 1)),
    "resnet": (lambda: models.make_resnet18((8, 8, 3), 4, (1, 1, 1, 1),
                                            dtype=torch.bfloat16),
               lambda: _flax(ref_resnet._ResNet18(
                   num_classes=4, stage_sizes=(1, 1, 1, 1), dtype=bf),
                   (8, 8, 3), 4), (8, 8, 3)),
    "transformer": (lambda: models.make_transformer_classifier(
        dtype=torch.bfloat16, **TEXT),
        lambda: ref_transformer(dtype=bf, attention_impl="einsum", **TEXT),
        None),
    "transformer_pallas": (lambda: models.make_transformer_classifier(
        dtype=torch.bfloat16, **TEXT),
        lambda: ref_transformer(dtype=bf, attention_impl="pallas_interpret",
                                **TEXT), None),
}


def _inputs(name, shape, n=16):
    rng = np.random.default_rng(len(name))
    if shape is None:
        x = rng.integers(1, 100, (n, 16)).astype(np.int32)
        for i, length in enumerate(rng.integers(8, 17, n)):
            x[i, length:] = 0
        tx = torch.as_tensor(x).long()
        classes = 2
    else:
        x = rng.standard_normal((n,) + shape).astype(np.float32)
        tx = torch.as_tensor(x)
        classes = {"mlp": 10, "lenet5": 10, "femnist": 6, "resnet": 4}[name]
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]
    return x, tx, y


def _pair(name):
    make_port, make_ref, shape = ZOO[name]
    port, ref = make_port(), make_ref()
    params = ref.init_params(0)
    if shape is None:
        # a non-zero head, so the logits carry the whole network
        head = np.random.default_rng(1).standard_normal(
            params["head_w"].shape).astype(np.float32)
        params = dict(params, head_w=jnp.asarray(head))
    return port, ref, params, port.params_from_jax(params), shape


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a).astype(np.float32)


@pytest.mark.parametrize("name", list(ZOO))
def test_bf16_logits_match_reference(name):
    port, ref, params, flat, shape = _pair(name)
    x, tx, _ = _inputs(name, shape)
    want = _f32(jax.jit(ref.apply)(params, jnp.asarray(x)))
    got = _f32(port.apply(flat, tx))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL * max(
        1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("name", list(ZOO))
def test_bf16_local_step_matches_reference(name):
    port, ref, params, flat, shape = _pair(name)
    x, tx, y = _inputs(name, shape)
    want, want_cost = ref_local_train(ref.apply, params, jnp.asarray(x),
                                      jnp.asarray(y), lr=LR, batch_size=8)
    want = ref_ser.unpack_pytree(ref_ser.pack_pytree(want))
    got, cost = local_train(port, flat, tx, torch.as_tensor(y), LR, 8)
    assert set(got) == set(want)
    for k, v in got.items():
        # a bfloat16 model's delta stays bfloat16, a float32 one's float32
        assert str(v.dtype).replace("torch.", "") == want[k].dtype.name, k
    num = sum(float(((_f32(got[k]) - _f32(want[k])) ** 2).sum())
              for k in got)
    den = sum(float((_f32(want[k]) ** 2).sum()) for k in got)
    assert (num / den) ** 0.5 <= STEP_L2[name]
    np.testing.assert_allclose(float(cost), float(want_cost),
                               rtol=COST_RTOL)


def test_bf16_mlp_init_blob_hash_and_fingerprint_bit_for_bit():
    ref = ref_mlp(dtype=bf)
    port = models.make_mlp(dtype=torch.bfloat16)
    want = ref.init_params(3)
    got = port.init_params(3)
    assert all(v.dtype == torch.bfloat16 for v in got.values())
    blob = ser.pack_pytree(got)
    assert blob == ref_ser.pack_pytree(want)
    assert b"bfloat16" in blob
    assert ser.hash_pytree(got) == ref_ser.hash_pytree(want)
    assert fp.fingerprint_to_bytes(fp.fingerprint_pytree(got)) == \
        ref_fp.fingerprint_to_bytes(ref_fp.fingerprint_pytree(want))
    # the blob unpacks to the same bits in both packages and restores
    # to the same tensors
    flat = ser.unpack_pytree(blob)
    ref_flat = ref_ser.unpack_pytree(blob)
    for k, v in flat.items():
        assert codecs.is_bf16(v.dtype)
        np.testing.assert_array_equal(v.view(np.uint16),
                                      ref_flat[k].view(np.uint16))
    back = ser.restore_pytree(got, flat)
    assert all(torch.equal(back[k], got[k]) for k in got)


def test_bf16_blob_without_ml_dtypes(monkeypatch):
    """The port needs no ml_dtypes: with its 2-byte record standing in
    for numpy's bfloat16 the blob's bytes, the rows and the rounding
    are the same."""
    port = models.make_mlp((4, 4, 1), 8, 3, dtype=torch.bfloat16)
    params = port.init_params(1)
    want = ser.pack_pytree(params)
    record = np.dtype([("bfloat16", "<u2")])
    monkeypatch.setattr(codecs, "BF16", record)
    assert ser.pack_pytree(params) == want
    flat = ser.unpack_pytree(want)
    assert all(v.dtype == record for v in flat.values())
    assert ser.pack_pytree(flat) == want
    back = ser.restore_pytree(params, flat)
    assert all(torch.equal(back[k], params[k]) for k in params)
    w1 = np.asarray(params["['W1']"].float().numpy())
    np.testing.assert_array_equal(codecs.as_float32(flat["['W1']"]), w1)
    halves = np.float32([1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, -0.0, 3e38])
    np.testing.assert_array_equal(
        codecs.as_float32(codecs.cast_like(halves, record)),
        np.asarray(torch.as_tensor(halves).bfloat16().float()))


@pytest.mark.parametrize("form", ["ml_dtypes", "record"])
def test_c21_nan_payloads_cast_as_the_reference(form, monkeypatch):
    """C21: the certified merge's step casts a NaN to bfloat16 as
    numpy's ml_dtypes cast does, 0x7FC0 / 0xFFC0 with its sign and no
    payload, in both `BF16` forms; a bfloat16 global leaf holding a
    payload NaN (0x7F81, 0xFF81, 0x7FC1) and a float32 accumulator NaN
    (0x7F810000) commit the reference's bytes."""
    import ml_dtypes
    dtype = codecs.BF16 if form == "ml_dtypes" else np.dtype(
        [("bfloat16", "<u2")])
    monkeypatch.setattr(codecs, "BF16", dtype)
    bits = np.array([0x7F81, 0xFF81, 0x7FC1, 0x3F80, 0xBF80, 0x0001],
                    np.uint16)
    acc = np.array([0.5, 0.25, 0.0, 0x7F810000, 1.0, 0.0], np.float32)
    acc[3] = np.array([0x7F810000], np.uint32).view(np.float32)[0]
    want = ref_spec.apply_step({"w": bits.view(ml_dtypes.bfloat16)},
                               {"w": acc}, 0.05)["w"]
    got = spec.apply_step({"w": bits.view(dtype)}, {"w": acc}, 0.05)["w"]
    assert codecs.is_bf16(got.dtype)
    np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))
    assert [hex(b) for b in got.view(np.uint16)[:4]] == \
        ["0x7fc0", "0xffc0", "0x7fc0", "0x7fc0"]


def test_bf16_stacked_fingerprints_match_reference():
    port = models.make_mlp((6, 6, 1), 16, 4, dtype=torch.bfloat16)
    rng = np.random.default_rng(4)
    stacked = {k: torch.as_tensor(rng.standard_normal(
        (5,) + tuple(v.shape)).astype(np.float32)).bfloat16()
        for k, v in port.init_params(0).items()}
    tree = {k[2:-2]: jnp.asarray(v.float().numpy(), jnp.bfloat16)
            for k, v in stacked.items()}
    want = np.asarray(jax.jit(ref_fp.fingerprint_stacked)(tree))
    got = fp.fingerprint_stacked(stacked).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, want)


def test_bf16_delta_becomes_the_reference_f32_row():
    port = models.make_mlp((6, 6, 1), 16, 4, dtype=torch.bfloat16)
    rng = np.random.default_rng(5)
    delta = {k: torch.as_tensor(rng.standard_normal(tuple(v.shape))
                                .astype(np.float32)).bfloat16()
             for k, v in port.init_params(0).items()}
    flat = ser.unpack_pytree(ser.pack_pytree(delta))
    keys = sorted(flat)
    want = ref_engine.flatten_delta(ref_ser.unpack_pytree(
        ser.pack_pytree(delta)), keys)
    got = engine.flatten_delta(flat, keys)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # the writer's merge keeps a bfloat16 model bfloat16
    merged = engine.engine_for("cpu").aggregate_rows(
        flat, [got, got * 2], [3.0, 1.0], [0, 1], 0.05, force_leg="host")
    assert all(codecs.is_bf16(v.dtype) for v in merged.values())


def test_bf16_mesh_runs_keep_bfloat16_models():
    cfg = ProtocolConfig(client_num=6, comm_count=2, aggregate_count=2,
                         needed_update_count=3, learning_rate=0.05,
                         batch_size=8)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((240, 6, 6, 1)).astype(np.float32)
    y = (x.reshape(240, -1).sum(1) > 0).astype(np.int64)
    mlp = models.make_mlp((6, 6, 1), 16, 2, dtype=torch.bfloat16)
    res = run_federated_mesh(mlp, iid_shards(x, y, 6), (x, y), cfg,
                             rounds=2, device="cpu")
    assert res.rounds_completed == 2 and res.ledger.verify_log()
    assert all(v.dtype == torch.bfloat16 for v in res.final_params.values())
    toks = rng.integers(1, 100, (240, 16))
    tf = models.make_transformer_classifier(dtype=torch.bfloat16, **TEXT)
    res = run_federated_mesh(tf, iid_shards(toks, y, 6), (toks, y), cfg,
                             rounds=1, device="cpu")
    assert res.rounds_completed == 1
    # the transformer's params stay float32; it computes in bfloat16
    assert all(v.dtype == torch.float32 for v in res.final_params.values())
    assert np.isfinite(res.best_accuracy())


@pytest.mark.parametrize("make", [models.make_mlp, models.make_lenet5,
                                  models.make_femnist_cnn,
                                  models.make_resnet18,
                                  models.make_transformer_classifier])
def test_dtype_knob_takes_float32_and_bfloat16_only(make):
    for dtype in ("float32", "bfloat16", torch.float32, torch.bfloat16):
        make(dtype=dtype)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        make(dtype=torch.float16)
