"""The port's MLP, LeNet-5, FEMNIST CNN and ResNet against the JAX package's.

Small shapes, numpy-seeded inputs through both packages:
- `init_params(seed)`: the reference's keys and shapes, values within 4
  float32 ulp (`utils/flax_init.py` redraws flax's per-parameter keys;
  the truncated normal's `erfinv` and numpy's `log1p` against XLA:CPU's
  leave a few ulp, as for `prng.normal`);
- `apply` on the reference's params: within rtol 1e-5, atol 1e-5 (float32
  convolutions and products summed in other orders);
- one `local_train` step's delta: within rtol 1e-4 and an atol of 1e-4 of
  the delta's largest entry (the gradient divided by lr, through the
  same float32 steps in other orders);
- `apply_stacked` of G = 3 models against three `apply` calls: on the
  CPU the same, bit for bit; the conv models' vmapped pass (the card's
  route, `apply_vmapped`) within 1e-6 of the logits' scale (the vmapped
  conv is one grouped conv; at the ResNet, whose nine GroupNorms
  rescale each layer's rounding, 5e-6);
- the content hash and B6's plain fingerprint of `params_from_jax(tree)`:
  the reference's bytes;
- flax's SAME padding, at stride 2 on an even and an odd width (a
  ResNet at width 9 against the reference's);
- ResNet-18 at CIFAR-100's shapes: 62 leaves, 11,220,132 parameters, and
  `ops.fingerprint.leaf_order` gives `jax.tree_util.tree_leaves` order;
- `prng.erf` equal to XLA's for |x| < 3 and `truncated_normal` within 4
  ulp of jax's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bflc_demo_tpu import models as ref_models
from bflc_demo_tpu.core.local_train import local_train as ref_local_train
from bflc_demo_tpu.models import resnet as ref_resnet
from bflc_demo_tpu.ops import fingerprint as ref_fp
from bflc_demo_tpu.utils.serialization import hash_pytree as ref_hash
from bflc_demo_tpu_torch import models
from bflc_demo_tpu_torch.core import local_train
from bflc_demo_tpu_torch.data.partition import one_hot
from bflc_demo_tpu_torch.models.layers import same_pads
from bflc_demo_tpu_torch.ops import fingerprint as fp
from bflc_demo_tpu_torch.utils import prng
from bflc_demo_tpu_torch.utils.serialization import hash_pytree

ULP = 4
LR = 0.05
# name -> (port model, reference model, input shape)
ZOO = {
    "mlp": (lambda: models.make_mlp((16, 16, 3), 32, 4),
            lambda: ref_models.make_mlp((16, 16, 3), 32, 4), (16, 16, 3)),
    "lenet5": (lambda: models.make_lenet5((16, 16, 3), 4),
               lambda: ref_models.make_lenet5((16, 16, 3), 4), (16, 16, 3)),
    "femnist_cnn": (lambda: models.make_femnist_cnn((16, 16, 1), 6),
                    lambda: ref_models.make_femnist_cnn((16, 16, 1), 6),
                    (16, 16, 1)),
    "resnet": (lambda: models.make_resnet18((8, 8, 3), 4, (1, 1, 1, 1)),
               lambda: _ref_resnet((8, 8, 3)), (8, 8, 3)),
}
STACKED_TOL = {"resnet": 5e-6}


@pytest.fixture(autouse=True, scope="module")
def _share_of_the_cores():
    """The CPU path on this worker's share of the cores: the suite may run
    files in parallel workers (pytest-xdist), and small convolutions
    split over every core in every worker spend their time in thread
    barriers."""
    threads = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(threads)


def _ref_resnet(shape):
    """The reference's ResNet at stage sizes (1, 1, 1, 1), 4 classes."""
    module = ref_resnet._ResNet18(num_classes=4, stage_sizes=(1, 1, 1, 1))

    def init(rng):
        return module.init(rng, jnp.zeros((1,) + shape, jnp.float32))[
            "params"]
    return ref_models.Model(name="resnet", init=init,
                            apply=lambda p, x: module.apply({"params": p}, x),
                            input_shape=shape, num_classes=4)


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _ulp(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


@pytest.fixture(scope="module")
def ref_outputs():
    """Each model's reference init, logits and one-step delta, once."""
    out = {}
    for name, (_, make_ref, shape) in ZOO.items():
        ref = make_ref()
        rng = np.random.default_rng(len(name))
        x = rng.random((8,) + shape).astype(np.float32)
        y = one_hot(rng.integers(0, ref.num_classes, 8), ref.num_classes)
        params = ref.init_params(1)
        delta, cost = ref_local_train(ref.apply, params, jnp.asarray(x),
                                      jnp.asarray(y), lr=LR, batch_size=8)
        out[name] = dict(params=params, x=x, y=y,
                         logits=np.asarray(ref.apply(params, jnp.asarray(x))),
                         delta=_flat(delta), cost=float(cost),
                         init2=_flat(ref.init_params(2)))
    return out


@pytest.mark.parametrize("name", list(ZOO))
def test_init_params_match_reference(name, ref_outputs):
    model = ZOO[name][0]()
    want = ref_outputs[name]["init2"]
    got = model.init_params(2)
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert _ulp(got[k].numpy(), v) <= ULP, k


@pytest.mark.parametrize("name", list(ZOO))
def test_apply_matches_reference(name, ref_outputs):
    ref = ref_outputs[name]
    model = ZOO[name][0]()
    params = model.params_from_jax(ref["params"])
    got = model.apply(params, torch.as_tensor(ref["x"])).detach().numpy()
    np.testing.assert_allclose(got, ref["logits"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(ZOO))
def test_one_step_delta_matches_reference(name, ref_outputs):
    ref = ref_outputs[name]
    model = ZOO[name][0]()
    params = model.params_from_jax(ref["params"])
    delta, cost = local_train(model, params, torch.as_tensor(ref["x"]),
                              torch.as_tensor(ref["y"]), lr=LR, batch_size=8)
    assert abs(float(cost) - ref["cost"]) <= 1e-5 * max(1.0, ref["cost"])
    for k, want in ref["delta"].items():
        np.testing.assert_allclose(
            delta[k].numpy(), want, rtol=1e-4,
            atol=1e-4 * max(float(np.abs(want).max()), 1e-6), err_msg=k)


@pytest.mark.parametrize("name", list(ZOO))
def test_apply_stacked_equals_separate_applies(name, ref_outputs):
    ref = ref_outputs[name]
    model = ZOO[name][0]()
    params = model.params_from_jax(ref["params"])
    scales = (1.0, 1.01, 0.99)
    stacked = {k: torch.stack([v * s for s in scales])
               for k, v in params.items()}
    x = torch.as_tensor(ref["x"])
    xs = torch.stack([x, x * 0.5, x.flip(0)])
    with torch.no_grad():
        got = model.apply_stacked(stacked, xs)
        want = torch.stack([model.apply({k: v[i] for k, v in stacked.items()},
                                        xs[i]) for i in range(3)])
        vmapped = (model.apply_vmapped(stacked, xs)
                   if hasattr(model, "apply_vmapped") else got)
    tol = STACKED_TOL.get(name, 1e-6) * max(1.0, float(want.abs().max()))
    assert got.shape == vmapped.shape == want.shape
    assert torch.equal(got, want)
    assert float((vmapped - want).abs().max()) <= tol


@pytest.mark.parametrize("name", list(ZOO))
def test_hash_and_fingerprint_equal_reference(name, ref_outputs):
    tree = jax.tree_util.tree_map(np.asarray, ref_outputs[name]["params"])
    params = ZOO[name][0]().params_from_jax(tree)
    assert hash_pytree(params) == ref_hash(tree)
    got = fp.fingerprint_pytree(params).numpy()
    want = np.asarray(ref_fp.fingerprint_pytree(
        jax.tree_util.tree_map(jnp.asarray, tree)))
    np.testing.assert_array_equal(got, want)


def test_odd_width_resnet_matches_reference():
    """At width 9 the stride-2 3x3 convs pad (1, 1), then (0, 1) on 5,
    then (1, 1) on 3: flax's SAME rule at both parities."""
    ref = _ref_resnet((9, 9, 3))
    params = ref.init_params(3)
    x = np.random.default_rng(9).random((4, 9, 9, 3)).astype(np.float32)
    model = models.make_resnet18((9, 9, 3), 4, (1, 1, 1, 1))
    got = model.apply(model.params_from_jax(params), torch.as_tensor(x))
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(ref.apply(params, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    assert _ulp(model.init_params(3)["['Dense_0']['kernel']"].numpy(),
                np.asarray(params["Dense_0"]["kernel"])) <= ULP


@pytest.mark.parametrize("size,k,stride,pads", [
    (32, 3, 2, (0, 1)), (9, 3, 2, (1, 1)), (32, 1, 2, (0, 0)),
    (16, 5, 1, (2, 2)), (7, 3, 1, (1, 1)), (5, 4, 1, (1, 2))])
def test_same_padding_is_flax(size, k, stride, pads):
    assert same_pads(size, k, stride) == pads
    want = jax.lax.padtype_to_pads((size,), (k,), (stride,), "SAME")
    assert tuple(want[0]) == pads


def test_resnet18_tree_and_leaf_order():
    """CIFAR-100's ResNet-18: the reference's 62 leaves (counted with
    `jax.eval_shape`, no draw), keys, shapes, 11,220,132 parameters, and
    B6's leaf order equal to `tree_leaves` order."""
    shapes = jax.eval_shape(ref_models.make_resnet18().init_params, 0)
    want = [(jax.tree_util.keystr(p), tuple(v.shape)) for p, v in
            jax.tree_util.tree_flatten_with_path(shapes)[0]]
    model = models.make_resnet18()
    got = {k: tuple(v.shape) for k, v in
           models.canonical_params(model).items()}
    assert len(want) == 62 and dict(want) == got
    assert sum(int(np.prod(s)) for s in got.values()) == 11_220_132
    assert fp.leaf_order(list(got)) == [k for k, _ in want]


def test_registry_and_float32_only():
    assert set(models.REGISTRY) == set(ref_models.REGISTRY)
    assert isinstance(models.REGISTRY["lenet5"](), models.LeNet5)
    # the bfloat16 knob is ported (tests/test_torch_bf16.py); another
    # dtype still raises
    assert models.make_resnet18(dtype="bfloat16").dtype == torch.bfloat16
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        models.make_resnet18(dtype="float16")


def test_erf_and_truncated_normal_match_jax():
    x = np.random.default_rng(3).uniform(-3, 3, 20000).astype(np.float32)
    x = np.concatenate([x, np.float32([2 / np.sqrt(np.float32(2)), 0.0])])
    x = np.concatenate([x, -x])
    np.testing.assert_array_equal(prng.erf(x).view(np.uint32),
                                  np.asarray(jax.lax.erf(jnp.asarray(x)))
                                  .view(np.uint32))
    for seed in (0, 7):
        got = prng.truncated_normal(prng.PRNGKey(seed), -2.0, 2.0, (64, 33))
        want = np.asarray(jax.random.truncated_normal(
            jax.random.PRNGKey(seed), -2.0, 2.0, (64, 33)))
        assert _ulp(got, want) <= ULP
        assert got.min() > -2.0 and got.max() < 2.0
