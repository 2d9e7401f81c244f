"""The port's bit-exact parts against the reference: data, canonical bytes
and hashes, the update store, the protocol config and the ledger chain.

Everything here is held to equality, not a tolerance: these bytes are
what the ledger certifies.
"""

import numpy as np
import pytest
import torch

from bflc_demo_tpu.data import partition as ref_partition
from bflc_demo_tpu.data import synthetic as ref_synthetic
from bflc_demo_tpu.eval import configs as ref_configs
from bflc_demo_tpu.ledger.pyledger import PyLedger as RefLedger
from bflc_demo_tpu.models.transformer import make_transformer_classifier \
    as ref_transformer
from bflc_demo_tpu.protocol.constants import ProtocolConfig as RefConfig
from bflc_demo_tpu.utils import serialization as ref_ser
from bflc_demo_tpu_torch.comm.store import UpdateStore
from bflc_demo_tpu_torch.data import partition, synthetic
from bflc_demo_tpu_torch.eval import configs
from bflc_demo_tpu_torch.ledger import make_ledger
from bflc_demo_tpu_torch.models import (canonical_params, keystr,
                                        make_transformer_classifier)
from bflc_demo_tpu_torch.protocol import ProtocolConfig
from bflc_demo_tpu_torch.utils import serialization as ser


class TestData:
    def test_synthetic_text_and_split_byte_identical(self):
        got = synthetic.synthetic_text_classification(300, 32, 100, 2, 3)
        want = ref_synthetic.synthetic_text_classification(300, 32, 100, 2,
                                                           3)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        for a, b in zip(configs._split(*got), ref_configs._split(*want)):
            assert a.tobytes() == b.tobytes()

    def test_shards_and_one_hot_byte_identical(self):
        x, y = ref_synthetic.synthetic_text_classification(103, 16, 50)
        for (a, b), (c, d) in zip(partition.iid_shards(x, y, 7),
                                  ref_partition.iid_shards(x, y, 7)):
            assert a.tobytes() == c.tobytes() and b.tobytes() == d.tobytes()
        assert partition.one_hot(y, 3).tobytes() == \
            ref_partition.one_hot(y, 3).tobytes()


class TestSerialization:
    def test_hash_of_reference_params_matches(self):
        """The port's hash of the reference's initial params (loaded with
        params_from_jax) equals the reference's hash_pytree."""
        ref_model = ref_transformer(vocab_size=100, seq_len=16,
                                    num_classes=3, dim=16, depth=2,
                                    heads=2, attention_impl="einsum")
        params = ref_model.init_params(0)
        model = make_transformer_classifier(vocab_size=100, seq_len=16,
                                            num_classes=3, dim=16, depth=2,
                                            heads=2)
        flat = model.params_from_jax(params)
        assert ser.canonical_bytes(flat) == ref_ser.canonical_bytes(params)
        assert ser.hash_pytree(flat) == ref_ser.hash_pytree(params)

    def test_module_keys_follow_the_reference_tree(self):
        model = make_transformer_classifier(vocab_size=100, seq_len=16,
                                            dim=16, depth=2, heads=2)
        ref_model = ref_transformer(vocab_size=100, seq_len=16, dim=16,
                                    depth=2, heads=2,
                                    attention_impl="einsum")
        want = {k: v.shape for k, v in
                ref_ser.unpack_pytree(ref_ser.pack_pytree(
                    ref_model.init_params(0))).items()}
        got = {k: tuple(v.shape) for k, v in
               canonical_params(model).items()}
        assert got == want
        assert keystr("blocks.1.ln2.scale") == "['blocks'][1]['ln2']['scale']"

    def test_hash_sees_every_byte(self):
        flat = {"['a']": torch.zeros(3), "['b']": torch.ones(2, 2)}
        h = ser.hash_pytree(flat)
        assert h == ser.hash_pytree(dict(reversed(list(flat.items()))))
        flat["['b']"][1, 1] = float(np.nextafter(np.float32(1),
                                                 np.float32(2)))
        assert ser.hash_pytree(flat) != h
        assert ser.hash_pytree({"['a']": np.zeros(3, np.float32),
                                "['b']": np.ones((2, 2), np.float32)}) == h


class TestStore:
    def test_put_get_and_integrity(self):
        store = UpdateStore()
        tree = {"['w']": torch.arange(6.0).reshape(2, 3)}
        h = store.put(tree)
        assert h == ref_ser.hash_pytree({"w": np.arange(6.0, dtype=np.float32)
                                         .reshape(2, 3)})
        assert store.get(h) is tree
        tree["['w']"][0, 0] = 9.0
        with pytest.raises(ValueError, match="integrity"):
            store.get(h)
        store.drop(h)
        assert len(store) == 0


class TestProtocolConfig:
    @pytest.mark.parametrize("kw", [
        dict(comm_count=0), dict(comm_count=20), dict(aggregate_count=11),
        dict(needed_update_count=17), dict(learning_rate=0.0),
        dict(batch_size=0)])
    def test_same_rejections(self, kw):
        with pytest.raises(ValueError) as want:
            RefConfig(**kw).validate()
        with pytest.raises(ValueError) as got:
            ProtocolConfig(**kw).validate()
        assert str(got.value) == str(want.value)


def _drive(ledger, n=6):
    """One register/upload/score/commit op sequence, with rejected ops
    mixed in; returns every status and committee seen along the way."""
    trace = []
    addrs = [f"0x{i:040x}" for i in range(n)]
    for a in addrs + addrs[:1]:
        trace.append(int(ledger.register_node(a)))
    rng = np.random.default_rng(5)
    for _ in range(2):
        epoch = ledger.epoch
        committee = ledger.committee()
        trainers = [a for a in addrs if a not in committee]
        trace.append(int(ledger.upload_scores(committee[0], epoch, [1.0])))
        for a in trainers:
            h = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
            trace.append(int(ledger.upload_local_update(
                a, h, int(rng.integers(10, 50)), float(rng.random()),
                epoch)))
        trace.append(int(ledger.upload_local_update(
            trainers[0], b"\0" * 32, 5, 0.5, epoch)))          # duplicate
        trace.append(int(ledger.upload_local_update(
            trainers[1], b"\0" * 32, 5, 0.5, epoch + 1)))      # wrong epoch
        k = ledger.update_count
        trace.append(int(ledger.upload_scores(trainers[0], epoch,
                                              [0.5] * k)))     # not comm
        for c in committee:
            trace.append(int(ledger.upload_scores(
                c, epoch, [float(s) for s in rng.random(k)])))
        pending = ledger.pending()
        trace.append((list(pending.order), list(pending.selected),
                      pending.global_loss))
        trace.append(int(ledger.commit_model(bytes(range(32)), epoch)))
        trace.append((ledger.epoch, ledger.committee(),
                      ledger.last_global_loss))
    return trace


class TestLedger:
    def test_same_ops_same_chain_head(self):
        cfg = ProtocolConfig(client_num=6, comm_count=2, aggregate_count=2,
                             needed_update_count=3)
        port = make_ledger(cfg)
        ref = RefLedger(6, 2, 2, 3)
        assert _drive(port) == _drive(ref)
        assert port.log_size() == ref.log_size()
        assert port.log_head() == ref.log_head()
        assert [port.log_op(i) for i in range(port.log_size())] == \
            [ref.log_op(i) for i in range(ref.log_size())]
        assert port.verify_log()

    def test_tampered_log_fails_verification(self):
        # the python ledger's op list (the native one's is behind its ABI)
        ledger = make_ledger(ProtocolConfig(client_num=3, comm_count=1,
                                            aggregate_count=1,
                                            needed_update_count=2),
                             backend="python")
        for i in range(3):
            ledger.register_node(f"n{i}")
        assert ledger.verify_log()
        ledger._ops[1] = ledger._ops[1] + b"x"
        assert not ledger.verify_log()

    def test_invalid_genome_rejected_at_construction(self):
        with pytest.raises(ValueError, match="comm_count"):
            make_ledger(ProtocolConfig(client_num=4, comm_count=4))
        assert make_ledger().epoch == ProtocolConfig().genesis_epoch
