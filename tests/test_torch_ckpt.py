"""The port's checkpoint and work queue on the CPU: the checkpoint and
`WorkQueue` cases of the reference's tests/test_ckpt_ft.py, a bfloat16
leaf, and trees saved by one framework and restored by the other, with the
same leaf names and values."""
import os

import numpy as np
import pytest
import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.data.queue import SettableClock as FakeClock
from repro_torch.data.queue import WorkQueue


def _tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"w": torch.ones(5, dtype=torch.bfloat16),
                  "codes": (torch.arange(6, dtype=torch.int8),)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _flat(tree):
    return dict(ckpt._leaves(tree))


def test_ckpt_roundtrip(tmp_path):
    tree = _tree()
    ckpt.save(tmp_path, 3, tree, meta={"cursor": 42})
    restored, meta = ckpt.restore(tmp_path, 3, like=tree)
    assert meta["cursor"] == 42
    assert isinstance(restored["b"]["codes"], tuple)
    want, got = _flat(tree), _flat(restored)
    assert list(got) == list(want) == ["a", "b/codes/0", "b/w", "step"]
    for name in want:
        assert got[name].dtype == want[name].dtype
        assert torch.equal(got[name], want[name]), name


def test_ckpt_async_and_latest_and_prune(tmp_path):
    tree = _tree()
    h = ckpt.save(tmp_path, 1, tree, async_save=True)
    h.wait()
    ckpt.save(tmp_path, 5, tree)
    ckpt.save(tmp_path, 9, tree)
    assert ckpt.latest_step(tmp_path) == 9
    ckpt.prune_old(tmp_path, keep=2)
    assert ckpt.latest_step(tmp_path) == 9
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path, 1, like=tree)


def test_ckpt_async_save_takes_a_copy(tmp_path):
    """An in-place update right after an asynchronous save does not reach
    the checkpoint."""
    tree = {"x": torch.zeros(1000)}
    h = ckpt.save(tmp_path, 1, tree, async_save=True)
    tree["x"].add_(1.0)
    h.wait()
    got, _ = ckpt.restore(tmp_path, 1)
    assert not got["x"].any()


def test_ckpt_corruption_detected(tmp_path):
    tree = _tree()
    ckpt.save(tmp_path, 2, tree)
    target = os.path.join(tmp_path, "step_2", "a.npy")
    raw = bytearray(open(target, "rb").read())
    raw[-1] ^= 0xFF
    open(target, "wb").write(bytes(raw))
    with pytest.raises(IOError, match="crc"):
        ckpt.restore(tmp_path, 2, like=tree)


def test_ckpt_restore_structure_mismatch(tmp_path):
    ckpt.save(tmp_path, 1, {"x": torch.ones(3)})
    with pytest.raises(KeyError):
        ckpt.restore(tmp_path, 1, like={"y": torch.ones(3)})


def test_ckpt_bfloat16_leaf_is_stored_as_uint16(tmp_path):
    w = torch.tensor([1.5, -2.25, 3.0e-3, 65504.0], dtype=torch.bfloat16)
    ckpt.save(tmp_path, 1, {"w": w})
    stored = np.load(os.path.join(tmp_path, "step_1", "w.npy"))
    assert stored.dtype == np.uint16
    np.testing.assert_array_equal(stored, w.view(torch.int16).numpy()
                                  .view(np.uint16))
    flat, _ = ckpt.restore(tmp_path, 1)
    assert flat["w"].dtype == torch.bfloat16 and torch.equal(flat["w"], w)


def test_ckpt_restore_places_leaves_like_their_counterparts(tmp_path):
    tree = {"t": torch.arange(4.0), "n": np.arange(3, dtype=np.int64)}
    ckpt.save(tmp_path, 1, tree)
    got, _ = ckpt.restore(tmp_path, 1, like=tree)
    assert torch.is_tensor(got["t"]) and got["t"].device.type == "cpu"
    assert isinstance(got["n"], np.ndarray)
    np.testing.assert_array_equal(got["n"], tree["n"])


def _nested_np():
    rng = np.random.RandomState(4)
    return {"layers": [{"w": rng.randn(3, 2).astype(np.float32),
                        "b": rng.randn(2).astype(np.float32)},
                       {"w": rng.randn(2, 2).astype(np.float32)}],
            "opt": {"count": np.int32(12), "mask": np.array([True, False])}}


def test_port_checkpoint_restored_by_the_reference(tmp_path):
    from repro.ckpt import checkpoint as ref_ckpt
    tree = _nested_np()
    port_tree = {"layers": [{k: torch.from_numpy(v) for k, v in d.items()}
                            for d in tree["layers"]],
                 "opt": {"count": torch.tensor(12, dtype=torch.int32),
                         "mask": torch.from_numpy(tree["opt"]["mask"])},
                 "bf": torch.tensor([0.5, 7.0], dtype=torch.bfloat16)}
    ckpt.save(tmp_path, 4, port_tree, meta={"cursor": [1, 2]})
    flat, meta = ref_ckpt.restore(tmp_path, 4, like=None)
    assert meta == {"cursor": [1, 2]}
    want = _flat(port_tree)
    assert sorted(flat) == sorted(want) == [
        "bf", "layers/0/b", "layers/0/w", "layers/1/w", "opt/count",
        "opt/mask"]
    assert sorted(os.listdir(os.path.join(tmp_path, "step_4"))) == sorted(
        [n.replace("/", "__") + ".npy" for n in want] + ["manifest.json"])
    for name, t in want.items():
        got = np.asarray(flat[name])
        assert str(flat[name].dtype) == str(t.dtype).replace("torch.", "")
        np.testing.assert_array_equal(got.astype(np.float64),
                                      t.double().numpy(), name)


def test_reference_checkpoint_restored_by_the_port(tmp_path):
    import jax.numpy as jnp

    from repro.ckpt import checkpoint as ref_ckpt
    tree = _nested_np()
    ref_tree = {**tree, "bf": jnp.asarray([0.5, 7.0], jnp.bfloat16)}
    ref_ckpt.save(tmp_path, 2, ref_tree, meta={"cursor": 9})
    flat, meta = ckpt.restore(tmp_path, 2)
    assert meta == {"cursor": 9}
    want = dict(ckpt._leaves(tree))
    assert sorted(flat) == sorted([*want, "bf"])
    for name, v in want.items():
        np.testing.assert_array_equal(flat[name].numpy(), v, name)
    assert flat["bf"].dtype == torch.bfloat16
    assert flat["bf"].tolist() == [0.5, 7.0]
    like = {**tree, "bf": torch.zeros(2, dtype=torch.bfloat16)}
    got, _ = ckpt.restore(tmp_path, 2, like=like)
    np.testing.assert_array_equal(got["layers"][1]["w"],
                                  tree["layers"][1]["w"])
    assert torch.equal(got["bf"], flat["bf"])


# ------------------------------------------------------------------ queue

def test_work_queue_lease_complete_expire():
    clock = FakeClock()
    q = WorkQueue(10, lease_timeout_s=5.0, clock=clock)
    assert q.lease("w1", max_items=3) == [0, 1, 2]
    q.complete([0, 1])
    clock.t = 10.0
    ids2 = q.lease("w2", max_items=10)
    assert 2 in ids2
    assert q.redeliveries == 1
    q.complete(ids2)
    assert q.finished


def test_work_queue_fail_worker_and_resume():
    clock = FakeClock()
    q = WorkQueue(6, clock=clock)
    q.lease("w1", 2)
    q.lease("w2", 2)
    q.complete([2, 3])
    assert sorted(q.fail_worker("w1")) == [0, 1]
    q2 = WorkQueue.from_state(q.state(), clock=clock)
    remaining = []
    while True:
        got = q2.lease("w3", 2)
        if not got:
            break
        remaining.extend(got)
    assert sorted(remaining) == [0, 1, 4, 5]


def test_work_queue_late_complete_not_redelivered():
    clock = FakeClock()
    q = WorkQueue(2, lease_timeout_s=5.0, clock=clock)
    assert q.lease("w1", 1) == [0]
    clock.t = 10.0
    q.state()
    assert q.redeliveries == 1
    assert q.complete([0]) == [0]
    assert q.lease("w2", 2) == [1]
    assert q.complete([1]) == [1]
    assert q.complete([1]) == []
    assert q.finished


def test_work_queue_state_roundtrip_with_outstanding_leases():
    clock = FakeClock()
    q = WorkQueue(8, lease_timeout_s=30.0, clock=clock)
    assert q.lease("w1", 3) == [0, 1, 2]
    q.complete([0])
    assert q.lease("w2", 2) == [3, 4]
    q.complete([3])
    state = q.state()
    assert state["done"] == [0, 3]
    assert state["leased"] == [1, 2, 4]
    q2 = WorkQueue.from_state(state, lease_timeout_s=30.0, clock=FakeClock())
    got = []
    while True:
        ids = q2.lease("w3", 3)
        if not ids:
            break
        got.extend(ids)
    assert sorted(got) == [1, 2, 4, 5, 6, 7]
    q2.complete(got)
    assert q2.finished


def test_work_queue_state_reaps_expired_before_snapshot():
    clock = FakeClock()
    q = WorkQueue(3, lease_timeout_s=5.0, clock=clock)
    q.lease("w1", 1)
    clock.t = 6.0
    q.lease("w2", 1)
    state = q.state()
    assert state["done"] == []
    assert len(state["leased"]) == 1
    assert q.redeliveries == 1
    q2 = WorkQueue.from_state(state, clock=FakeClock())
    assert sorted(q2.lease("w3", 10)) == [0, 1, 2]


def test_work_queue_fail_worker_without_leases_keeps_ledger_clean():
    q = WorkQueue(4, clock=FakeClock())
    assert q.fail_worker("idle") == []
    assert "idle" not in q.redelivered_from
    q.lease("w1", 2)
    assert sorted(q.fail_worker("w1")) == [0, 1]
    assert q.redelivered_from == {"w1": 2}
    assert q.fail_worker("w1") == []
    assert q.redelivered_from == {"w1": 2}
    assert q.redeliveries == 2


def test_work_queue_speculation_first_completion_wins():
    clock = FakeClock()
    q = WorkQueue(2, lease_timeout_s=5.0, clock=clock)
    lost = []
    q.on_redeliver = lambda wid, worker, why: lost.append((wid, worker, why))
    assert q.lease("slow", 1) == [0]
    assert not q.speculate("slow", 0)             # not to its own holder
    assert q.speculate("idle", 0) and q.speculated() == [0]
    assert q.leases_held("idle") == [0]
    assert q.complete([0], worker="idle") == [0]
    assert lost == [(0, "slow", "speculated")]
    assert q.speculations == 1 and q.speculations_lost == 1
