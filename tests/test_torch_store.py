"""The port's persistence on the CPU: `ChunkStore`, `RunJournal` and
`CachedPlan`, the cases of the reference's tests/test_store.py (its sharded
case with a two_phase inner), and the two frameworks reading each other's
store entries and journals, with content keys that keep their entries
apart."""
import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import SERF_AUDIO as cfg
from repro_torch.core.plans import PLANS, CachedPlan, Preprocessor
from repro_torch.data.loader import audio_batch_maker
from repro_torch.data.queue import SettableClock, WorkQueue
from repro_torch.dist.service import pack_result, unpack_result
from repro_torch.store import ChunkStore, RunJournal, content_key

_MASKS = ("keep", "rain", "silence", "cicada15")


def _stream(seed, wids, batch_long_chunks=1):
    make = audio_batch_maker(seed=seed, batch_long_chunks=batch_long_chunks)
    return [(w, make(w)) for w in wids]


@pytest.fixture(scope="module")
def stream4():
    return _stream(21, range(4))


def _pre(plan="cached", **kw):
    return Preprocessor(cfg, plan=plan, device="cpu", **kw)


def _assert_same(got, want):
    for m in _MASKS:
        assert torch.equal(getattr(got.det, m).cpu(),
                           getattr(want.det, m).cpu()), m
    assert got.n_kept == want.n_kept
    np.testing.assert_array_equal(got.cleaned, want.cleaned)


# -------------------------------------------------------------- content key

def test_content_key_sensitivity():
    x = np.ones((1, 2, 64), np.float32)
    fp = ("cfg", ("a", "b"), "geom")
    k = content_key(x, fp, "torch-cuda")
    assert k == content_key(x.copy(), fp, "torch-cuda")  # value identity
    assert k != content_key(x + 1e-6, fp, "torch-cuda")  # bytes matter
    assert k != content_key(x, ("cfg", ("a",), "geom"), "torch-cuda")
    assert k != content_key(x, fp, "torch-cpu")          # framework tag
    assert len(k) == 64                                  # sha256 hex


def test_keys_never_meet_the_reference_keys(stream4):
    """The same batch under the same graph: the port's key differs from
    the reference's under every JAX backend mode, and the card's from the
    CPU's, so a shared store never serves one framework's or one device's
    entry to the other."""
    from repro.configs import SERF_AUDIO as JCFG
    from repro.core.graph import PipelineGraph as JGraph
    from repro.kernels import backend
    from repro.store import content_key as ref_content_key

    from repro_torch.core.graph import PipelineGraph
    x = stream4[0][1][0]
    fp, jfp = PipelineGraph(cfg).fingerprint, JGraph(JCFG).fingerprint
    assert repr(fp) == repr(jfp)            # the same computation
    ours = {content_key(x, fp, f"torch-{d}") for d in ("cpu", "cuda")}
    assert len(ours) == 2
    theirs = {ref_content_key(x, jfp, m) for m in backend._VALID}
    assert len(theirs) == len(backend._VALID)
    assert not ours & theirs
    assert _pre().plan._key(x) == content_key(x, fp, "torch-cpu")


# -------------------------------------------------------------- chunk store

def test_store_roundtrip_and_stats(tmp_path):
    store = ChunkStore(tmp_path)
    arrays = {"cleaned": np.arange(12, dtype=np.float32).reshape(3, 4),
              "keep": np.array([True, False, True])}
    assert store.put("k1", arrays, meta={"n_kept": 2}) is True
    assert "k1" in store and len(store) == 1 and store.keys() == ["k1"]
    got, meta = store.get("k1", src_bytes=100)
    assert meta["n_kept"] == 2
    np.testing.assert_array_equal(got["cleaned"], arrays["cleaned"])
    np.testing.assert_array_equal(got["keep"], arrays["keep"])
    assert got["keep"].dtype == np.bool_
    assert store.get("nope") is None
    st = store.stats
    assert (st.hits, st.misses, st.writes) == (1, 1, 1)
    assert st.bytes_saved == 100 and st.bytes_written > 0
    assert st.hit_rate == 0.5
    assert store.put("k1", arrays) is False
    assert st.dup_writes == 1
    assert str(st).startswith("hits=1 misses=1 (hit rate 50.0%)")


def test_store_writes_are_atomic_no_tmp_residue(tmp_path):
    store = ChunkStore(tmp_path)
    store.put("deadbeef", {"a": np.zeros(4)})
    assert glob.glob(os.path.join(str(tmp_path), "objects", "*.tmp-*")) == []
    entry = os.path.join(str(tmp_path), "objects", "deadbeef")
    assert sorted(os.listdir(entry)) == ["a.npy", "manifest.json"]
    ghost = os.path.join(str(tmp_path), "objects", "feedface.tmp-xyz")
    os.makedirs(ghost)
    open(os.path.join(ghost, "manifest.json"), "w").write("{}")
    assert store.keys() == ["deadbeef"] and len(store) == 1


def test_store_gc_evicts_least_recently_hit(tmp_path):
    store = ChunkStore(tmp_path)
    for i in range(4):
        store.put(f"k{i}", {"a": np.full(256, i, np.float32)})
        mpath = os.path.join(str(tmp_path), "objects", f"k{i}",
                             "manifest.json")
        os.utime(mpath, (1_000_000 + i, 1_000_000 + i))
    per = store.entry_bytes("k0")
    assert per > 256 * 4 // 2
    assert store.get("k0") is not None         # recency beats write order
    rep = store.gc(max_bytes=2 * per)
    assert rep["evicted"] == 2 and rep["bytes_freed"] == 2 * per
    assert rep["entries_after"] == 2 and rep["bytes_after"] <= 2 * per
    assert store.keys() == ["k0", "k3"]
    got, _ = store.get("k0")
    np.testing.assert_array_equal(got["a"], 0.0)
    assert store.stats.gc_evicted == 2
    assert store.stats.gc_bytes_freed == 2 * per
    assert "gc_evicted" in store.stats.as_dict()
    assert store.gc(max_bytes=10 * per)["evicted"] == 0


def test_store_crc_corruption_raises_then_evicts(tmp_path):
    arrays = {"x": np.arange(8, dtype=np.float32)}
    strict = ChunkStore(tmp_path)
    strict.put("kk", arrays)
    target = os.path.join(str(tmp_path), "objects", "kk", "x.npy")
    raw = bytearray(open(target, "rb").read())
    raw[-1] ^= 0xFF
    open(target, "wb").write(bytes(raw))
    with pytest.raises(IOError, match="crc"):
        strict.get("kk")
    healing = ChunkStore(tmp_path, evict_corrupt=True)
    assert healing.get("kk") is None
    assert healing.stats.corrupt == 1
    assert "kk" not in healing
    assert healing.put("kk", arrays) is True
    got, _ = healing.get("kk")
    np.testing.assert_array_equal(got["x"], arrays["x"])


# ------------------------------------------------------------------ journal

def test_run_journal_roundtrip(tmp_path):
    j = RunJournal(tmp_path)
    assert j.load() is None and j.resume_queue() is None
    q = WorkQueue(5, lease_timeout_s=10.0, clock=SettableClock())
    q.lease("w", 2)
    q.complete([0])
    j.record(q, meta={"note": "mid-run"})
    meta = j.load()
    assert meta["emitted"] == 1 and meta["note"] == "mid-run"
    assert meta["queue"]["done"] == [0] and meta["queue"]["leased"] == [1]
    q2 = j.resume_queue(n_items=5, clock=SettableClock())
    assert sorted(q2.lease("w2", 10)) == [1, 2, 3, 4]
    with pytest.raises(ValueError, match="refusing to mix"):
        j.resume_queue(n_items=7)
    j2 = RunJournal(tmp_path)
    assert j2.step == j.step
    j2.record(q2)
    assert j2.step == j.step + 1


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_journal_read_by_the_other_framework(tmp_path, writer):
    from repro.data.queue import WorkQueue as RefQueue
    from repro.store import RunJournal as RefJournal
    W, R = ((RunJournal, RefJournal) if writer == "port"
            else (RefJournal, RunJournal))
    Q = WorkQueue if writer == "port" else RefQueue
    q = Q(6, clock=SettableClock())
    q.lease("w", 3)
    q.complete([0, 2])
    for _ in range(4):                       # prune_old keeps 3 records
        W(tmp_path).record(q, meta={"stream_key0": "ab" * 32})
    meta = R(tmp_path).load()
    assert meta["queue"] == {"n_items": 6, "done": [0, 2], "leased": [1]}
    assert meta["emitted"] == 2 and meta["stream_key0"] == "ab" * 32
    assert R(tmp_path).step == 4
    rest = R(tmp_path).resume_queue(n_items=6).lease("w2", 10)
    assert sorted(rest) == [1, 3, 4, 5]
    assert len([d for d in os.listdir(tmp_path)
                if d.startswith("step_")]) == 3


# ------------------------------------------------------- store entry codec

def test_store_entry_read_by_the_reference(tmp_path, stream4):
    """A port-written entry (the cold run's result) read back at the same
    key by the reference's ChunkStore and codec."""
    from repro.dist.service import unpack_result as ref_unpack
    from repro.store import ChunkStore as RefStore
    pre = _pre(store=tmp_path)
    res = list(pre.run(stream4[1:2]))[0]
    key = pre.plan._key(stream4[1][1][0])
    assert pre.plan.store.keys() == [key]
    arrays, meta = RefStore(tmp_path).get(key)
    det, f = ref_unpack({**arrays, **meta})
    np.testing.assert_array_equal(f["cleaned"], res.cleaned)
    assert f["n_kept"] == res.n_kept == int(res.det.keep.sum())
    assert f["src_bytes"] == res.src_bytes
    for m in _MASKS:
        np.testing.assert_array_equal(np.asarray(getattr(det, m)),
                                      getattr(res.det, m).numpy())
    assert det.wave5.shape == tuple(res.det.wave5.shape)
    assert det.stats == pack_result(res)["stats"]


def test_store_entry_written_by_the_reference(tmp_path, stream4):
    """An entry the reference's ChunkStore writes at the port's key is a
    hit for the port's CachedPlan, equal to the port's own result."""
    from repro.store import ChunkStore as RefStore
    x = stream4[2][1][0]
    want = _pre(plan="two_phase")(x)
    pre = _pre(store=tmp_path)
    assert RefStore(tmp_path).put_payload(pre.plan._key(x),
                                          pack_result(want))
    got = list(pre.run(stream4[2:3]))[0]
    assert (pre.plan.stats.hits, pre.plan.stats.misses) == (1, 0)
    _assert_same(got, want)
    assert not got.det.wave5.any()         # a hit's wave5 is zeros


def test_pack_result_round_trip_gives_cpu_tensors(stream4):
    res = _pre(plan="two_phase")(stream4[1][1][0])
    det, f = unpack_result(pack_result(res))
    for m in _MASKS:
        t = getattr(det, m)
        assert torch.is_tensor(t) and t.device.type == "cpu"
        assert torch.equal(t, getattr(res.det, m))
    assert det.keep.cpu().sum() == f["n_kept"] == res.n_kept
    assert det.wave5.shape == res.det.wave5.shape
    np.testing.assert_array_equal(f["cleaned"], res.cleaned)


# -------------------------------------------------------------- cached plan

def test_cached_plan_registered_and_passthrough(stream4):
    assert PLANS["cached"] is CachedPlan
    ref = {r.wid: r for r in _pre(plan="two_phase").run(stream4)}
    pre = _pre()                                   # no store: passthrough
    assert pre.plan.stats is None
    got = {r.wid: r for r in pre.run(stream4)}
    assert sorted(got) == sorted(ref)
    for w in ref:
        _assert_same(got[w], ref[w])


def test_cached_two_phase_50pct_prestored_bit_identical(tmp_path, stream4):
    """CachedPlan over a stream whose first half was stored before gives
    the uncached plan's output, with its hits and misses counted; a third,
    warm run never reaches the inner plan."""
    ref = {r.wid: r for r in _pre(plan="two_phase").run(stream4)}
    seed_pre = _pre(store=tmp_path)
    list(seed_pre.run(stream4[:2]))
    assert seed_pre.plan.stats.writes == 2
    pre = _pre(store=tmp_path)
    got = {r.wid: r for r in pre.run(stream4)}
    st = pre.plan.stats
    assert (st.hits, st.misses) == (2, 2) and st.hit_rate == 0.5
    assert st.bytes_saved > 0
    assert sorted(got) == sorted(ref)
    for w in ref:
        _assert_same(got[w], ref[w])
    warm = _pre(store=tmp_path)
    warm.plan.inner = None                 # a miss would fail loudly
    warm_res = {r.wid: r for r in warm.run(stream4)}
    assert warm.plan.stats.hit_rate == 1.0
    for w in ref:
        _assert_same(warm_res[w], ref[w])


def test_cached_emits_in_stream_order_with_labels(tmp_path):
    stream = [(w, (chunks, f"label{w}"))
              for w, (_, (chunks, _)) in enumerate(_stream(9, range(3)))]
    list(_pre(store=tmp_path).run(stream[:1]))     # wid 0 pre-stored
    results = list(_pre(store=tmp_path).run(stream))
    assert [r.wid for r in results] == [0, 1, 2]
    assert [r.labels for r in results] == ["label0", "label1", "label2"]


def test_cached_kill_and_resume_exactly_once(tmp_path, stream4):
    store = os.path.join(str(tmp_path), "store")
    pre = _pre(store=store, journal=True)
    gen = pre.run(stream4)
    first = [next(gen).wid, next(gen).wid]
    gen.close()                                    # 'kill' mid-stream
    assert first == [0, 1]
    pre2 = _pre(store=store, journal=True, resume=True)
    rest = [r.wid for r in pre2.run(stream4)]
    assert sorted(first + rest) == [0, 1, 2, 3]    # exactly once
    assert pre2.plan.stats.misses == 2
    assert len(pre2.plan.store) == 4
    assert list(_pre(store=store, journal=True, resume=True)
                .run(stream4)) == []
    with pytest.raises(ValueError, match="refusing to mix"):
        list(_pre(store=store, journal=True, resume=True).run(stream4[:3]))
    other = _stream(99, range(4))
    with pytest.raises(ValueError, match="different content"):
        list(_pre(store=store, journal=True, resume=True).run(other))


def test_cached_call_cold_then_warm(tmp_path, stream4):
    """The single-batch path: a miss runs the inner plan and stores the
    result, the same batch again is a hit with the same output."""
    x = stream4[1][1][0]
    pre = _pre(store=tmp_path)
    cold = pre(x)
    assert pre.plan.stats.misses == 1 and pre.plan.stats.writes == 1
    warm = pre(torch.from_numpy(x))                # a tensor keys the same
    assert pre.plan.stats.hits == 1
    _assert_same(warm, cold)
    assert _pre().plan(x).n_kept == cold.n_kept    # uncached: the inner plan


def test_cached_plan_validation(tmp_path):
    with pytest.raises(ValueError, match="resume=True needs a journal"):
        _pre(store=tmp_path, resume=True)
    with pytest.raises(ValueError, match="journal=True"):
        _pre(journal=True)
    pre = _pre(inner="async", store=tmp_path, depth=3)
    assert pre.plan.inner.name == "async" and pre.plan.inner.depth == 3
    assert pre.plan.inner.device.type == "cpu"
    assert pre.plan.store.evict_corrupt


def test_cached_plan_self_heals_corrupt_entry(tmp_path, stream4):
    pre = _pre(store=tmp_path)
    ref = list(pre.run(stream4[1:2]))
    key = pre.plan.store.keys()[0]
    target = os.path.join(str(tmp_path), "objects", key, "cleaned.npy")
    raw = bytearray(open(target, "rb").read())
    raw[-1] ^= 0xFF
    open(target, "wb").write(bytes(raw))
    pre2 = _pre(store=tmp_path)
    got = list(pre2.run(stream4[1:2]))
    assert pre2.plan.stats.corrupt == 1 and pre2.plan.stats.writes == 1
    np.testing.assert_array_equal(got[0].cleaned, ref[0].cleaned)
    pre3 = _pre(store=tmp_path)
    list(pre3.run(stream4[1:2]))
    assert pre3.plan.stats.hits == 1


def test_cached_key_isolation_across_graph_and_device(tmp_path, stream4):
    """A store shared across configurations never serves a stale entry:
    the key binds the graph fingerprint and the framework tag."""
    pre = _pre(store=tmp_path)
    list(pre.run(stream4[:1]))
    assert pre.plan.stats.writes == 1
    cfg2 = dataclasses.replace(cfg, stages=cfg.stages[:-1])
    pre2 = Preprocessor(cfg2, plan="cached", store=tmp_path, device="cpu")
    list(pre2.run(stream4[:1]))
    assert pre2.plan.stats.misses == 1 and pre2.plan.stats.hits == 0
    x = stream4[0][1][0]
    assert pre.plan._key(x) in pre.plan.store
    assert content_key(x, pre.plan.graph.fingerprint, "torch-cuda") \
        not in pre.plan.store
    pre4 = _pre(store=tmp_path)
    list(pre4.run(stream4[:1]))
    assert pre4.plan.stats.hits == 1


# ---------------------------------------------------------------- launcher

def test_launcher_store_twice_then_resume(tmp_path, capsys):
    from repro_torch.launch import preprocess
    argv = ["--minutes", "2", "--batch-long-chunks", "1", "--device", "cpu",
            "--store", str(tmp_path)]
    kept = preprocess.main(argv)
    assert "hit rate 0.0%" in capsys.readouterr().out
    assert preprocess.main(argv) == kept
    out = capsys.readouterr().out
    assert "store: hits=2 misses=0 (hit rate 100.0%)" in out
    assert "survivor load imbalance (max/mean): 1.000" in out
    assert preprocess.main([*argv, "--resume"]) == 0     # all emitted
    assert "nothing left to emit" in capsys.readouterr().out
    preprocess.main([*argv, "--store-max-bytes", "0"])
    assert "store gc: 2 entries" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [["--resume"], ["--store-max-bytes", "1"],
                                  ["--plan", "fused", "--bucket", "pow2"]])
def test_launcher_refuses_options_without_their_plan(argv):
    from repro_torch.launch import preprocess
    with pytest.raises(SystemExit):
        preprocess.main(["--device", "cpu", *argv])
