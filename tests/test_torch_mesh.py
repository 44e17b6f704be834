"""The port's mesh half against the JAX package, in one process: the
sharding rules over a torch `DeviceMesh` (spec, placements, fingerprints,
pool_rules) against the reference's on a (2, 2) and a (4, 1) mesh, the
ported audits (every cell shards evenly, plan_mesh, the production meshes
over a fake process group of 256 and 512 ranks), the facade's positional
order, the detect_flux stage against the reference and the helpers
`generate_hours`, `denoise_power_ref`, `stft_ref_packed` and
`power_spectrum`.

Meshes need a process group. Those of several ranks are made over a fake
group (`torch.testing._internal.distributed.fake_pg`) in a subprocess, as
the reference's own tests make 4 host devices in one; the reference side
runs in a subprocess with `--xla_force_host_platform_device_count=4`."""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as RC  # noqa: E402
from repro.configs import SERF_AUDIO as JCFG  # noqa: E402
from repro.core.plans import Preprocessor as JPreprocessor  # noqa: E402
from repro.data import synthetic as JSYN  # noqa: E402
from repro.distributed import sharding as RS  # noqa: E402
from repro.ft.failure import plan_mesh as ref_plan_mesh  # noqa: E402
from repro.kernels import backend  # noqa: E402
from repro.kernels.mmse_stsa import ref as JMMSE  # noqa: E402
from repro.kernels.stft_dft import ref as JSTFT  # noqa: E402

from repro_torch.configs import ARCHS, SERF_AUDIO as cfg  # noqa: E402
from repro_torch.configs import SHAPES, cell_is_runnable  # noqa: E402
from repro_torch.core.graph import (GraphValidationError,  # noqa: E402
                                    PipelineGraph)
from repro_torch.core.plans import PLANS, Preprocessor  # noqa: E402
from repro_torch.data import synthetic as SYN  # noqa: E402
from repro_torch.distributed import sharding as S  # noqa: E402
from repro_torch.ft.failure import MeshPlan, plan_mesh  # noqa: E402
from repro_torch.kernels.mmse_stsa import ref as MMSE  # noqa: E402
from repro_torch.kernels.stft_dft import ref as STFT  # noqa: E402
from repro_torch.serve.preprocess_service import (  # noqa: E402
    PreprocessService)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("tp", "fsdp_tp", "zero3", "sp_ep")
SHAPES_2D = ((2, 2), (4, 1))
NAMES = sorted(RS._TABLES["sp_ep"])


def _run(code, env=None, timeout=180):
    """Run `code` in a fresh interpreter from the repo root; returns its
    last stdout line parsed as JSON."""
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)], capture_output=True,
        text=True, timeout=timeout, cwd=_ROOT,
        env={**os.environ, "PYTHONPATH": "src", **(env or {})})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def ref_specs():
    """{mode: {shape: {name: spec entries}}} of the reference's rules over
    4 forced host devices."""
    return _run("""
        import json
        from repro.launch.mesh import _make_mesh
        from repro.distributed.sharding import ShardingRules, _TABLES
        names = sorted(_TABLES["sp_ep"])
        out = {}
        for mode in ("tp", "fsdp_tp", "zero3", "sp_ep"):
            for shape in ((2, 2), (4, 1)):
                r = ShardingRules(_make_mesh(shape, ("data", "model")), mode)
                out.setdefault(mode, {})[str(shape)] = {
                    n: [list(e) if isinstance(e, tuple) else e
                        for e in r.spec(n)] for n in names}
        print(json.dumps(out))
        """, env={"XLA_FLAGS": "--xla_force_host_platform_device_count=4",
                  "JAX_PLATFORMS": "cpu"})


@pytest.fixture(scope="module")
def port_meshes():
    """The port's rules over fake-group meshes: specs and placements for
    every mode, shape and name; fingerprints of pool_rules over one mesh
    and over two; make_production_mesh and make_local_mesh over 256 and
    512 ranks."""
    return _run("""
        import json
        import torch, torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.distributed.sharding import (ShardingRules,
                                                      _TABLES, pool_rules)
        from repro_torch.launch import mesh as M
        from repro_torch.ft.failure import plan_mesh
        names = sorted(_TABLES["sp_ep"])
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=8)
        out = {"specs": {}, "placements": {}}
        for mode in ("tp", "fsdp_tp", "zero3", "sp_ep"):
            for shape in ((2, 2), (4, 1)):
                r = ShardingRules(M._make_mesh(shape, ("data", "model"),
                                               "cpu"), mode)
                key = str(shape)
                out["specs"].setdefault(mode, {})[key] = {
                    n: [list(e) if isinstance(e, tuple) else e
                        for e in r.spec(n)] for n in names}
                out["placements"].setdefault(mode, {})[key] = {
                    n: [str(p) for p in r.sharding(n, None)] for n in names}
        m1 = M._make_mesh((2, 2), ("data", "model"), "cpu")
        m2 = DeviceMesh("cpu", torch.arange(4, 8).reshape(2, 2),
                        mesh_dim_names=("data", "model"))
        same = pool_rules(3, m1, mode="zero3")
        two = pool_rules(3, [m1, m2])
        out["same"] = len({r.fingerprint for r in same})
        out["two"] = [list(map(str, r.fingerprint[1])) for r in two]
        out["two_distinct"] = len({r.fingerprint for r in two})
        out["local"] = [list(M.make_local_mesh(mp).mesh.shape)
                        for mp in (1, 2, 3, 16)]
        plan = M.mesh_from_plan(plan_mesh(8, model_parallel=2))
        out["from_plan"] = [list(plan.mesh.shape),
                            list(plan.mesh_dim_names)]
        dist.destroy_process_group()
        prod = {}
        for world, multi in ((256, False), (512, True)):
            dist.init_process_group("fake", store=FakeStore(), rank=0,
                                    world_size=world)
            m = M.make_production_mesh(multi_pod=multi)
            prod[world] = [list(m.mesh.shape), list(m.mesh_dim_names),
                           ShardingRules(m).fingerprint[1][2][-1]]
            dist.destroy_process_group()
        out["production"] = prod
        print(json.dumps(out))
        """)


@pytest.mark.parametrize("shape", SHAPES_2D, ids=str)
@pytest.mark.parametrize("mode", MODES)
def test_rules_spec_equals_reference(ref_specs, port_meshes, mode, shape):
    """For every logical name the port's spec over a torch mesh equals the
    reference's PartitionSpec entries over a JAX mesh of the same shape,
    and the placements put tensor dim 0 on exactly the spec's mesh axes."""
    key = str(shape)
    want = ref_specs[mode][key]
    got = port_meshes["specs"][mode][key]
    assert got == want
    for name in NAMES:
        axes = want[name][0]
        axes = [] if axes is None else ([axes] if isinstance(axes, str)
                                        else axes)
        pl = port_meshes["placements"][mode][key][name]
        assert pl == ["S(0)" if ax in axes else "R"
                      for ax in ("data", "model")], (name, pl)


def test_pool_rules_fingerprints_dedup_and_differ(port_meshes):
    assert port_meshes["same"] == 1
    assert port_meshes["two_distinct"] == 2
    fp = port_meshes["two"]
    assert fp[0] == fp[2] != fp[1]
    assert fp[0][-1] == "(0, 1, 2, 3)" and fp[1][-1] == "(4, 5, 6, 7)"


def test_make_production_and_local_meshes(port_meshes):
    assert port_meshes["production"]["256"] == [[16, 16],
                                                ["data", "model"], 255]
    assert port_meshes["production"]["512"] == [
        [2, 16, 16], ["pod", "data", "model"], 511]
    # the model axis halves until it divides the 8 ranks
    assert port_meshes["local"] == [[8, 1], [4, 2], [8, 1], [1, 8]]
    assert port_meshes["from_plan"] == [[4, 2], ["data", "model"]]


# ------------------------------------------------------------ the rules

@pytest.mark.parametrize("arch", sorted(RC.ARCHS))
def test_all_cells_shard_evenly(arch):
    """The reference's static divisibility audit, on the port's configs:
    every (arch x shape) cell on the 16x16 and 2x16x16 meshes."""
    c = ARCHS[arch]
    for tp in (16,):
        assert c.q_dim % tp == 0, "q_dim"
        assert c.kv_dim % tp == 0, "kv_dim"
        if c.d_ff:
            assert c.d_ff % tp == 0, "d_ff"
        assert c.padded_vocab % tp == 0, "vocab"
        assert c.d_model % 32 == 0, "fsdp d_model over pod*data"
    for shape in SHAPES.values():
        ok, _ = cell_is_runnable(c, shape)
        if not ok:
            continue
        if shape.kind in ("train", "prefill"):
            assert shape.global_batch % 32 == 0 or \
                shape.global_batch % 16 == 0
        elif shape.global_batch > 1:
            assert shape.global_batch % 32 == 0
            assert shape.seq_len % 16 == 0      # kv_seq over model
        else:
            assert shape.seq_len % 256 == 0     # kv_seq over data x model


@pytest.mark.parametrize("n", [1, 2, 3, 8, 100, 256, 300, 512, 1024, 4096])
def test_plan_mesh_equals_reference(n):
    got, want = plan_mesh(n), ref_plan_mesh(n)
    assert (got.shape, got.axes, got.reason) == \
        (want.shape, want.axes, want.reason)
    assert isinstance(got, MeshPlan)


def test_plan_mesh_elastic():
    assert plan_mesh(512).shape == (2, 16, 16)
    assert plan_mesh(256).shape == (16, 16)
    p = plan_mesh(100)
    assert p.shape == (6, 16) and "spare" in p.reason
    assert plan_mesh(8).shape == (1, 8)


# ------------------------------------------------- the facade's argument order

def _long_chunks(seed, n_long, gen=SYN.generate_labelled):
    audio, labels = gen(seed, n_long * 12, segment_s=5.0)
    s5 = audio.shape[-1]
    return (audio.reshape(n_long, 12, 2, s5).transpose(0, 2, 1, 3)
            .reshape(n_long, 2, 12 * s5)), labels


def test_preprocessor_and_service_take_rules_second():
    """`Preprocessor(cfg, rules, plan, pad_multiple)` and
    `PreprocessService(cfg, rules, plan, ...)` positionally, in the
    reference's order; a rules list is refused by every plan but the
    sharded one (and a cached plan around it)."""
    pre = Preprocessor(cfg, S.NULL_RULES, "fused", 4, device="cpu")
    assert pre.rules is S.NULL_RULES and pre.plan.name == "fused"
    assert pre.plan.pad_multiple == 4 and pre.plan.rules is S.NULL_RULES
    svc = PreprocessService(cfg, S.NULL_RULES, "two_phase", 2, device="cpu")
    assert svc.pre.plan.name == "two_phase" and svc.batch == 2
    pool = S.pool_rules(2)
    sh = Preprocessor(cfg, pool, "sharded", shards=2, device="cpu")
    assert sh.plan.rules_pool == tuple(pool) and sh.rules is pool[0]
    cached = Preprocessor(cfg, pool, "cached", inner="sharded", shards=2,
                          device="cpu")
    assert cached.plan.inner.rules_pool == tuple(pool)
    for plan in ("two_phase", "async", "fused"):
        with pytest.raises(ValueError, match="per-shard rules list"):
            Preprocessor(cfg, pool, plan, device="cpu")
    with pytest.raises(ValueError, match="per-shard rules list"):
        Preprocessor(cfg, pool, "cached", inner="two_phase", device="cpu")
    with pytest.raises(ValueError, match="3 per-shard rules for 2"):
        Preprocessor(cfg, S.pool_rules(3), "sharded", shards=2,
                     device="cpu")
    assert all(getattr(PLANS[p], "accepts_rules_pool", False)
               == (p in ("sharded", "cached")) for p in PLANS)


# ------------------------------------ detect_flux against the reference

def test_detect_flux_drop_in_detector():
    """The spectral-flux detector swaps in for 'detect_silence' purely via
    the stage list and runs stacked beside it; masks equal the
    reference's (ref mode) exactly, stats within rtol 1e-4."""
    st = list(cfg.stages)
    st[st.index("detect_silence")] = "detect_flux"
    graph = PipelineGraph(cfg, tuple(st))
    assert graph.has_removal_point and "detect_flux" in graph.names
    chunks4, labels = _long_chunks(13, 4)
    both = tuple(cfg.stages[:-2] + ("detect_flux",) + cfg.stages[-2:])
    for stages in (tuple(st), both):
        res = Preprocessor(cfg, plan="two_phase", stages=stages,
                           device="cpu")(chunks4)
        with backend.use("ref"):
            want = JPreprocessor(JCFG, plan="two_phase", stages=stages)(
                jnp.asarray(chunks4))
        for m in ("keep", "rain", "silence", "cicada15"):
            np.testing.assert_array_equal(getattr(res.det, m).numpy(),
                                          np.asarray(getattr(want.det, m)),
                                          err_msg=m)
        for k, v in want.det.stats.items():
            np.testing.assert_allclose(float(res.det.stats[k]), float(v),
                                       rtol=1e-4, err_msg=k)
        assert res.cleaned.shape[0] == res.det.keep.sum() == res.n_kept
        if stages == both:
            assert not (res.det.keep.numpy() & ~keep).any()
        else:
            keep = res.det.keep.numpy()
            # flux keeps active chunks (bird=0, cicada=2)
            assert (keep == np.isin(labels, (0, 2))).mean() >= 0.9
    with pytest.raises(GraphValidationError, match="power"):
        PipelineGraph(cfg, ("to_mono", "compress", "detect_flux"))


# ------------------------------------------------------------ the helpers

def test_generate_hours_equals_reference():
    got = SYN.generate_hours(3, 0.01)
    want = JSYN.generate_hours(3, 0.01)
    assert got[0].shape == want[0].shape == (7, 2, 220_500)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_stft_and_mmse_helpers_equal_reference():
    x = np.random.RandomState(0).randn(3, 4000).astype(np.float32)
    for w, hop in ((256, 128), (200, 100)):
        np.testing.assert_allclose(
            STFT.stft_ref_packed(torch.from_numpy(x), w, hop).numpy(),
            np.asarray(JSTFT.stft_ref_packed(jnp.asarray(x), w, hop)),
            rtol=1e-4, atol=1e-4)
        got = STFT.power_spectrum(torch.from_numpy(x), w, hop).numpy()
        want = np.asarray(JSTFT.power_spectrum(jnp.asarray(x), w, hop))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    power = STFT.power_spectrum(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        MMSE.denoise_power_ref(torch.from_numpy(power)).numpy(),
        np.asarray(JMMSE.denoise_power_ref(jnp.asarray(power))),
        rtol=1e-5, atol=1e-6)


# ------------------------------------------- plans over a one-rank CPU mesh

@pytest.fixture
def one_rank_mesh():
    """A one-rank gloo group and its (1, 1) mesh, the group destroyed
    after the test."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh
    assert not dist.is_initialized()
    mesh = make_local_mesh(device="cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def _batches(n, k=1):
    from repro_torch.data.loader import audio_batch_maker
    make = audio_batch_maker(seed=25, batch_long_chunks=k)
    return [make(w)[0] for w in range(n)]


def test_plans_under_rules_over_a_mesh_equal_unmeshed(one_rank_mesh):
    """two_phase, fused and the in-process sharded plan with a per-shard
    rules pool over the one-rank mesh (the plan on the mesh's device)
    emit what they emit without one; detect returns whole tensors."""
    rules = S.ShardingRules(one_rank_mesh)
    (chunks,) = _batches(1, 2)
    for plan, kw, r in (("two_phase", {}, rules), ("fused", {}, rules),
                        ("sharded", {"shards": 2},
                         S.pool_rules(2, one_rank_mesh)),
                        ("cached", {"inner": "sharded", "shards": 2},
                         S.pool_rules(2, one_rank_mesh))):
        want = Preprocessor(cfg, plan=plan, device="cpu", **kw)(chunks)
        pre = Preprocessor(cfg, r, plan=plan, **kw)
        assert pre.device.type == "cpu"
        got = pre(chunks)
        for m in ("keep", "rain", "silence", "cicada15"):
            assert not S.is_dtensor(getattr(got.det, m))
            assert torch.equal(getattr(got.det, m), getattr(want.det, m))
        np.testing.assert_array_equal(got.cleaned, want.cleaned)
    det = Preprocessor(cfg, rules).detect(chunks)
    assert not S.is_dtensor(det.wave5) and det.wave5.shape[0] == 24


def test_launch_preprocess_builds_a_mesh_and_keeps_the_same_counts(
        capsys):
    """launch.preprocess over its own one-rank group: the kept count of
    the unmeshed two_phase on the same stream, and no group left."""
    import torch.distributed as dist

    from repro_torch.launch import preprocess
    kept = preprocess.main(["--minutes", "2", "--batch-long-chunks", "1",
                            "--device", "cpu", "--plan", "async"])
    assert not dist.is_initialized()
    from repro_torch.data.loader import audio_batch_maker
    make = audio_batch_maker(seed=0, batch_long_chunks=1)
    want = sum(r.n_kept for r in Preprocessor(cfg, device="cpu").run(
        [make(w) for w in range(2)]))
    assert kept == want > 0
    assert "pipeline: " in capsys.readouterr().out


def test_pipeline_report_equals_reference():
    from repro.launch.preprocess import pipeline_report as ref_report

    from repro_torch.launch.preprocess import pipeline_report
    timings = [{"dispatch_s": 0.01 * i, "readback_s": 0.002, "tail_s": 0.1,
                "emit_s": 0.003, "compact_s": 0.0001, "in_flight": i,
                "d2h_bytes": 100 * i, "h2d_bytes": 8,
                "old_boundary_bytes": 1000, "wave5_bytes": 5000}
               for i in range(1, 4)]
    assert pipeline_report(timings) == ref_report(timings)
