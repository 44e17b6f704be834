"""The port's dry-run and its cost counter (`launch/dryrun.py`,
`launch/hlo_analysis.py`) on the CPU, against the reference's.

The two tests of tests/test_hlo_analysis.py on the counter (a loop of L
layers counts L times, the collectives inside it too), a sharded matmul
counting its share, then the cells: the audio detect cell and the reduced
llama3.2-3b prefill, train and decode cells (the reference's test sizes,
B = 2 / 4, S = 32) on a (2, 2) mesh over a 4-rank fake group, each held
within 5% of the reference's `analyze_hlo` count on a 4-device XLA mesh
(the reference in a subprocess, as tests/test_hlo_analysis.py runs it),
and every record with every key of the reference's record."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ARCHS, ShapeConfig, reduced
from repro_torch.launch import dryrun as D
from repro_torch.launch.hlo_analysis import CostCounter, analyze
from repro_torch.launch.mesh import _make_mesh

ROOT = Path(__file__).resolve().parent.parent
TINY = {"tiny_prefill": ShapeConfig("tiny_prefill", 32, 2, "prefill"),
        "tiny_train": ShapeConfig("tiny_train", 32, 4, "train"),
        "tiny_decode": ShapeConfig("tiny_decode", 32, 4, "decode")}
N_CHUNKS = 8

REFERENCE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json
import jax
jax.devices()                   # the device count is fixed from here on
from repro.configs import ARCHS, ShapeConfig, reduced
from repro.launch import dryrun as D
from repro.launch.mesh import _make_mesh
D.get_config = lambda a: reduced(ARCHS[a])
D.SHAPES = dict(D.SHAPES, **{n: ShapeConfig(n, s, b, k)
                             for n, (s, b, k) in %r.items()})
mesh = _make_mesh((2, 2), ("data", "model"))
out = {}
with mesh:
    out["detect"] = D.lower_audio_cell(mesh, "m4", "detect", %d)
    for name in %r:
        out[name] = D.lower_cell("llama3.2-3b", name, mesh, "m4",
                                 num_microbatches=2)
print("RECORDS " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    """The reference's records of the same cells on 4 XLA host devices."""
    shapes = {n: (s.seq_len, s.global_batch, s.kind) for n, s in TINY.items()}
    code = REFERENCE % (shapes, N_CHUNKS, list(TINY))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("RECORDS ")][-1]
    return json.loads(line[len("RECORDS "):])


@pytest.fixture(scope="module")
def port():
    """The port's records of the same cells on a (2, 2) mesh over a fake
    group of 4 ranks."""
    saved = D.get_config, D.SHAPES
    D.get_config = lambda a: reduced(ARCHS[a])
    D.SHAPES = dict(D.SHAPES, **TINY)
    try:
        with D.fake_group(4):
            mesh = _make_mesh((2, 2), ("data", "model"), "cuda")
            out = {"detect": D.lower_audio_cell(mesh, "m4", "detect",
                                                N_CHUNKS)}
            for name in TINY:
                out[name] = D.lower_cell("llama3.2-3b", name, mesh, "m4",
                                         num_microbatches=2)
    finally:
        D.get_config, D.SHAPES = saved
    return out


def test_counter_counts_loop_trip_counts():
    """A loop of L layers dispatches its body L times: over a stacked
    weight (the reference's scan) and over a list (its unrolled form)."""
    L, E, B = 6, 128, 4
    ws = torch.randn(L, E, E)
    x = torch.randn(B, E)

    def stacked(ws, h):
        for i in range(L):
            h = torch.tanh(h @ ws[i])
        return h.sum()

    def unrolled(ws, h):
        for w in list(ws.unbind(0)):
            h = torch.tanh(torch.einsum("be,ef->bf", h, w))
        return h.sum()

    expected = 2.0 * B * E * E * L
    for fn in (stacked, unrolled):
        got = analyze(fn, ws, x)
        assert abs(got["dot_flops"] - expected) / expected < 0.05, got
        assert got["coll_bytes"] == 0.0
    # on meta tensors the same counts, nothing computed
    meta = analyze(stacked, ws.to("meta"), x.to("meta"))
    assert meta["dot_flops"] == expected


def test_counter_counts_collectives_inside_loop():
    """On a (4,) "model" mesh, a loop of L = 5 layers whose weights are
    column-sharded all-gathers its (B, E) activation in every layer."""
    from torch.distributed.tensor import Replicate, Shard
    L, E, B = 5, 64, 8
    with D.fake_group(4):
        mesh = _make_mesh((4,), ("model",), "cpu")
        from torch.distributed.tensor import distribute_tensor
        w = distribute_tensor(torch.empty(L, E, E, device="meta"), mesh,
                              [Shard(2)], src_data_rank=None)
        x = distribute_tensor(torch.empty(B, E, device="meta"), mesh,
                              [Replicate()], src_data_rank=None)

        def f(ws, h):
            for i in range(L):
                h = (h @ ws[i]).redistribute(mesh, [Replicate()])
                h = torch.tanh(h)
            return h

        agg = analyze(f, w, x)
    assert agg["coll_bytes"] >= L * B * E * 4 * 0.5, agg
    assert set(agg["coll_by_op"]) == {"all-gather"}
    assert agg["dot_flops"] == 2.0 * B * E * (E // 4) * L


@pytest.mark.parametrize("placements", ["S0R_RS1", "S0S1_RS1"])
def test_sharded_matmul_counts_its_share(placements):
    """(256 x 4096) @ (4096 x 4096) over a 16 x 16 fake mesh: 1/256 of
    the global FLOPs a device, not the global op DTensor runs on fake
    tensors to propagate shapes; the operand the product needs whole is
    all-gathered over its 16 ranks."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    with D.fake_group(256):
        mesh = _make_mesh((16, 16), ("data", "model"), "cpu")
        a_pl = ([Shard(0), Replicate()] if placements == "S0R_RS1"
                else [Shard(0), Shard(1)])
        a = distribute_tensor(torch.empty(256, 4096, device="meta"), mesh,
                              a_pl, src_data_rank=None)
        b = distribute_tensor(torch.empty(4096, 4096, device="meta"), mesh,
                              [Replicate(), Shard(1)], src_data_rank=None)
        got = analyze(lambda: a @ b)
    assert got["dot_flops"] == 2.0 * 256 * 4096 * 4096 / 256
    if placements == "S0R_RS1":
        assert got["coll_bytes"] == 0.0
    else:
        # a's (16, 256) local columns gathered over the model axis
        assert got["coll_by_op"] == {"all-gather": 16 * 4096 * 4 * 15 / 16}


def test_counter_tracks_live_bytes():
    x = torch.empty(1000, 1000, device="meta")
    with CostCounter() as c:
        y = x + 1
        z = y * 2
        assert c.live_bytes == 8_000_000
        del y, z
    assert c.live_bytes == 0 and c.peak_bytes == 8_000_000


@pytest.mark.parametrize("cell", ["detect", "tiny_prefill", "tiny_train",
                                  "tiny_decode"])
def test_cell_flops_match_reference(port, reference, cell):
    """Per-device matmul FLOPs within 5% of the reference's trip-count
    walk of its compiled HLO."""
    got = port[cell]["flops_per_device"]
    want = reference[cell]["flops_per_device"]
    assert want > 0 and abs(got - want) / want < 0.05, (got, want)


@pytest.mark.parametrize("cell", ["detect", "tiny_prefill", "tiny_train",
                                  "tiny_decode"])
def test_records_have_reference_keys(port, reference, cell):
    rec, ref = port[cell], reference[cell]
    assert set(rec) == set(ref), set(rec) ^ set(ref)
    assert set(rec["memory"]) == set(ref["memory"])
    for key in ("compile_s", "xla_flops_per_device", "xla_bytes_per_device",
                "flat_collective_bytes"):
        if key in rec:
            assert rec[key] is None
    assert rec["lower_s"] >= 0 and rec["n_devices"] == 4
    for key in ("kind", "mode", "microbatches", "model_flops"):
        assert rec[key] == ref[key], key
    assert set(rec["collectives_by_op"]) <= {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute"}
    mem = rec["memory"]
    assert mem["argument_bytes"] > 0 and mem["temp_bytes"] >= 0


def test_audio_cells_run_under_matmul_mode():
    """The three audio cells at a small n_chunks: the mode is restored
    after each, fused counts detection's FLOPs and more, and mmse45's
    survivor rows split evenly over the mesh."""
    from repro_torch.kernels import backend
    with D.fake_group(4):
        mesh = _make_mesh((2, 2), ("data", "model"), "cuda")
        recs = {v: D.lower_audio_cell(mesh, "m4", v, 4)
                for v in ("fused", "detect", "mmse45")}
    assert backend.get_mode() == "auto"
    assert recs["fused"]["flops_per_device"] > \
        recs["detect"]["flops_per_device"] > 0
    assert recs["mmse45"]["flops_per_device"] > 0
    assert recs["mmse45"]["shape"] == "pipeline_mmse45"
    assert all(r["collectives_by_op"].keys() <= {"all-reduce", "all-gather"}
               for r in recs.values())


def test_main_writes_records(tmp_path, monkeypatch):
    """The CLI over a reduced arch: exit 0 and one record a cell."""
    monkeypatch.setattr(D, "get_config", lambda a: reduced(ARCHS[a]))
    monkeypatch.setattr(D, "SHAPES", dict(D.SHAPES, **TINY))
    monkeypatch.setattr(D, "MESHES", {"single_pod_16x16": (4, False),
                                      "multi_pod_2x16x16": (4, True)})
    monkeypatch.setattr(D, "production_mesh", lambda name: _make_mesh(
        (2, 2) if name.startswith("single") else (2, 1, 2),
        ("data", "model") if name.startswith("single")
        else ("pod", "data", "model"), "cpu"))
    out = tmp_path / "rec.json"
    with pytest.raises(SystemExit) as e:
        D.main(["--arch", "llama3.2-3b", "--shape", "tiny_prefill",
                "--mesh", "both", "--out", str(out)])
    assert e.value.code == 0
    recs = json.loads(out.read_text())
    assert [r["mesh"] for r in recs] == ["single_pod_16x16",
                                         "multi_pod_2x16x16"]
    assert [r["n_devices"] for r in recs] == [4, 4]
    assert all(r["flops_per_device"] > 0 for r in recs)


def test_fake_group_is_one_world_at_a_time():
    import torch.distributed as dist
    with D.fake_group(4):
        assert dist.get_world_size() == 4
        with pytest.raises(RuntimeError):
            with D.fake_group(8):
                pass
    assert not dist.is_initialized()


def test_meta_model_builds_at_full_width_without_drawing():
    from repro_torch.models.zoo import build_meta_model
    cfg = ARCHS["llama3.2-3b"]
    model = build_meta_model(cfg)
    params = list(model.parameters())
    assert {p.device.type for p in params} == {"meta"}
    assert abs(sum(p.numel() for p in params)
               - cfg.param_counts()["total"]) / cfg.param_counts()["total"] \
        < 1e-3
    with pytest.raises(ValueError):
        from repro_torch.device import resolve_device
        resolve_device("meta")      # the entry points' default unchanged
