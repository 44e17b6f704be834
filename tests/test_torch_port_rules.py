"""The port's own rules: it imports nothing of JAX or the JAX package and
names no module of the JAX package in a string (a spawn argv such as
`python -m repro.dist.worker` would run the reference), its entry points do
not fall back to the CPU, CPU tensors never launch a kernel, and its copies
of the reference's config and synthetic data are exact."""
import ast
import dataclasses
import json
import re
import runpy
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import SERF_AUDIO, from_reference_config
from repro_torch.data import synthetic
from repro_torch.data.loader import audio_batch_maker

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "scripts" / "fir_variants.py",
    ROOT / "scripts" / "mmse_variants.py",
    ROOT / "scripts" / "dft_variants.py",
    ROOT / "scripts" / "lm_profile.py",
    ROOT / "scripts" / "train_profile.py",
    ROOT / "scripts" / "span_breakdown.py",
    ROOT / "scripts" / "init_loss_depth.py",
    ROOT / "scripts" / "multirank_check.py", ROOT / "tests" / "torch_ranks.py",
    ROOT / "examples" / "preprocess_and_train_torch.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                roots.add(".")                      # relative import
            else:
                roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_no_jax_and_no_reference_package():
    assert len(PORT_FILES) > 20
    bad = {str(p.relative_to(ROOT)): sorted(
        _imported_roots(p) & {"jax", "jaxlib", "repro", "."})
        for p in PORT_FILES}
    assert not {k: v for k, v in bad.items() if v}


# a dotted name under the reference package: `repro.` and a module name
_REFERENCE_MODULE = re.compile(r"(?<![\w.])repro\.[A-Za-z_]")


def _reference_module_strings(source, name="<port file>"):
    """String constants (docstrings included) that name a module of the
    reference package, such as "repro.dist.worker" in a spawn argv."""
    return sorted({node.value for node in ast.walk(ast.parse(source, name))
                   if isinstance(node, ast.Constant)
                   and isinstance(node.value, str)
                   and _REFERENCE_MODULE.search(node.value)})


def test_port_names_no_reference_module_in_a_string():
    bad = {str(p.relative_to(ROOT)): _reference_module_strings(
        p.read_text(), str(p)) for p in PORT_FILES}
    assert not {k: v for k, v in bad.items() if v}


@pytest.mark.parametrize("source,flagged", [
    ('argv = [sys.executable, "-m", "repro.dist.worker"]', True),
    ('"""Spawns python -m repro.dist.worker."""', True),
    ("x = 'see repro.core.plans'", True),
    ('argv = [sys.executable, "-m", "repro_torch.dist.worker"]', False),
    ('name = "repro-dist-conn"', False),
    ("# repro.dist.worker in a comment is not a string", False),
])
def test_reference_module_scan_catches_a_spawn_argv(source, flagged):
    assert bool(_reference_module_strings(source)) is flagged


def _entry_points():
    from repro_torch.configs import SERF_AUDIO as cfg
    from repro_torch.core.graph import PipelineGraph
    from repro_torch.core.plans import (CachedPlan, FusedPlan, Preprocessor,
                                        ShardedPlan, TwoPhasePlan)
    from repro_torch.device import resolve_device
    from repro_torch.launch import preprocess, serve, train
    from repro_torch.serve import PreprocessService, WorkerPool
    example = runpy.run_path(
        str(ROOT / "examples" / "preprocess_and_train_torch.py"))
    return {
        "resolve_device": lambda: resolve_device(),
        "Preprocessor": lambda: Preprocessor(cfg),
        "TwoPhasePlan": lambda: TwoPhasePlan(PipelineGraph(cfg)),
        "FusedPlan": lambda: FusedPlan(PipelineGraph(cfg)),
        "CachedPlan": lambda: CachedPlan(PipelineGraph(cfg)),
        "ShardedPlan": lambda: ShardedPlan(PipelineGraph(cfg)),
        "Preprocessor sharded proc": lambda: Preprocessor(
            cfg, plan="sharded", transport="proc"),
        "launch.preprocess": lambda: preprocess.main(["--minutes", "4"]),
        "launch.preprocess sharded": lambda: preprocess.main(
            ["--minutes", "4", "--plan", "sharded", "--transport", "tcp"]),
        "WorkerPool": lambda: WorkerPool(cfg, transport="inproc"),
        "PreprocessService": lambda: PreprocessService(cfg),
        "launch.serve": lambda: serve.main(["--audio"]),
        "launch.train": lambda: train.main(["--reduced"]),
        "preprocess_and_train_torch": lambda: example["main"](["--steps",
                                                               "1"]),
    }


@pytest.mark.parametrize("name", ["resolve_device", "Preprocessor",
                                  "TwoPhasePlan", "FusedPlan", "CachedPlan",
                                  "ShardedPlan", "Preprocessor sharded proc",
                                  "launch.preprocess",
                                  "launch.preprocess sharded", "WorkerPool",
                                  "PreprocessService", "launch.serve",
                                  "launch.train",
                                  "preprocess_and_train_torch"])
def test_entry_points_raise_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the CPU-only case")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()


def test_cpu_tensors_never_launch_a_kernel():
    from repro_torch.core.plans import Preprocessor
    from repro_torch.kernels.fir_hpf import ops as FO
    from repro_torch.kernels.fused_tail import ops as TO
    from repro_torch.kernels.mmse_stsa import ops as MO
    from repro_torch.kernels.stft_dft import ops as SO
    kernels.reset_launches()
    x = torch.randn(2, 40_000)
    FO.bandpass_decimate(x)
    FO.highpass(x)
    p = SO.stft_power(x)
    MO.mmse_gain(p, p[:, :16].mean(1))
    TO.fused_tail(x, torch.tensor([1, 0, 2], dtype=torch.int32), SERF_AUDIO,
                  hpf=True)
    chunks, _ = audio_batch_maker(3, 1)(0)
    for fuse_tail in (None, False):
        Preprocessor(SERF_AUDIO, device="cpu", fuse_tail=fuse_tail)(chunks)
    assert kernels.launches() == dict.fromkeys(kernels.KERNELS, 0)


def test_from_reference_config_round_trips_serf_audio():
    from repro.configs import SERF_AUDIO as REF
    d = dataclasses.asdict(REF)
    assert from_reference_config(d) == SERF_AUDIO
    assert dataclasses.asdict(SERF_AUDIO) == d
    # a JSON round trip turns tuples into lists
    assert from_reference_config(json.loads(json.dumps(d))) == SERF_AUDIO
    ablated = dataclasses.replace(REF, stages=REF.stages[:-1],
                                  silence_snr_threshold=0.3)
    got = from_reference_config(dataclasses.asdict(ablated))
    assert got.stages == ablated.stages and got.silence_snr_threshold == 0.3


def test_from_reference_config_rejects_unknown_or_missing_fields():
    d = dataclasses.asdict(SERF_AUDIO)
    with pytest.raises(ValueError, match="unknown"):
        from_reference_config({**d, "not_a_field": 1})
    del d["stft_hop"]
    with pytest.raises(ValueError, match="missing"):
        from_reference_config(d)


@pytest.mark.parametrize("seed", [0, 7, 25])
def test_synthetic_bit_identical_to_reference(seed):
    from repro.data import synthetic as ref_synthetic
    from repro.data.loader import audio_batch_maker as ref_maker
    got, got_labels = synthetic.generate_labelled(seed, 8)
    want, want_labels = ref_synthetic.generate_labelled(seed, 8)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_labels, want_labels)
    got_b, _ = audio_batch_maker(seed, 1)(1)
    want_b, _ = ref_maker(seed, 1)(1)
    np.testing.assert_array_equal(got_b, want_b)
