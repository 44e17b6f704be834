"""The harness is driven by data: BENCHMARK.json's entries name files the
harness finds, a cell, a configuration, a traffic mix and a metric are
added by new files and entries alone; and run.py prints no result without
a card."""
import json
import re
import shutil
import subprocess
import sys
import time

import pytest

from perfbench import harness
from perfbench.spec import ROOT, Bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
SMALL = {"traffic": {"pool_items": 1, "long_chunks_per_item": 1}}


def test_every_entry_names_files_that_exist():
    """BENCHMARK.json's entries name files that exist, and every cell
    reports setup_s, another end-to-end metric and a per-layer one."""
    b = Bench()
    spec = b.spec
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in spec[key]]
        assert len(names) == len(set(names)), key
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for c in spec["configs"]:
        assert NAME.match(c["name"]) and (ROOT / c["file"]).exists()
        cfg = b.config(c["name"])
        assert (b.here / "runners" / f"{cfg["runner"]}.py").exists()
        assert set(cfg["limits"]) >= {"mask_mismatch", "cleaned_err"}
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"])
        assert (b.here / "metrics" / f"{m['name']}.py").exists(), m["name"]
    for w in spec["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert (b.here / "traffic" / f"{w['traffic']}.json").exists()
        names = {m["name"] for m in b.end_to_end(w["name"])}
        assert "setup_s" in names and len(names) >= 2
        layer = b.per_layer(w["name"])
        assert layer and all(m["moves"] in names for m in layer)


def test_a_new_cell_config_traffic_and_metric_need_no_edit(tmp_path):
    """In a copy: a staged-tail configuration, a traffic mix, a cell and a
    per-layer metric, each a new file and a new entry; the harness runs
    the cell and reports the metric."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    here = root / "perfbench"
    cfg = json.loads((here / "configs" / "serf_archive.json").read_text())
    cfg["name"] = "serf_archive_staged"
    cfg["deployment"]["plan_kwargs"] = {"fuse_tail": False}
    (here / "configs" / "serf_archive_staged.json").write_text(
        json.dumps(cfg))
    (here / "traffic" / "one_minute.json").write_text(json.dumps({
        "pool_items": 1, "long_chunks_per_item": 1,
        "segment_s": 5.0, "persistence": 0.85,
        "label_probs": [0.45, 0.2, 0.15, 0.2]}))
    (here / "metrics" / "batches.staged.py").write_text(
        "def read(run):\n    return len(run.record['batches'])\n")
    spec["configs"].append({
        "name": "serf_archive_staged", "source": "a test",
        "file": "perfbench/configs/serf_archive_staged.json",
        "reduced": [], "why": "a test"})
    cell = "serf_archive_staged.one_minute"
    spec["workloads"].append({"name": cell, "config": "serf_archive_staged",
                              "traffic": "one_minute", "chips": 1,
                              "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] == "audio_mb_s":
            m["workloads"].append(cell)
    spec["per_layer"].append({
        "name": "batches.staged", "unit": "batches", "better": "higher",
        "source": "program_counter", "layer": "plan (core/plans.py)",
        "moves": "audio_mb_s", "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    r = harness.run_cell(cell, 7, 0.5, 1, time.monotonic(), device="cpu",
                         root=root)
    assert r["correct"], r["check"]
    assert r["metrics"]["batches.staged"]["value"] >= 1
    assert "keep_wait_ms.archive" not in r["metrics"]
    r = harness.run_cell(cell, 7, 0.5, 0, time.monotonic(), device="cpu",
                         root=root)
    assert set(r["metrics"]) == {"audio_mb_s", "setup_s"}
    assert list(r)[-1] == "check"


def _run_py(cwd, env_path):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "serf_archive.chorus", "--seed", str(2**31 + 5), "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=120, env={"PATH": "/usr/bin:/bin", "PYTHONPATH": env_path,
                          "CUDA_VISIBLE_DEVICES": ""})


def test_run_prints_no_result_without_a_card():
    p = _run_py(ROOT, str(ROOT / "src"))
    assert p.returncode != 0 and p.stdout == ""
    assert "no CUDA device" in p.stderr


def test_run_prints_no_result_from_the_benchmarks_files_alone(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = _run_py(tmp_path, "")
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.parametrize("workload", ["serf_archive.chorus",
                                      "serf_archive.rain"])
def test_a_sound_run_on_the_cpu_is_correct(workload):
    r = harness.run_cell(workload, 2**31 + 11, 0.5, 0, time.monotonic(),
                         device="cpu", overrides=SMALL)
    assert r["correct"], r["check"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert r["metrics"]["audio_mb_s"]["value"] > 0
