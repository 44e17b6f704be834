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
        if m["name"] == "device_mb_s":
            m["workloads"].append(cell)
    spec["per_layer"].append({
        "name": "batches.staged", "unit": "batches", "better": "higher",
        "source": "program_counter", "layer": "plan (core/plans.py)",
        "moves": "device_mb_s", "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    r = harness.run_cell(cell, 7, 0.5, 1, time.monotonic(), device="cpu",
                         root=root)
    assert r["correct"], r["check"]
    assert r["metrics"]["batches.staged"]["value"] >= 1
    assert "keep_wait_ms.archive" not in r["metrics"]
    r = harness.run_cell(cell, 7, 0.5, 0, time.monotonic(), device="cpu",
                         root=root)
    assert {m["name"] for m in Bench(root).end_to_end(cell)} == {
        "device_mb_s", "setup_s"}
    # no card: device_mb_s finds nothing to read and is left out
    assert set(r["metrics"]) == {"setup_s"}
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
    assert r["metrics"]["setup_s"]["value"] > 0
    assert "device_mb_s" not in r["metrics"]    # no card to read


def test_the_rates_read_the_window_and_the_cards_busy_seconds():
    """device_mb_s divides the window's source bytes by the union of the
    card's operations (overlaps counted once); audio_mb_s.archive by the
    window's length on the host's clock."""
    from perfbench.trace import Interval, Trace
    card = Trace(device=[Interval("k", 10.0, 10.5), Interval("c", 10.25,
                                                             11.0),
                         Interval("k", 12.0, 12.5)], start=10.0,
                 window_s=2.5)
    record = {"kind": "archive", "window_s": 4.0, "card_trace": card,
              "batches": [{"src_bytes": 3_000_000},
                          {"src_bytes": 1_500_000}]}
    run = harness.Run(record, Bench(), "serf_archive.chorus", {}, {})
    assert Bench().reader("device_mb_s").read(run) == pytest.approx(3.0)
    assert Bench().reader("audio_mb_s.archive").read(run) == \
        pytest.approx(1.125)
    record["card_trace"] = Trace(window_s=4.0)
    assert Bench().reader("device_mb_s").read(run) is None


# A configuration of another kind, as a later change would add it: a runner
# whose items are seeded random rows, whose program is a torch product-sum
# and whose reference is a plain loop, with its own tally, limits, traffic,
# cell and end-to-end metric.
DOT_RUNNER = '''"""Product-sums of seeded random rows."""
import time

import numpy as np

PRECISION = "float64"
CONTROL = "float32"
NUMBERS = ("sum_err", "repeat_mismatch")


def make_items(traffic, seed, device):
    import torch
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    return [torch.randn(2, traffic["rows"], traffic["width"], generator=gen,
                        device=device).cpu().numpy()
            for _ in range(traffic["pool_items"])]


def reference(item, config, precision, device):
    t = np.dtype(precision).type
    out = []
    for a, b in zip(item[0], item[1]):
        s = t(0)
        for x, y in zip(a, b):
            s += t(x) * t(y)
        out.append(s)
    return np.array(out, np.float64)


class Tally:
    def __init__(self):
        self.err, self.items = 0.0, 0

    def add(self, prog, ref):
        self.items += 1
        d = np.abs(np.asarray(prog, np.float64) - ref).max()
        self.err = max(self.err, float(d / max(np.abs(ref).max(), 1e-12)))

    def numbers(self, repeat_mismatch=0):
        return {"sum_err": self.err, "repeat_mismatch": repeat_mismatch}

    def coverage(self):
        return {"items": self.items}


class Runner:
    kind = "dot"

    def __init__(self, config, device, torch):
        self.torch, self.device = torch, device

    def program(self, x):
        return (x[0] * x[1]).sum(-1)

    def warm(self, items, traffic, seed):
        self.program(self.torch.as_tensor(items[0], device=self.device))

    def window(self, items, traffic, seed, seconds, trace=False):
        first, compared, n, repeat = {}, [], 0, 0
        t0 = time.perf_counter()
        while n < len(items) or time.perf_counter() - t0 < seconds:
            k = n % len(items)
            out = self.program(self.torch.as_tensor(
                items[k], device=self.device)).cpu().numpy()
            if k in first:
                repeat += int(not np.array_equal(out, first[k]))
            else:
                first[k] = out
                compared.append((k, out))
            n += 1
        return {"kind": self.kind, "window_s": time.perf_counter() - t0,
                "trace": None, "compared": compared,
                "repeat_mismatch": repeat, "sums": n * items[0].shape[1],
                "attempted": n, "failed": 0}

    def devices(self):
        return [{"index": 0, "name": "cpu", "memory_peak_bytes": 0}]

    def close(self):
        pass
'''
DOT_CELL = "dot.small"
DOT_LIMITS = {"sum_err": 1e-5, "repeat_mismatch": 0}


def _copy_with_a_dot_cell(tmp_path):
    """A copy of the benchmark with the dot configuration added as new
    files and new entries; returns its root."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    here = root / "perfbench"
    new = {"runners/dot.py": DOT_RUNNER,
           "configs/dot.json": json.dumps({"name": "dot", "runner": "dot",
                                           "limits": DOT_LIMITS}),
           "traffic/small.json": json.dumps({"pool_items": 3, "rows": 8,
                                             "width": 64}),
           "metrics/sums_s.py": "def read(run):\n    return run.record["
                                "'sums'] / run.window_s\n"}
    for rel, text in new.items():
        assert not (here / rel).exists(), rel
        (here / rel).write_text(text)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "dot", "source": "a test",
                            "file": "perfbench/configs/dot.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": DOT_CELL, "config": "dot",
                              "traffic": "small", "chips": 1,
                              "why": "a test"})
    spec["end_to_end"].append({"name": "sums_s", "unit": "sums/s",
                               "better": "higher", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": [DOT_CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def _dot_runner(root):
    import torch
    bench = Bench(root)
    return bench.runner("dot").Runner(bench.config("dot"), "cpu", torch)


def test_a_configuration_of_another_kind_needs_no_edit(tmp_path):
    """Inputs, reference, tally and limits of a non-SERF configuration come
    from its own runner module: the harness runs it, in a copy where no
    file that was there changed, to a correct result; the same runner
    with its program perturbed is not correct."""
    root = _copy_with_a_dot_cell(tmp_path)
    for p in (ROOT / "perfbench").rglob("*"):
        if p.is_file() and "__pycache__" not in p.parts:
            rel = p.relative_to(ROOT)
            assert (root / rel).read_bytes() == p.read_bytes(), rel
    r = harness.run_cell(DOT_CELL, 2**31 + 13, 0.2, 0, time.monotonic(),
                         device="cpu", root=root)
    assert r["correct"], r["check"]
    assert list(r["check"]) == ["sum_err", "repeat_mismatch"]
    assert 0 < r["check"]["sum_err"]["value"] < 1e-6
    assert set(r["metrics"]) == {"sums_s", "setup_s"}
    assert r["diagnostics"]["coverage"] == {"items": 3}
    assert r["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                           "memory_peak_bytes": 0}

    drv = _dot_runner(root)
    exact = drv.program
    drv.program = lambda x: exact(x) * (1 + 1e-3)
    r = harness.run_cell(DOT_CELL, 2**31 + 13, 0.2, 0, time.monotonic(),
                         device="cpu", root=root, runner=drv)
    assert not r["correct"], r["check"]
    assert r["check"]["sum_err"]["value"] > 1e-4


def test_the_device_block_counts_every_card_the_runner_reports(tmp_path):
    """Two cards with different peaks: `count` 2, the fuller card's peak,
    the mean card's busy seconds."""
    root = _copy_with_a_dot_cell(tmp_path)
    drv = _dot_runner(root)
    cards = [{"index": 0, "name": "card", "memory_peak_bytes": 5 << 30,
              "busy_s": 1.0, "window_s": 6.0},
             {"index": 1, "name": "card", "memory_peak_bytes": 7 << 30,
              "busy_s": 3.0, "window_s": 6.0}]
    drv.devices = lambda: cards
    r = harness.run_cell(DOT_CELL, 2**31 + 17, 0.2, 1, time.monotonic(),
                         device="cpu", root=root, runner=drv)
    assert r["device"] == {"platform": "cpu", "kind": "card", "count": 2,
                           "memory_peak_bytes": 7 << 30, "busy_s": 2.0,
                           "window_s": 6.0}
    assert r["diagnostics"]["cards"] == cards
    assert harness.device_faults(cards, 2, 1) == []


CARD = {"name": "NVIDIA H100 80GB HBM3", "memory_peak_bytes": 1 << 30,
        "busy_s": 1.5, "window_s": 6.0}
BAD_CARDS = {
    "fewer_cards_than_chips": ([dict(CARD, index=0)], 4, 0),
    "more_cards_than_chips": ([dict(CARD, index=i) for i in range(2)], 1,
                              0),
    "mixed_names": ([dict(CARD, index=0),
                     dict(CARD, index=1, name="NVIDIA A100-SXM4-80GB")], 2,
                    0),
    "untraced_card_in_a_traced_run": (
        [dict(CARD, index=0),
         {"index": 1, "name": CARD["name"], "memory_peak_bytes": 1 << 30}],
        2, 1),
    "card_without_work": ([dict(CARD, index=0, memory_peak_bytes=0)], 1,
                          0),
}


@pytest.mark.parametrize("case", sorted(BAD_CARDS))
def test_the_device_check_refuses_cards_that_are_not_the_cells(case):
    cards, chips, trace = BAD_CARDS[case]
    assert harness.device_faults(cards, chips, trace)
    assert harness.device_faults(
        [dict(CARD, index=i) for i in range(chips)], chips, trace) == []
    if case == "untraced_card_in_a_traced_run":
        assert "busy_s" not in harness.device_block(cards, "cuda", trace)


def test_the_readings_take_the_control_from_the_runner(tmp_path):
    """`readings.control_numbers` runs the runner's reference at its
    `CONTROL` in the program's place, held against its `PRECISION`."""
    from perfbench import readings
    root = _copy_with_a_dot_cell(tmp_path)
    nums, cov = readings.control_numbers(Bench(root), DOT_CELL, 2**31 + 23,
                                         "cpu")
    assert list(nums) == ["sum_err", "repeat_mismatch"]
    assert nums["sum_err"] > 0 and cov == {"items": 3}


@pytest.mark.parametrize("limits", [{"sum_err": 1e-5},
                                    dict(DOT_LIMITS, wave5_err=1e-4)],
                         ids=["lacks_a_number", "names_another"])
def test_limits_that_do_not_name_the_tallys_numbers_raise(tmp_path,
                                                          limits):
    root = _copy_with_a_dot_cell(tmp_path)
    with pytest.raises(KeyError, match="sum_err.*repeat_mismatch"):
        harness.run_cell(DOT_CELL, 2**31 + 19, 0.1, 0, time.monotonic(),
                         device="cpu", root=root,
                         overrides={"config": {"limits": limits}})


def test_the_generic_modules_reach_no_serf_code():
    """harness.py, readings.py and run.py take inputs, reference and tally
    from the cell's runner module: they import neither the SERF reference
    nor its traffic, and name neither `check.Tally` nor `check.NUMBERS`."""
    import ast
    serf = {"perfbench.reference", "perfbench.reference.serf",
            "perfbench.traffic", "perfbench.synthetic"}
    for name in ("harness.py", "readings.py", "run.py"):
        path = ROOT / "perfbench" / name
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                assert not {a.name for a in node.names} & serf, name
            elif isinstance(node, ast.ImportFrom):
                assert node.module not in serf, name
                assert not (node.module == "perfbench" and {
                    a.name for a in node.names}
                    & {"reference", "traffic", "synthetic"}), name
            elif isinstance(node, ast.Attribute) and isinstance(
                    node.value, ast.Name) and node.value.id == "check":
                assert node.attr == "judge", (name, node.attr)
        assert '"count": 1' not in path.read_text(), name
