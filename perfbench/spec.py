"""Finding a cell's files by the names in `BENCHMARK.json`.

  configs/<config>.json        the configuration as it is run; its
                               "runner" names runners/<runner>.py
  traffic/<traffic>.json       the traffic mix's parameters
  metrics/<metric>.py          one reader a metric: `read(run)` returns a
                               number, or None where it finds nothing
  roofline/<kernel>.py         one counter a hand kernel

A cell reports the end-to-end metrics that list it under "workloads" (or
that list none), and the per-layer metrics that list it (or that list
none and move an end-to-end metric the cell reports).

A runner module holds all that is particular to a kind of configuration;
the harness (`harness.run_cell`, `readings.py`) calls only these:

  make_items(traffic, seed, device)   the cell's inputs from the seed: a
                                      list the window draws from
  reference(item, config, precision, device)
                                      the plain reference's answer on one
                                      item, at `PRECISION` (what the
                                      configuration states) or `CONTROL`
                                      (the step below, for the control)
  Tally()                             `add(program, reference)` one
                                      compared answer, `numbers(
                                      repeat_mismatch)` the dict of
                                      numbers compared, `coverage()` what
                                      they covered
  NUMBERS                             the names `numbers` gives; the
                                      configuration's "limits" name these
                                      and no others (`check.judge`)
  Runner(config, device, torch)       the program: `warm(items, traffic,
                                      seed)`, `window(items, traffic, seed,
                                      seconds, trace)` -> the record the
                                      readers read ("kind", "window_s",
                                      "trace", "compared" as [(item index,
                                      program answer)], "repeat_mismatch",
                                      "attempted", "failed"), `devices()`,
                                      `close()`

`devices()` gives one record a card that did work in the window, gathered
from whatever processes ran there: {"index", "name", "memory_peak_bytes"},
and "busy_s" and "window_s" where that card was traced. The result's
`device` is built from them (`harness.device_block`), and `run.py` prints
no result where they are not the cell's (`harness.device_faults`).
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_module(path: Path, name: str):
    """Import a file of the benchmark by its path (metric names hold
    dots, which `import` cannot name)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """`BENCHMARK.json` and the files it names, under `root`."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.here = self.root / "perfbench"
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name):
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name):
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name):
        return json.loads((self.here / "traffic" / f"{name}.json")
                          .read_text())

    def runner(self, name):
        return load_module(self.here / "runners" / f"{name}.py",
                           f"perfbench_runner_{name}")

    def reader(self, metric):
        return load_module(self.here / "metrics" / f"{metric}.py",
                           f"perfbench_metric_{metric.replace('.', '_')}")

    def end_to_end(self, cell):
        return [m for m in self.spec["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell):
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]

    def rooflines(self):
        """kernel name -> its counter module, for every file under
        roofline/."""
        return {p.stem: load_module(p, f"perfbench_roofline_{p.stem}")
                for p in sorted((self.here / "roofline").glob("*.py"))
                if not p.name.startswith("_")}
