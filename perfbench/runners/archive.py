"""An archive job: `Preprocessor.run` over a closed loop of batches.

The program is built as `python -m repro_torch.launch.preprocess` builds
it (its construction copied: `make_local_mesh`, `ShardingRules(mesh)`,
`pad_multiple=mesh.size()`), with the plan and its arguments from the
configuration's "deployment". The window cycles through the traffic's
pool of batches; the job takes its next batch as soon as the plan yields
the last one.

The cell's inputs, reference and check are the SERF pipeline's:
`traffic.make_items`, `reference.serf.run` and `check.Tally`.
"""
from __future__ import annotations

import time

import numpy as np

from perfbench import check
from perfbench.check import NUMBERS, Tally  # noqa: F401
from perfbench.reference import serf
from perfbench.trace import Profiler
from perfbench.traffic import make_items  # noqa: F401

PRECISION = "f32"       # the reference's: float32 with TF32 off
CONTROL = "tf32"        # the control's: the step below it

TRACE_S = 6.0           # seconds at the window's end that a traced run
#                         profiles
SAMPLE_LATER = 8        # later occurrences compared, besides each item's
#                         first


def reference(item, config, precision, device):
    """The plain reference on one item at `precision`."""
    return serf.run(item, config["pipeline"], precision, device=device)


class Runner:
    kind = "archive"

    def __init__(self, config, device, torch):
        import torch.distributed as dist

        from repro_torch.configs.serf_audio import AudioPipelineConfig
        from repro_torch.core.plans import Preprocessor
        from repro_torch.distributed.sharding import ShardingRules
        from repro_torch.launch.mesh import make_local_mesh

        if device == "cuda":
            # the peak counts from the program's set-up on, not the inputs'
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        self.torch = torch
        self.dist = dist
        self.trace = None
        self.pipeline = config["pipeline"]
        dep = config["deployment"]
        cfg = AudioPipelineConfig(**{
            k: tuple(v) if isinstance(v, list) else v
            for k, v in self.pipeline.items()})
        dev = None if device == "cuda" else device
        self.own_group = not dist.is_initialized()
        mesh = make_local_mesh(device=dev)
        pad = mesh.size()
        rules = ShardingRules(mesh)
        self.pre = Preprocessor(cfg, rules, plan=dep["plan"],
                                pad_multiple=pad, device=dev,
                                **dep.get("plan_kwargs", {}))
        self.cuda = self.pre.device.type == "cuda"
        self.index = torch.cuda.current_device() if self.cuda else 0

    def _sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def warm(self, items, traffic, seed):
        """Every batch of the pool once: every shape the window meets."""
        t = time.perf_counter()
        self.warm_s = []
        for _ in self.pre.run(list(enumerate(items))):
            self._sync()
            self.warm_s.append(time.perf_counter() - t)
            t = time.perf_counter()

    def _facts(self, res, chunks):
        plan = self.pre.plan
        return {"pipeline": self.pipeline, "rows": chunks.shape[0],
                "samples": chunks.shape[-1],
                "final_rows": int(res.det.keep.shape[0]),
                "final_samples": int(res.det.wave5.shape[-1]),
                "n_real": int(res.n_kept),
                "tail_rows": int((res.timings or {}).get("tail_rows", 0)),
                "fuse_tail": bool(getattr(plan, "fuse_tail", False))}

    def window(self, items, traffic, seed, seconds, trace=False):
        """Run the closed loop for `seconds`; returns the run's record.
        Traced, the profiler records the last `TRACE_S` seconds, host and
        card; untraced, it records the card alone over the whole window
        ("card_trace")."""
        from repro_torch import kernels
        profiler = Profiler(self.torch) if trace else None
        card = None if trace else Profiler(self.torch, host=False)
        rng = np.random.default_rng([int(seed) % 2**63, 2])
        n = len(items)
        t_trace = None if profiler is None else \
            max(0.0, seconds - TRACE_S)
        state = {"traced_from": None, "traced_to": None}
        launches0 = {}

        def stream():
            i = 0
            while True:
                el = time.perf_counter() - t0
                if el >= seconds:
                    return
                if t_trace is not None and state["traced_from"] is None \
                        and el >= t_trace:
                    launches0.update(kernels.launches())
                    profiler.start()
                    state["traced_from"] = i
                yield i, items[i % n]
                i += 1

        batches, samples, first_kept = [], {}, {}
        reservoir, seen_later = [], 0
        repeat_mismatch = 0
        if card is not None:
            card.start()
        self._sync()
        t0 = time.perf_counter()
        for res in self.pre.run(stream()):
            i = res.wid
            t = res.timings or {}
            rec = {"src_bytes": int(res.src_bytes), "n_kept": int(res.n_kept),
                   "readback_s": t.get("readback_s"),
                   "tail_s": t.get("tail_s"), "emit_s": t.get("emit_s"),
                   "traced": state["traced_from"] is not None}
            if rec["traced"]:
                rec["facts"] = self._facts(res, items[i % n])
            batches.append(rec)
            k = i % n
            if i < n:
                first_kept[k] = int(res.n_kept)
                samples[i] = (k, check.program_arrays(res.det, res.cleaned))
                continue
            repeat_mismatch += int(res.n_kept) != first_kept[k]
            seen_later += 1
            # reservoir sample of the later occurrences
            if len(reservoir) < SAMPLE_LATER:
                reservoir.append((i, k, check.program_arrays(res.det,
                                                            res.cleaned)))
            else:
                j = int(rng.integers(0, seen_later))
                if j < SAMPLE_LATER:
                    reservoir[j] = (i, k, check.program_arrays(
                        res.det, res.cleaned))
        self._sync()
        t1 = time.perf_counter()
        if card is not None:
            card.stop()
        if profiler is not None and state["traced_from"] is not None:
            profiler.stop()
            state["traced_to"] = len(batches)
        self.trace = profiler.trace() if state["traced_to"] else None
        after = kernels.launches()
        compared = [(k, arr) for k, arr in samples.values()] + \
            [(k, arr) for _, k, arr in reservoir]
        return {"kind": self.kind, "window_s": t1 - t0,
                "warm_batch_s": self.warm_s,
                "trace": self.trace,
                "card_trace": None if card is None else card.trace(),
                "batches": batches, "compared": compared,
                "repeat_mismatch": repeat_mismatch,
                "launches": {k: after[k] - launches0.get(k, after[k])
                             for k in after} if launches0 else {},
                "attempted": len(batches), "failed": 0}

    def devices(self):
        """The one card the program ran on (the CPU in a rehearsal): its
        name, its peak of allocated memory from set-up on, and, where the
        last window was traced, its busy seconds in the traced part."""
        torch = self.torch
        card = {"index": self.index, "name": "cpu", "memory_peak_bytes": 0}
        if self.cuda:
            card.update(name=torch.cuda.get_device_name(self.index),
                        memory_peak_bytes=int(
                            torch.cuda.max_memory_allocated(self.index)))
        if self.trace is not None:
            card.update(busy_s=self.trace.busy_s(),
                        window_s=self.trace.window_s)
        return [card]

    def close(self):
        cuda = self.cuda
        self.pre = None
        if self.own_group and self.dist.is_initialized():
            self.dist.destroy_process_group()
        if cuda:
            self.torch.cuda.synchronize()
            self.torch.cuda.empty_cache()
