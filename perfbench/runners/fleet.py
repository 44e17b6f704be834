"""A batch job over the paper's master-slave fleet: `ShardedPlan`'s process
mode, one worker process a card.

The program is built as `python -m repro_torch.launch.preprocess --plan
sharded --transport proc --shards N` builds it (its construction copied:
`make_local_mesh()`, `pool_rules(shards, mesh)`, `pad_multiple=mesh.size()`),
with the plan and its arguments from the configuration's "deployment". One
run of the plan spans the set-up and the window:

  warm    spawns the workers and passes every batch of the pool through
          them, until each worker has computed `WARM_ITEMS` items, then
          marks a short part to every worker and ends it (a worker's first
          profile pays the profiler's start): no spawn and no first call
          falls inside the window
  window  continues the same run for `seconds`, drawn from a sized leased
          queue that cycles the pool (`QUEUE_ITEMS` work ids, the
          launcher's `make_shard_pool`), the master feeding whatever the
          workers lease; then it marks the part's end, drains every worker
          (`FleetControl.drain_all`: each signs off through `bye`) and
          closes the run, which leaves no worker process

The runner marks the measured part to every worker (`FleetControl.mark`):
untraced, the whole window, in which each worker records its card alone
("card_trace": `CardTraces`, whose `busy_s()` is the mean card's busy
seconds, and "batches": the items the cards computed in it), so that
`device_mb_s` reads the fleet's rate once every card is fed; traced, the
last `TRACE_S` seconds (wall clock), with the workers' spans and the
master's `serve_fetch` spans ("spans", the master's tracer) beside the
cards ("trace").

The cell's inputs and reference are the SERF pipeline's
(`traffic.make_items`, `reference.serf.run`); its tally is `check.Tally`'s
comparisons without `wave5`, which a fleet's result does not carry
(`dist/service.py` `pack_result`), and with `emit_mismatch`: work ids of
the run emitted twice, missing or out of ascending order.
"""
from __future__ import annotations

import time

import numpy as np

from perfbench import check
from perfbench.reference import serf
from perfbench.trace import Interval, Trace
from perfbench.traffic import make_items  # noqa: F401

PRECISION = "f32"       # the reference's: float32 with TF32 off
CONTROL = "tf32"        # the control's: the step below it
NUMBERS = ("mask_mismatch", "cleaned_err", "cleaned_rms", "repeat_mismatch",
           "emit_mismatch")

TRACE_S = 6.0           # seconds at the window's end that a traced run
#                         records
SAMPLE_LATER = 8        # later occurrences compared, besides each item's
#                         first in the window
WARM_ITEMS = 2          # items each worker computes in set-up, at least
QUEUE_ITEMS = 200_000   # work ids of the run's queue: more than any window
#                         takes
DRAIN_S = 300.0         # the longest wait for the workers' sign-off


def reference(item, config, precision, device):
    """The plain reference on one item at `precision`."""
    return serf.run(item, config["pipeline"], precision, device=device)


class Tally(check.Tally):
    """`check.Tally` without `wave5_err`, with `emit_mismatch`. `numbers`
    takes the run's own counts, the record's "repeat_mismatch":
    {"repeat_mismatch", "emit_mismatch"} (none for the control)."""

    def add(self, prog, ref):
        super().add({k: v for k, v in prog.items() if k != "wave5"}, ref)

    def numbers(self, counts=None):
        counts = counts or {}
        out = super().numbers(counts.get("repeat_mismatch", 0))
        del out["wave5_err"]
        out["emit_mismatch"] = counts.get("emit_mismatch", 0)
        return out


def card_trace(parts):
    """One card's `Trace` from the parts its workers recorded (`bye`'s
    "part": the union of its device operations on the profiler's clock
    and the part's host seconds): its busy seconds are the union's, its
    window the longest part."""
    ivs = [Interval("busy", s, e) for p in parts for s, e in p["busy"]]
    start = min((iv.start for iv in ivs), default=0.0)
    span = max((iv.end for iv in ivs), default=start) - start
    return Trace(device=ivs, start=start,
                 window_s=max([span] + [p["window_s"] for p in parts]))


class CardTraces:
    """The cards of a fleet read as one: `device` every card's operations,
    `busy_s()` and `window_s` the mean card's (as `harness.device_block`
    takes the mean card), `cards` {index: Trace}; `device_ops` the
    operation names that took most device time over the cards, and
    `idle_gaps` each card's seconds with no operation."""

    def __init__(self, cards, ops=None):
        self.cards = cards
        self.device = [iv for t in cards.values() for iv in t.device]
        self.window_s = (sum(t.window_s for t in cards.values())
                         / max(1, len(cards)))
        self.ops = ops or {}

    def busy_s(self):
        if not self.cards:
            return 0.0
        return sum(t.busy_s() for t in self.cards.values()) / len(self.cards)

    def device_ops(self, n=10):
        return [[k[:120], v] for k, v in
                sorted(self.ops.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n=10):
        return [[f"card {i}: no device operation", t.window_s - t.busy_s()]
                for i, t in sorted(self.cards.items())][:n]


def _require_card_reports():
    """Raise where the program's workers cannot report their card or
    follow a marked part: before anything is spawned, so that such a
    program fails at once."""
    from repro_torch import device
    from repro_torch.core.plans import FleetControl
    lacks = [name for name, there in (
        ("device.card_record", hasattr(device, "card_record")),
        ("FleetControl.mark", hasattr(FleetControl, "mark")),
        ("FleetControl.drain_all", hasattr(FleetControl, "drain_all")))
        if not there]
    if lacks:
        raise RuntimeError(f"the program's workers cannot report their "
                           f"cards: it lacks {', '.join(lacks)}")


class Runner:
    kind = "fleet"

    def __init__(self, config, device, torch):
        _require_card_reports()
        import torch.distributed as dist

        from repro_torch.configs.serf_audio import AudioPipelineConfig
        from repro_torch.core.plans import Preprocessor
        from repro_torch.distributed.sharding import pool_rules
        from repro_torch.launch.mesh import make_local_mesh

        self.torch = torch
        self.dist = dist
        self.pipeline = config["pipeline"]
        dep = config["deployment"]
        kwargs = dict(dep.get("plan_kwargs", {}))
        cfg = AudioPipelineConfig(**{
            k: tuple(v) if isinstance(v, list) else v
            for k, v in self.pipeline.items()})
        dev = None if device == "cuda" else device
        self.own_group = not dist.is_initialized()
        mesh = make_local_mesh(device=dev)
        self.shards = int(kwargs["shards"])
        self.transport = kwargs.get("transport", "inproc")
        self.pre = Preprocessor(cfg, pool_rules(self.shards, mesh),
                                plan=dep["plan"], pad_multiple=mesh.size(),
                                device=dev, **kwargs)
        self.cuda = self.pre.device.type == "cuda"
        self.gen = None         # the run of the plan, set-up and window
        self.reports = []       # (shard, bye's stats) of the last run
        self.cards = None       # CardTraces of the last run's marked part
        self.traced = False

    # -- the run ----------------------------------------------------------
    def warm(self, items, traffic, seed):
        """Spawn the fleet and pass every pool batch through it, until
        every worker has computed `WARM_ITEMS` items."""
        from repro_torch.data.loader import make_shard_pool
        plan = self.pre.plan
        n = self.n = len(items)
        pool = make_shard_pool(
            lambda wid: items[wid % n], QUEUE_ITEMS, self.shards,
            lease_items=plan.lease_items,
            lease_timeout_s=plan.default_lease_timeout(self.transport))
        self.next_wid = 0
        self.emit_mismatch = 0
        self.repeat_mismatch = 0
        self.first_kept = {}
        self.gen = self.pre.run(pool)
        self.warm_s = []
        t = time.perf_counter()
        for res in self.gen:
            self._emitted(res)
            self.warm_s.append(time.perf_counter() - t)
            t = time.perf_counter()
            if self.next_wid >= n and self._each_worker_warm():
                break
        else:
            raise RuntimeError("the fleet's run ended in set-up")
        # a worker's first recorded part pays the profiler's own start
        # (seconds: CUPTI's), which one short part here keeps out of the
        # window
        for on in (True, False):
            self._pass_mark(on)

    def _pass_mark(self, on):
        """Mark a part's start or end, and run on until every worker has
        computed two items since: each has then acted on it."""
        fleet = self.pre.plan.fleet
        workers = fleet.service.workers
        base = {w: st.chunks_done for w, st in workers.items()}
        fleet.mark(on)
        for res in self.gen:
            self._emitted(res)
            if all(workers[w].chunks_done >= k + 2 for w, k in base.items()):
                return
        raise RuntimeError("the fleet's run ended in set-up")

    def _each_worker_warm(self):
        done = [st.chunks_done for st in
                self.pre.plan.fleet.service.workers.values()]
        return len(done) >= self.shards and min(done) >= WARM_ITEMS

    def _emitted(self, res):
        """Exactly once, in ascending work id: every id of the run counted
        as it is emitted; and each pool item's survivor count against its
        first pass."""
        wid = int(res.wid)
        if wid == self.next_wid:
            self.next_wid += 1
        elif wid > self.next_wid:          # ids skipped: missing
            self.emit_mismatch += wid - self.next_wid
            self.next_wid = wid + 1
        else:                              # emitted twice or out of order
            self.emit_mismatch += 1
        k = wid % self.n
        if k in self.first_kept:
            self.repeat_mismatch += int(res.n_kept) != self.first_kept[k]
        else:
            self.first_kept[k] = int(res.n_kept)

    def window(self, items, traffic, seed, seconds, trace=False):
        """Continue the run for `seconds`, then drain and close it; returns
        the run's record."""
        from repro_torch.obs import tracing as obs_tracing
        fleet = self.pre.plan.fleet
        rng = np.random.default_rng([int(seed) % 2**63, 2])
        n = self.n
        firsts, reservoir, seen_later = {}, [], 0
        emitted = []
        t_trace = max(0.0, seconds - TRACE_S) if trace else None
        tracer = prev = None
        if not trace:
            fleet.mark(True)
        t0 = time.perf_counter()
        try:
            for res in self.gen:
                self._emitted(res)
                emitted.append(int(res.src_bytes))
                k = int(res.wid) % n
                if k not in firsts:
                    firsts[k] = check.program_arrays(res.det, res.cleaned)
                else:
                    # reservoir sample of the later occurrences
                    seen_later += 1
                    if len(reservoir) < SAMPLE_LATER:
                        reservoir.append((k, check.program_arrays(
                            res.det, res.cleaned)))
                    else:
                        j = int(rng.integers(0, seen_later))
                        if j < SAMPLE_LATER:
                            reservoir[j] = (k, check.program_arrays(
                                res.det, res.cleaned))
                el = time.perf_counter() - t0
                if t_trace is not None and tracer is None and el >= t_trace:
                    prev = obs_tracing.get_tracer()
                    tracer = obs_tracing.Tracer()
                    obs_tracing.set_tracer(tracer)
                    fleet.mark(True, spans=True)
                if el >= seconds:
                    break
            else:
                raise RuntimeError("the fleet's queue ran out in the window")
            t1 = time.perf_counter()
            fleet.mark(False)
            self._close_run()
        finally:
            if tracer is not None:
                obs_tracing.set_tracer(prev)
        self.traced = bool(trace)
        parts = [(shard, rep["part"]) for shard, rep in self.reports
                 if "part" in rep]
        cards = self.cards = self._cards(parts)
        record = {"kind": self.kind, "window_s": t1 - t0,
                  "warm_batch_s": self.warm_s,
                  "batches": [{"src_bytes": b} for _, p in parts
                              for _, b in p["batches"]],
                  "emitted": emitted,
                  "trace": cards if trace else None,
                  "card_trace": None if trace else cards,
                  "spans": list(tracer.events) if tracer is not None
                  else [],
                  "compared": list(firsts.items()) + reservoir,
                  "repeat_mismatch": {
                      "repeat_mismatch": self.repeat_mismatch,
                      "emit_mismatch": self.emit_mismatch},
                  "attempted": len(emitted), "failed": 0}
        return record

    def _close_run(self):
        """Drain every worker (each signs off with its card and its part),
        then close the run: the plan's own teardown, which leaves no
        worker process."""
        plan = self.pre.plan
        gen, self.gen = self.gen, None
        try:
            signed_off = plan.fleet.drain_all(DRAIN_S)
        finally:
            gen.close()
        if not signed_off:
            raise RuntimeError(f"a worker did not sign off within "
                               f"{DRAIN_S:.0f} s of the drain")
        self.reports = [(st.shard, st.report) for st in plan.worker_stats
                        if st.report is not None]

    def _key(self, shard, card):
        """A card's key among the records: its index, or, on the CPU,
        the worker's own (each CPU worker its own record)."""
        return card["index"] if card["index"] is not None else shard

    def _cards(self, parts):
        """The marked part of every card as `CardTraces`."""
        by_card, ops = {}, {}
        card_of = {shard: rep["card"] for shard, rep in self.reports
                   if "card" in rep}
        for shard, part in parts:
            if shard not in card_of:
                continue
            by_card.setdefault(self._key(shard, card_of[shard]),
                               []).append(part)
            for name, s in part.get("ops", {}).items():
                ops[name] = ops.get(name, 0.0) + s
        return CardTraces({k: card_trace(v) for k, v in by_card.items()},
                          ops)

    def devices(self):
        """One record a card the workers of the last run reported in their
        `bye` (a CPU rehearsal: one a worker): its name, the largest peak
        of its workers' allocated memory and, where the last window was
        traced, its busy seconds and window in the traced part."""
        out = {}
        for shard, rep in self.reports:
            card = rep.get("card")
            if card is None:
                continue
            key = self._key(shard, card)
            rec = out.setdefault(key, {"index": key, "name": card["name"],
                                       "memory_peak_bytes": 0})
            rec["memory_peak_bytes"] = max(rec["memory_peak_bytes"],
                                           int(card["memory_peak_bytes"]))
        if self.traced:
            for key, tr in self.cards.cards.items():
                if key in out:
                    out[key].update(busy_s=tr.busy_s(), window_s=tr.window_s)
        return [out[k] for k in sorted(out)]

    def close(self):
        if self.gen is not None:
            gen, self.gen = self.gen, None
            gen.close()
        self.pre = None
        if self.own_group and self.dist.is_initialized():
            self.dist.destroy_process_group()
        if self.cuda:
            self.torch.cuda.synchronize()
            self.torch.cuda.empty_cache()
