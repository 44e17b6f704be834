"""Execution plans: how a validated `PipelineGraph` runs on a batch stream.

This slice ports `TwoPhasePlan`, the single-stream default: detection ->
the host reads back the keep mask -> a padded survivor-index vector ->
the survivor tail on the device, which gathers the survivors out of the
still-resident batch. MMSE cost scales with surviving audio.

When the graph's post-removal chain is the canonical fused tail, `("mmse",)`
or `("hpf", "mmse")`, the survivor phase runs the fused tail kernel
(gather + [HPF] + STFT + MMSE gain in one pass, the iSTFT outside).
`fuse_tail=` overrides: None (default) engages it on a canonical tail,
False forces the staged per-stage path, True demands fusion and raises on
a non-canonical tail.

The port runs eagerly: no compile cache and no buffer donation. It runs on
one device, so the survivor batch is padded to no multiple (the reference's
`pad_multiple` is its device count) and with linear buckets, as the
reference's two_phase plan pads. The other plans of the reference (fused,
streaming, async, sharded, cached) are later slices.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from repro_torch.core import scheduler as SCHED
from repro_torch.core.graph import (GraphValidationError, PipelineGraph,
                                    PipelineOutput)
from repro_torch.device import resolve_device


@dataclass
class BatchResult:
    """One batch through a plan: compacted survivors + the detection record."""
    cleaned: np.ndarray             # (n_kept, S_final) denoised survivors
    det: PipelineOutput             # detection-phase record (masks, stats)
    n_kept: int
    wid: object = None              # loader work id (when run over a stream)
    labels: object = field(default=None, repr=False)   # stream passthrough
    src_bytes: int = 0              # input bytes (throughput accounting)
    timings: dict = field(default=None, repr=False)
    # per-batch instrumentation, the reference's keys:
    #   readback_s  blocking keep-mask readback (waits for detection)
    #   compact_s   host index bookkeeping
    #   tail_s      tail enqueue
    #   emit_s      blocking cleaned readback (waits for the tail)
    #   d2h_bytes / h2d_bytes   host-boundary traffic this batch caused
    #   tail_rows / n_real      padded tail batch rows vs real survivors
    #   wave5_bytes, old_boundary_bytes   the full pre-denoise batch and
    #               what a host-side compaction round trip would have moved


def _iter_batches(batches):
    """Normalise a batch stream: accepts arrays, (chunks, labels) pairs, or
    (wid, (chunks, labels)) items."""
    for i, item in enumerate(batches):
        wid, payload, extra = i, item, None
        if isinstance(item, tuple) and len(item) == 2 \
                and np.ndim(item[0]) == 0:
            wid, payload = item
        if isinstance(payload, tuple):
            chunks = payload[0]
            extra = payload[1] if len(payload) > 1 else None
        else:
            chunks = payload
        yield wid, chunks, extra


class TwoPhasePlan:
    name = "two_phase"

    def __init__(self, graph: PipelineGraph, fuse_tail=None, device=None):
        if not graph.has_removal_point:
            raise GraphValidationError(
                f"plan '{self.name}' needs a 'removal_point' stage in the "
                f"graph (stages: {graph.names})")
        self.graph = graph
        self.device = resolve_device(device)
        spec = graph.fused_tail_spec
        if fuse_tail is None:
            fuse_tail = spec is not None
        elif fuse_tail and spec is None:
            raise GraphValidationError(
                f"fuse_tail=True but post-removal stages "
                f"{graph.names[graph._cut():]} are not the canonical "
                f"[hpf ->] mmse fused tail")
        self.fuse_tail = bool(fuse_tail)

    def _to_device(self, audio):
        return torch.as_tensor(np.asarray(audio, np.float32)).to(self.device)

    def detect(self, audio) -> PipelineOutput:
        return self.graph.detection(self._to_device(audio))

    def _finish(self, det: PipelineOutput, src_bytes=0) -> BatchResult:
        t0 = time.perf_counter()
        keep = det.keep.cpu().numpy()                 # the only readback
        t1 = time.perf_counter()
        idx, n_real = SCHED.survivor_indices(keep, 1, "linear")
        t2 = time.perf_counter()
        out, h2d = None, 0
        if n_real:
            idx_t = torch.from_numpy(idx).to(self.device)
            tail = (self.graph.tail_indexed_fused if self.fuse_tail
                    else self.graph.tail_indexed)
            out = tail(det.wave5, idx_t)
            h2d = idx.nbytes
        t3 = time.perf_counter()
        wave5 = det.wave5
        timings = dict(
            readback_s=t1 - t0, compact_s=t2 - t1, tail_s=t3 - t2,
            h2d_bytes=h2d, d2h_bytes=keep.nbytes,
            tail_rows=0 if idx is None else len(idx), n_real=n_real,
            wave5_bytes=wave5.numel() * wave5.element_size())
        if out is None:
            cleaned = np.zeros((0, wave5.shape[-1]), np.float32)
        else:
            cleaned = out[:n_real].cpu().numpy()
            timings["d2h_bytes"] += cleaned.nbytes
        timings["emit_s"] = time.perf_counter() - t3
        # what the reference's host-side compaction round trip would have
        # moved: the full wave5 and mask down, survivors up, cleaned down
        timings["old_boundary_bytes"] = (
            timings["wave5_bytes"] + keep.size + 2 * cleaned.nbytes)
        return BatchResult(cleaned=cleaned, det=det, n_kept=n_real,
                           src_bytes=src_bytes, timings=timings)

    def __call__(self, audio) -> BatchResult:
        x = self._to_device(audio)
        return self._finish(self.graph.detection(x),
                            src_bytes=x.numel() * x.element_size())

    def run(self, batches):
        for wid, chunks, extra in _iter_batches(batches):
            yield replace(self(chunks), wid=wid, labels=extra)


PLANS = {p.name: p for p in (TwoPhasePlan,)}


class Preprocessor:
    """The facade every entry point uses.

        pre = Preprocessor(SERF_AUDIO, plan="two_phase")      # on the card
        pre = Preprocessor(SERF_AUDIO, device="cpu")          # plain versions
        for res in pre.run(stream):
            use(res.cleaned, res.det.stats, res.n_kept)

    `plan` is a name from `PLANS` or a plan class; `stages` overrides the
    config-declared stage list (ablations, or the `("hpf", "mmse")` tail).
    Extra keyword arguments go to the plan (e.g. `fuse_tail=False`).
    `device=None` means the CUDA card and raises when there is none.
    """

    def __init__(self, cfg, plan="two_phase", stages=None, device=None,
                 **plan_kwargs):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.graph = PipelineGraph(cfg, stages)
        plan_cls = PLANS[plan] if isinstance(plan, str) else plan
        self.plan = plan_cls(self.graph, device=self.device, **plan_kwargs)

    def __call__(self, audio) -> BatchResult:
        """One batch of (B, C, S_long_src) long chunks -> BatchResult."""
        return self.plan(audio)

    def run(self, batches):
        """Iterate BatchResults over a batch stream."""
        return self.plan.run(batches)
