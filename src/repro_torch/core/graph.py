"""Composable stage graph for the preprocessing pipeline.

The stage order is data: `AudioPipelineConfig.stages` names a sequence of
registered stages, and `PipelineGraph` builds and shape-validates the chain
at construction time, before any audio runs.

  * `Stage` — a named, config-carrying transform over a `state` dict of
    batched tensors. Each stage declares what fields it needs (wave / spec
    / power / masks) and how it changes the chunk geometry, so an ill-typed
    order raises `GraphValidationError` at build time.
  * `STAGES` — the registry; configs refer to stages by name.
  * `PipelineGraph` — validates the chain, records `removal_point` markers
    and exposes `detection` (up to the first removal point), the survivor
    phase (`tail`, `tail_indexed`, `tail_indexed_fused`), the whole chain
    with removed chunks masked (`fused`), and its `fingerprint`. Each entry
    point takes the sharding `rules` (`NULL_RULES` by default); under rules
    with a mesh it runs the rank's rows and returns DTensors (section
    "mesh" below). Each stage's enqueue is an `obs.tracing` span,
    `stage.<name>`, and the gathering of a phase's outputs one more,
    `outputs`.

State fields carried between stages:
  wave            (B, S) mono, or (B, C, S) stereo before `to_mono`
  spec, power     (B, F, K) current-granularity spectra (power is
                  pre-band-stop: indices see raw spectra)
  indices         lazily computed acoustic-index dict, shared by detectors
  rain, silence   (B,) per-chunk removal masks (repeated across splits)
  cicada          (B,) detection-granularity cicada mask (diagnostic)
  keep            (B,) frozen at the removal point

Mask semantics follow the paper: cicada gates on ~rain, silence gates on
~rain, keep = ~rain & ~silence.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from repro_torch.core import detect as D
from repro_torch.core import indices as I
from repro_torch.core import stages as S
from repro_torch.distributed.sharding import NULL_RULES, whole
from repro_torch.kernels.fused_tail import ops as fused_tail_ops
from repro_torch.kernels.fused_tail.ref import gather_rows
from repro_torch.obs import tracing as obs_tracing


class GraphValidationError(ValueError):
    """A stage list that cannot execute: unknown stage, geometry mismatch,
    or a stage whose inputs are not produced upstream."""


@dataclass(frozen=True)
class ChunkGeom:
    """Chunk geometry flowing through the graph."""
    split_s: float      # seconds of audio per chunk
    rate_hz: int        # sample rate
    channels: int       # 2 = stereo source, 1 = mono


@dataclass(frozen=True)
class _ValidState:
    """Build-time twin of the runtime state dict: geometry + which state
    fields exist at this point in the chain."""
    geom: ChunkGeom
    has: frozenset


@dataclass
class PipelineOutput:
    wave5: torch.Tensor         # (N5, S5) processed final chunks
    keep: torch.Tensor          # (N5,) bool — survives to output
    rain: torch.Tensor          # (N5,) bool
    silence: torch.Tensor       # (N5,) bool
    cicada15: torch.Tensor      # (N15,) bool — per detect chunk
    stats: dict


# --------------------------------------------------------------- registry

STAGES: dict[str, type] = {}


def register(cls):
    """Register a Stage class under its `name` for config-by-name lookup."""
    if cls.name in STAGES:
        raise ValueError(f"duplicate stage name {cls.name!r}")
    STAGES[cls.name] = cls
    return cls


class Stage:
    """One named pipeline transform. Subclasses set `name`, implement
    `check` (build time: validate and advance the _ValidState) and `apply`
    (run time: transform the state dict)."""
    name: str = ""
    removal_point = False

    def __init__(self, cfg):
        self.cfg = cfg

    def _need(self, vs: _ValidState, *fields):
        missing = [f for f in fields if f not in vs.has]
        if missing:
            raise GraphValidationError(
                f"stage '{self.name}' needs {missing} which no upstream "
                f"stage provides (available: {sorted(vs.has)})")

    def check(self, vs: _ValidState) -> _ValidState:
        return vs

    def apply(self, state: dict, rules) -> dict:
        return state


def _indices(state, cfg):
    """Acoustic indices over the current power spectra, computed once and
    shared by every detector stage."""
    if "indices" not in state:
        state["indices"] = I.all_indices(state["power"], cfg)
    return state["indices"]


_MASK_KEYS = ("rain", "silence", "keep")


# ----------------------------------------------------------------- stages

@register
class ToMono(Stage):
    name = "to_mono"

    def check(self, vs):
        self._need(vs, "wave")
        if vs.geom.channels < 2:
            raise GraphValidationError(
                "stage 'to_mono' expects multi-channel input "
                f"(got {vs.geom.channels} channel)")
        return replace(vs, geom=replace(vs.geom, channels=1))

    def apply(self, state, rules):
        state["wave"] = rules.constrain(S.to_mono(state["wave"]),
                                        "chunks", None)
        return state


@register
class Compress(Stage):
    """Fused downsample + high-pass (one band-pass FIR)."""
    name = "compress"

    def check(self, vs):
        self._need(vs, "wave")
        if vs.geom.channels != 1:
            raise GraphValidationError(
                "stage 'compress' needs mono audio — add 'to_mono' first")
        if vs.geom.rate_hz != self.cfg.source_rate_hz:
            raise GraphValidationError(
                f"stage 'compress' expects {self.cfg.source_rate_hz} Hz "
                f"input, got {vs.geom.rate_hz} Hz (already compressed?)")
        return replace(vs, geom=replace(vs.geom,
                                        rate_hz=self.cfg.target_rate_hz))

    def apply(self, state, rules):
        state["wave"] = S.compress(state["wave"], self.cfg)
        return state


class _Split(Stage):
    """(B, S) -> (B*n, S/n). Repeats per-chunk masks, regroups the shared
    power spectra and drops the now-stale complex spectra + index vector."""
    target_split_s: float = 0.0

    def check(self, vs):
        self._need(vs, "wave")
        if vs.geom.channels != 1:
            raise GraphValidationError(
                f"stage '{self.name}' needs mono audio")
        factor = vs.geom.split_s / self.target_split_s
        if abs(factor - round(factor)) > 1e-9 or round(factor) < 1:
            raise GraphValidationError(
                f"stage '{self.name}' cannot split {vs.geom.split_s:g} s "
                f"chunks into {self.target_split_s:g} s chunks "
                f"(non-integer factor {factor:g})")
        self.n_sub = int(round(factor))
        return replace(vs, geom=replace(vs.geom,
                                        split_s=self.target_split_s),
                       has=vs.has - {"spec", "indices"})

    def apply(self, state, rules):
        n = self.n_sub
        pre_samples = state["wave"].shape[1]
        state["wave"] = rules.constrain(S.split(state["wave"], n),
                                        "chunks", None)
        for k in _MASK_KEYS:
            if k in state:
                state[k] = torch.repeat_interleave(state[k], n)
        if "power" in state:
            state["power"] = S.group_frames(state["power"], n,
                                            pre_samples, self.cfg)
        state.pop("spec", None)
        state.pop("indices", None)
        return state


@register
class SplitDetect(_Split):
    name = "split_detect"

    def __init__(self, cfg):
        super().__init__(cfg)
        self.target_split_s = cfg.detect_split_s


@register
class SplitFinal(_Split):
    name = "split_final"

    def __init__(self, cfg):
        super().__init__(cfg)
        self.target_split_s = cfg.final_split_s


@register
class Stft(Stage):
    """STFT once per chunk; spectra are shared by every downstream detector."""
    name = "stft"

    def check(self, vs):
        self._need(vs, "wave")
        if vs.geom.channels != 1:
            raise GraphValidationError("stage 'stft' needs mono audio")
        return replace(vs, has=vs.has | {"spec", "power"})

    def apply(self, state, rules):
        state["spec"], state["power"] = S.stft_chunks(state["wave"], self.cfg)
        state.pop("indices", None)
        return state


@register
class DetectRain(Stage):
    """Rain removal mask (rule over acoustic indices)."""
    name = "detect_rain"

    def check(self, vs):
        self._need(vs, "power")
        return replace(vs, has=vs.has | {"rain"})

    def apply(self, state, rules):
        rain = D.detect_rain(_indices(state, self.cfg), self.cfg)
        prev = state.get("rain")
        state["rain"] = rain if prev is None else (prev | rain)
        return state


@register
class CicadaBandstop(Stage):
    """Cicada detection + band-stop around the chorus peak (gated on
    ~rain: rain chunks are deleted, not filtered)."""
    name = "cicada_bandstop"

    def check(self, vs):
        self._need(vs, "spec", "power")
        return replace(vs, has=vs.has | {"cicada"})

    def apply(self, state, rules):
        idx = _indices(state, self.cfg)
        cicada = D.detect_cicada(idx, self.cfg)
        if "rain" in state:
            cicada = cicada & ~state["rain"]
        state["cicada"] = cicada
        state["spec"] = S.remove_cicada_band(
            state["spec"], idx["cicada_peak_bin"], cicada, self.cfg)
        return state


@register
class Istft(Stage):
    name = "istft"

    def check(self, vs):
        self._need(vs, "wave", "spec")
        return vs

    def apply(self, state, rules):
        state["wave"] = S.istft_chunks(state["spec"],
                                       state["wave"].shape[1], self.cfg)
        return state


@register
class DetectSilence(Stage):
    """Silence removal mask: envelope SNR under the paper's lower
    threshold, gated on ~rain."""
    name = "detect_silence"

    def check(self, vs):
        self._need(vs, "power")
        return replace(vs, has=vs.has | {"silence"})

    def apply(self, state, rules):
        silence = I.snr_est(state["power"]) < self.cfg.silence_snr_threshold
        if "rain" in state:
            silence = silence & ~state["rain"]
        prev = state.get("silence")
        state["silence"] = silence if prev is None else (prev | silence)
        return state


@register
class DetectFlux(Stage):
    """Spectral-flux energy detector: chunks whose peak rectified flux
    stays under `cfg.flux_threshold` are folded into the silence mask
    (gated on ~rain). A drop-in alternative to 'detect_silence'."""
    name = "detect_flux"

    def check(self, vs):
        self._need(vs, "power")
        return replace(vs, has=vs.has | {"silence"})

    def apply(self, state, rules):
        idle = D.detect_no_activity(_indices(state, self.cfg), self.cfg)
        if "rain" in state:
            idle = idle & ~state["rain"]
        prev = state.get("silence")
        state["silence"] = idle if prev is None else (prev | idle)
        return state


@register
class RemovalPoint(Stage):
    """Marker: host compaction may occur here. Freezes keep = ~rain &
    ~silence; past it only the waveform survives compaction, so downstream
    stages may depend on nothing else (enforced at build time)."""
    name = "removal_point"
    removal_point = True

    def check(self, vs):
        self._need(vs, "wave")
        return _ValidState(vs.geom, frozenset({"wave"}))

    def apply(self, state, rules):
        n = state["wave"].shape[0]
        zeros = torch.zeros((n,), dtype=torch.bool,
                            device=state["wave"].device)
        state["keep"] = (~state.get("rain", zeros)
                         & ~state.get("silence", zeros))
        return state


@register
class Mmse(Stage):
    """MMSE-STSA denoise, placed after the removal point so plans can run
    it on survivors only."""
    name = "mmse"

    def check(self, vs):
        self._need(vs, "wave")
        if vs.geom.channels != 1:
            raise GraphValidationError("stage 'mmse' needs mono audio")
        return vs

    def apply(self, state, rules):
        wave = rules.constrain(state["wave"], "chunks", None)
        state["wave"] = S.mmse_denoise(wave, self.cfg)
        return state


@register
class TailHighpass(Stage):
    """Stride-1 FIR high-pass on the survivor tail; with 'mmse' after it,
    the canonical fused tail hpf -> stft -> mmse -> istft."""
    name = "hpf"

    def check(self, vs):
        self._need(vs, "wave")
        if vs.geom.channels != 1:
            raise GraphValidationError("stage 'hpf' needs mono audio")
        return vs

    def apply(self, state, rules):
        wave = rules.constrain(state["wave"], "chunks", None)
        state["wave"] = S.tail_highpass(wave, self.cfg)
        return state


# ------------------------------------------------------------------ graph

class PipelineGraph:
    """A validated stage chain built from a config-declared stage list
    (`stage_names` defaults to `cfg.stages`)."""

    def __init__(self, cfg, stage_names=None, source_channels=2):
        self.cfg = cfg
        self.names = tuple(stage_names if stage_names is not None
                           else cfg.stages)
        unknown = [n for n in self.names if n not in STAGES]
        if unknown:
            raise GraphValidationError(
                f"unknown stages {unknown}; registered: {sorted(STAGES)}")
        self.stages = [STAGES[n](cfg) for n in self.names]
        self.source_geom = ChunkGeom(cfg.long_split_s, cfg.source_rate_hz,
                                     source_channels)
        self.removal_indices: list[int] = []
        vs = _ValidState(self.source_geom, frozenset({"wave"}))
        for i, st in enumerate(self.stages):
            try:
                vs = st.check(vs)
            except GraphValidationError as e:
                raise GraphValidationError(
                    f"stage {i} ({st.name!r}): {e}") from None
            if st.removal_point:
                self.removal_indices.append(i)
        self.out_geom = vs.geom

    @property
    def fingerprint(self):
        """Stable identity of the computation: config, stage names and
        source geometry (all frozen, repr-stable), as the reference's; the
        chunk store's content key hashes its repr."""
        return (self.cfg, self.names, self.source_geom)

    @property
    def has_removal_point(self) -> bool:
        return bool(self.removal_indices)

    def _cut(self) -> int:
        """Index one past the first removal point (= len when none)."""
        if not self.removal_indices:
            return len(self.stages)
        return self.removal_indices[0] + 1

    def _run(self, stages, state, rules):
        for st in stages:
            with obs_tracing.span("stage." + st.name):
                state = st.apply(state, rules)
        return state

    def _outputs(self, state, rules, masked=False) -> PipelineOutput:
        with obs_tracing.span("outputs"):
            wave = state["wave"]
            n = wave.shape[0]
            zeros = torch.zeros((n,), dtype=torch.bool, device=wave.device)
            rain = state.get("rain", zeros)
            silence = state.get("silence", zeros)
            keep = state.get("keep", ~rain & ~silence)
            cicada = state.get("cicada", zeros)
            if masked:
                wave = torch.where(keep[:, None], wave,
                                   torch.zeros((), dtype=wave.dtype,
                                               device=wave.device))
            wave, keep, rain, silence, cicada = (
                _global_rows(t, rules) for t in (wave, keep, rain, silence,
                                                 cicada))
            stats = {
                "n_chunks5": wave.shape[0],
                "frac_rain": whole(rain.float().mean()),
                "frac_silence": whole(silence.float().mean()),
                "frac_kept": whole(keep.float().mean()),
                "frac_cicada15": whole(cicada.float().mean()),
            }
            return PipelineOutput(wave5=wave, keep=keep, rain=rain,
                                  silence=silence, cicada15=cicada,
                                  stats=stats)

    def detection(self, audio, rules=NULL_RULES) -> PipelineOutput:
        """Phase A: everything up to and including the first removal point
        (wave5 is not yet denoised). Without a removal point this runs the
        whole chain."""
        state = self._run(self.stages[:self._cut()],
                          {"wave": _local_rows(audio, rules)}, rules)
        return self._outputs(state, rules)

    def tail(self, wave, rules=NULL_RULES):
        """Phase B: the survivor stages past the first removal point,
        applied to a (compacted) chunk batch."""
        return self._tail_rows(_local_rows(wave, rules), rules)

    def _tail_rows(self, rows, rules):
        state = self._run(self.stages[self._cut():], {"wave": rows}, rules)
        return _global_rows(state["wave"], rules)

    def tail_indexed(self, wave, idx, rules=NULL_RULES):
        """Phase B with on-device compaction: gather the survivor rows
        `idx` (padded int32) out of the full pre-denoise batch, then run the
        survivor stages. Indices >= B (the scheduler's pad) give zero
        rows. Under a mesh each rank gathers the rows of its block of
        `idx` out of the whole batch."""
        return self._tail_rows(
            gather_rows(whole(wave), _local_rows(idx, rules)), rules)
    @property
    def fused_tail_spec(self):
        """`{"hpf": bool}` when the post-removal stage list is the
        canonical fused tail, `("mmse",)` or `("hpf", "mmse")`; else None."""
        if not self.removal_indices:
            return None
        post = self.names[self._cut():]
        if post == ("mmse",):
            return {"hpf": False}
        if post == ("hpf", "mmse"):
            return {"hpf": True}
        return None

    def tail_indexed_fused(self, wave, idx, rules=NULL_RULES):
        """`tail_indexed` through the fused tail (gather + [HPF] + STFT +
        MMSE gain in one kernel, the iSTFT outside). Only valid when
        `fused_tail_spec` is not None."""
        spec = self.fused_tail_spec
        if spec is None:
            raise GraphValidationError(
                f"post-removal stages {self.names[self._cut():]} are not "
                "the canonical fused tail; use tail_indexed")
        wave = rules.constrain(whole(wave), "chunks", None)
        return _global_rows(
            fused_tail_ops.fused_tail(wave, _local_rows(idx, rules),
                                      self.cfg, hpf=spec["hpf"]), rules)

    def fused(self, audio, rules=NULL_RULES) -> PipelineOutput:
        """The whole chain on every chunk, removed chunks masked to zero in
        `wave5` but still computed: the paper's no-early-exit baseline."""
        state = self._run(self.stages, {"wave": _local_rows(audio, rules)},
                          rules)
        return self._outputs(state, rules, masked=True)


# ------------------------------------------------------------------- mesh
# Under rules with a mesh every stage is row-local: "chunks" maps to every
# mesh axis and samples and bins are replicated. So each entry point takes
# the rank's block of rows, runs the chain on it on the rank's device (the
# hand kernels on the card, their plain versions on the CPU) and wraps its
# outputs back as DTensors with the "chunks" placements. Without a mesh
# these are no-ops.

def _chunk_placements(t, rules):
    return rules.sharding("chunks", *([None] * (t.ndim - 1)))


def _local_rows(x, rules):
    """The rank's block of the rows of `x` (a DTensor, or a tensor every
    rank holds whole): its "chunks" block. The row count must divide by
    the mesh's size (the plans pad to it)."""
    if rules.mesh is None:
        return x
    n = rules.mesh.size()
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split evenly over a "
                         f"mesh of {n} devices: pad to a multiple of {n}")
    return _chunk_placements(x, rules).place(x).to_local()


def _global_rows(t, rules):
    """The rank's rows `t` as the DTensor they are a block of."""
    if rules.mesh is None:
        return t
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, rules.mesh,
                              tuple(_chunk_placements(t, rules)))
