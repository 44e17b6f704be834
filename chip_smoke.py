#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
CUDA toolkit's `nvcc`; it fails on a machine without a card and when run
outside a checkout of the repo. Phases, any failure exits non-zero:

  1. device: the card's name and power limit; build every kernel from
     `src/repro_torch/kernels/csrc` (one nvcc per source, in parallel).
  2. kernels: each hand kernel against its plain PyTorch version on the
     card, at the shapes of the main path, with the stated tolerance; the
     median kernel time (CUDA events, L2 flushed before each run), the plain
     version's time, one library call's time where PyTorch has one, and the
     least time the card could take for the same work (`bound_ms`). The
     FIR also at the staged tail's stride-1 high-pass shape; the
     fused tail also at all 48 rows, with the high-pass, and with
     noise_est_frames = 100; the MMSE kernel also at 35 rows, the main
     path's largest survivor batch; `chain_ms` is the MMSE kernel on one
     chain of 860 frames: this implementation's floor for a recurrence of
     860 steps, measured in the run beside `bound_ms` (not a bound of the
     function).
  3. main path: four cells (`CELLS`) of `Preprocessor(SERF_AUDIO, ...)` on
     the card over 3 batches of `audio_batch_maker(seed=25,
     batch_long_chunks=4)` (12 minutes of stereo 44.1 kHz audio):
     `two_phase` with the fused tail and with `fuse_tail=False`, and the
     asynchronous `async` (depth 2) and `streaming` plans with the fused
     tail. Each is warmed up over one batch, then driven once with the
     launch counts set to 0 just before and read just after: every kernel
     of its path must have launched. The two_phase cells' batch 0 must
     match the port's own CPU run (equal masks, cleaned audio within
     2e-4); the staged cell the fused one within 2e-4; the async and
     streaming cells the fused two_phase cell bitwise, with at least one
     dispatch that overlapped another batch, and the async cell's
     profiled pass must copy no batch from pageable memory. Printed: MB/s
     of source audio (median, min and max of 5 timed passes per cell, the
     cells in turns), the chunks kept, the host staging and DMA ms of each
     upload of the asynchronous cells, and one profiled pass per cell
     (device time by kernel, copies by kind; its trace goes to
     `build/chip_smoke/`).
  4. one JSON line with every kernel's numbers, then the result line
     `{"ok": true, "device": {...}}` last.

It imports only `repro_torch`, `torch` and numpy.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PASSES = 5                      # timed passes over the 3-batch stream
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
MMSE_OPS_PER_STEP = 64          # f32 operations of one mmse_step (mmse.cuh),
#                                 exp, sqrt and divide counted as one each
TOL = {"fir_hpf": (1e-4, 1e-5), "stft_dft": (2e-4, 2e-4),
       "mmse_stsa": (1e-4, 2e-5), "fused_tail": (2e-4, 2e-4),
       "main_path": (2e-4, 2e-4)}   # (rtol, atol)
SOURCES = {"fir_hpf": "fir", "stft_dft": "stft", "mmse_stsa": "mmse",
           "fused_tail": "fused_tail"}
REPLACES = {"fir_hpf": "src/repro/kernels/fir_hpf/kernel.py:62",
            "stft_dft": "src/repro/kernels/stft_dft/kernel.py:82",
            "mmse_stsa": "src/repro/kernels/mmse_stsa/kernel.py:91",
            "fused_tail": "src/repro/kernels/fused_tail/kernel.py:201"}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi(query):
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------- timing

class Timer:
    """Median of CUDA-event times over `reps` runs after `warmup`, with the
    50 MB L2 cache overwritten before each run (the main path finds its
    inputs cold: each stage's output is larger than L2 or was written
    long before)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 * 2**20 // 4, dtype=torch.float32,
                                 device="cuda")

    def __call__(self, fn, reps=10, warmup=2):
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def rfft_flops(n):
    """Operations of one n-point real FFT (the usual 2.5 n log2 n count)."""
    return 2.5 * n * math.log2(n)


def fir_flops(n_in, n_out, T):
    """Least operations of a T-tap FIR over n_in samples giving n_out
    outputs: the direct form (2T per output) or overlap-save with real FFTs
    of the power of two N >= 8T (two FFTs and N/2+1 complex products per
    N-T+1 input samples), whichever is less."""
    N = 1 << math.ceil(math.log2(8 * T))
    blocks = math.ceil(n_in / (N - T + 1))
    return min(2 * T * n_out,
               blocks * (2 * rfft_flops(N) + 6 * (N // 2 + 1)))


def stft_flops(frames, W):
    """Least operations of a windowed real STFT: the window product and one
    real FFT per frame (the kernels' dense DFT does 4·W·(W/2+1))."""
    return frames * (W + rfft_flops(W))


def bound(n_bytes, n_flops, peak_flops):
    """(least ms, "bytes" or "operations"): the bytes the function must move
    over the HBM rate against the least operations it needs over the f32
    peak, whichever takes longer."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(torch, got, want, rtol, atol):
    """max |got - want| and whether |got - want| <= atol + rtol*|want|
    holds everywhere (complex compared as (re, im) pairs)."""
    if got.is_complex():
        got, want = torch.view_as_real(got), torch.view_as_real(want)
    got, want = got.double(), want.double()
    diff = (got - want).abs()
    ok = bool((diff <= atol + rtol * want.abs()).all()) and bool(
        torch.isfinite(got).all())
    return float(diff.max()), ok


# ---------------------------------------------------------------- phase 2

def kernel_checks(torch, np, timer, peak_flops):
    import torch.nn.functional as F

    from repro_torch.configs import SERF_AUDIO as cfg
    from repro_torch.kernels.fir_hpf import ops as fir_ops, ref as fir_ref
    from repro_torch.kernels.fused_tail import ops as ft_ops, ref as ft_ref
    from repro_torch.kernels.mmse_stsa import ops as mmse_ops
    from repro_torch.kernels.mmse_stsa import ref as mmse_ref
    from repro_torch.kernels.stft_dft import ops as stft_ops
    from repro_torch.kernels.stft_dft import ref as stft_ref

    gen = torch.Generator(device="cuda").manual_seed(11)
    results = {}

    def record(name, shape, err, ok, ms, plain_ms, library_ms, n_bytes,
               n_flops, **extra):
        bound_ms, bound_by = bound(n_bytes, n_flops, peak_flops)
        rtol, atol = TOL[name]
        rec = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/kernels/csrc/{SOURCES[name]}.cu",
               "replaces": REPLACES[name], "shape": shape,
               "max_abs_err": err, "rtol": rtol, "atol": atol,
               "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": library_ms, "bytes": n_bytes,
               "flops": n_flops, **extra}
        print(json.dumps(rec), flush=True)
        check(ok, f"{name}: kernel disagrees with its plain version "
                  f"(max |err| {err:.3g}, rtol {rtol}, atol {atol})")
        results[name] = rec

    def fir_case(B, S, stride, taps_np):
        """The FIR kernel at one shape against `fir_ref`, with its times,
        `conv1d`'s and its bound."""
        x = torch.randn((B, S), generator=gen, device="cuda") * 0.3
        T = taps_np.shape[0]
        got = fir_ops.fir_cuda(x, taps_np, stride)
        want = fir_ref.fir_ref(x, taps_np, stride)
        torch.cuda.synchronize()
        err, ok = compare(torch, got, want, *TOL["fir_hpf"])
        xp = F.pad(x[:, None, :], (T - 1, 0))
        w = torch.as_tensor(taps_np, device="cuda").flip(0)[None, None, :]
        out_len = S // stride
        n_bytes = 4 * (B * S + B * out_len + T)
        n_flops = fir_flops(B * S, B * out_len, T)
        b_ms, b_by = bound(n_bytes, n_flops, peak_flops)
        return dict(
            shape=f"x ({B}, {S}) -> ({B}, {out_len}), T={T}, s={stride}",
            err=err, ok=ok,
            ms=timer(lambda: fir_ops.fir_cuda(x, taps_np, stride)),
            plain_ms=timer(lambda: fir_ref.fir_ref(x, taps_np, stride)),
            library_ms=timer(lambda: F.conv1d(xp, w, stride=stride)),
            n_bytes=n_bytes, n_flops=n_flops, bound_ms=b_ms, bound_by=b_by)

    # FIR: the compress stage, (4, 2,646,000) -> (4, 1,323,000), 129 taps,
    # and the staged tail's hpf stage, (48, 110,250) at stride 1
    s1 = fir_case(48, 110_250, 1, fir_ref.highpass_taps(
        cfg.hpf_cutoff_hz, cfg.target_rate_hz, cfg.hpf_taps))
    check(s1["ok"], f"fir_hpf (stride 1): kernel disagrees with its plain "
                    f"version (max |err| {s1['err']:.3g})")
    c = fir_case(4, 2_646_000, 2, fir_ref.bandpass_decimate_taps(
        1000.0, 11_025.0, 44_100, 129))
    record("fir_hpf", c["shape"], c["err"], c["ok"], c["ms"], c["plain_ms"],
           c["library_ms"], c["n_bytes"], c["n_flops"],
           library_call="torch.nn.functional.conv1d (cuDNN, TF32 off)",
           stride1={"shape": s1["shape"], "max_abs_err": s1["err"],
                    "ms": s1["ms"], "plain_ms": s1["plain_ms"],
                    "library_ms": s1["library_ms"],
                    "bound_ms": s1["bound_ms"], "bound_by": s1["bound_by"],
                    "bytes": s1["n_bytes"], "flops": s1["n_flops"]})

    # STFT: the detection STFT, (16, 330,750) -> (16, 2582, 129)
    B, S, W, H = 16, 330_750, cfg.stft_window, cfg.stft_hop
    K = W // 2 + 1
    x = torch.randn((B, S), generator=gen, device="cuda") * 0.3
    got = stft_ops.stft_cuda(x, W, H)
    want = stft_ref.stft_ref(x, W, H)
    torch.cuda.synchronize()
    err, ok = compare(torch, got, want, *TOL["stft_dft"])
    Fr = got.shape[1]
    win = torch.as_tensor(stft_ref.hamming(W), dtype=torch.float32,
                          device="cuda")
    lib = torch.stft(x, n_fft=W, hop_length=H, window=win, center=False,
                     return_complex=True)
    lib_err = float((lib.transpose(1, 2) - want).abs().max())
    record("stft_dft", f"x ({B}, {S}) -> ({B}, {Fr}, {K}) complex", err, ok,
           timer(lambda: stft_ops.stft_cuda(x, W, H)),
           timer(lambda: stft_ref.stft_ref(x, W, H)),
           timer(lambda: torch.stft(x, n_fft=W, hop_length=H, window=win,
                                    center=False, return_complex=True)),
           4 * B * ((Fr - 1) * H + W) + 4 * 3 * W + 8 * B * Fr * K,
           stft_flops(B * Fr, W),
           library_call="torch.stft (cuFFT; (B, K, F) layout)",
           library_max_abs_err=lib_err)
    rec = results["stft_dft"]
    rec["kernel_over_library"] = rec["ms"] / rec["library_ms"]
    del x, got, want, lib

    # MMSE gain: the staged survivor tail, power (16, 860, 129), and
    # (35, 860, 129), the main path's largest survivor batch
    Fv = 860
    args = (cfg.mmse_alpha, cfg.mmse_gain_floor)

    def mmse_case(R, time_plain):
        rng = np.random.RandomState(5 if R == 16 else R)
        p = rng.exponential(1.0, (R, Fv, K)).astype(np.float32)
        p[:, Fv // 4:Fv // 2, :K // 3] += 40.0       # a loud region
        power = torch.as_tensor(p, device="cuda")
        noise = mmse_ref.estimate_noise_psd(power, cfg.noise_est_frames)
        got = mmse_ops.mmse_gain_cuda(power, noise, *args)
        want = mmse_ref.mmse_stsa_gain_ref(power, noise, *args)
        torch.cuda.synchronize()
        err, ok = compare(torch, got, want, *TOL["mmse_stsa"])
        n_bytes = 4 * (2 * R * Fv * K + R * K)
        n_flops = MMSE_OPS_PER_STEP * R * Fv * K
        b_ms, b_by = bound(n_bytes, n_flops, peak_flops)
        return dict(
            power=power, noise=noise, err=err, ok=ok,
            shape=f"power ({R}, {Fv}, {K}), noise ({R}, {K})",
            ms=timer(lambda: mmse_ops.mmse_gain_cuda(power, noise, *args)),
            plain_ms=(timer(lambda: mmse_ref.mmse_stsa_gain_ref(
                power, noise, *args), reps=3, warmup=1) if time_plain
                else None),
            n_bytes=n_bytes, n_flops=n_flops, bound_ms=b_ms, bound_by=b_by)

    m35 = mmse_case(35, time_plain=False)
    check(m35["ok"], f"mmse_stsa (35 rows): kernel disagrees with its plain "
                     f"version (max |err| {m35['err']:.3g})")
    m = mmse_case(16, time_plain=True)
    # one chain of Fv dependent steps: this implementation's floor for the
    # recurrence, measured here; not a bound of the function
    p1 = m["power"][:1, :, :1].contiguous()
    n1 = m["noise"][:1, :1].contiguous()
    chain_ms = timer(lambda: mmse_ops.mmse_gain_cuda(p1, n1, *args))
    record("mmse_stsa", m["shape"], m["err"], m["ok"], m["ms"],
           m["plain_ms"], None, m["n_bytes"], m["n_flops"],
           chain_ms=chain_ms, chain_shape=f"(1, {Fv}, 1)",
           ms_over_chain=m["ms"] / chain_ms,
           rows35={"shape": m35["shape"], "max_abs_err": m35["err"],
                   "ms": m35["ms"], "ms_over_chain": m35["ms"] / chain_ms,
                   "bound_ms": m35["bound_ms"], "bound_by": m35["bound_by"],
                   "bytes": m35["n_bytes"], "flops": m35["n_flops"]})
    del m, m35, p1, n1

    # fused tail: wave (48, 110,250), 16 indices with one pad slot, and all
    # 48 rows; with and without the high-pass; noise_est_frames = 100
    B, S = 48, 110_250
    wave = torch.randn((B, S), generator=gen, device="cuda") * 0.3
    real = np.sort(np.random.RandomState(7).choice(B, 15, replace=False))
    Fv = stft_ref.num_frames(S, W, H)

    def fused_case(idx_np, tcfg, hpf, time_plain=True):
        idx = torch.as_tensor(np.asarray(idx_np, np.int32), device="cuda")
        pads = [i for i, v in enumerate(idx_np) if not 0 <= v < B]
        n_real = len(idx_np) - len(pads)
        got = ft_ops.fused_tail_spectrum_cuda(wave, idx, tcfg, hpf)
        want = ft_ref.fused_tail_spectrum_ref(wave, idx, tcfg, hpf)
        cleaned = ft_ops.fused_tail(wave, idx, tcfg, hpf)
        cleaned_ref = ft_ref.fused_tail_ref(wave, idx, tcfg, hpf)
        torch.cuda.synchronize()
        err, ok = compare(torch, got, want, *TOL["fused_tail"])
        werr, wok = compare(torch, cleaned, cleaned_ref, *TOL["fused_tail"])
        for i in pads:
            check(not bool(torch.view_as_real(got[i]).any()),
                  f"fused_tail (hpf={hpf}): pad row is not exactly zero")
            check(not bool(cleaned[i].any()),
                  f"fused_tail (hpf={hpf}): cleaned pad row is not zero")
        # the least work: real FFTs, the recurrence and the gain product
        # on the real rows (a pad row only writes zeros)
        span = (Fv - 1) * H + W                    # samples the frames use
        T = tcfg.hpf_taps if hpf else 0
        n_flops = (n_real * (stft_flops(Fv, W)
                             + (MMSE_OPS_PER_STEP + 2) * Fv * K)
                   + (fir_flops(n_real * span, n_real * span, T) if hpf
                      else 0))
        n_bytes = 4 * (n_real * span + len(idx_np) + 3 * W + T) \
            + 8 * len(idx_np) * Fv * K
        b_ms, b_by = bound(n_bytes, n_flops, peak_flops)
        return dict(
            err=err, ok=ok and wok, wave_err=werr, rows=len(idx_np),
            ms=timer(lambda: ft_ops.fused_tail_spectrum_cuda(wave, idx, tcfg,
                                                             hpf)),
            plain_ms=(timer(lambda: ft_ref.fused_tail_spectrum_ref(
                wave, idx, tcfg, hpf), reps=3, warmup=1) if time_plain
                else None),
            n_bytes=n_bytes, n_flops=n_flops, bound_ms=b_ms, bound_by=b_by)

    idx16 = [*real.tolist(), B]
    idx48 = list(range(B))
    noise100 = dataclasses.replace(cfg, noise_est_frames=100)
    cases = {"hpf": fused_case(idx16, cfg, True),
             "rows48": fused_case(idx48, cfg, False, time_plain=False),
             "rows48_hpf": fused_case(idx48, cfg, True, time_plain=False),
             "noise100": fused_case(idx16, noise100, False,
                                    time_plain=False),
             "noise100_hpf": fused_case(idx16, noise100, True,
                                        time_plain=False)}
    v = fused_case(idx16, cfg, False)
    for label, c in cases.items():
        check(c["ok"], f"fused_tail ({label}): kernel disagrees with its "
                       f"plain version (max |err| {c['err']:.3g})")

    def extra(c):
        return {"rows": c["rows"], "max_abs_err": c["err"],
                "cleaned_max_abs_err": c["wave_err"], "ms": c["ms"],
                "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                "bound_by": c["bound_by"]}

    record("fused_tail",
           f"wave ({B}, {S}), idx ({len(idx16)},) with 1 pad slot -> "
           f"({len(idx16)}, {Fv}, {K}) complex", v["err"], v["ok"], v["ms"],
           v["plain_ms"], None, v["n_bytes"], v["n_flops"],
           cleaned_max_abs_err=v["wave_err"], chain_ms=chain_ms,
           ms_over_chain=v["ms"] / chain_ms,
           **{label: extra(c) for label, c in cases.items()})
    return results


# ---------------------------------------------------------------- phase 3

def mask_margins(torch, graph, audio):
    """Each detector index of batch 0 (CPU run), its threshold and every
    chunk's margin to it, for reporting a mask that differs between the
    card and the CPU."""
    from repro_torch.core import indices as I
    cfg = graph.cfg
    thresholds15 = {"psd": cfg.rain_psd_min,
                    "flatness": cfg.rain_flatness_min,
                    "snr": cfg.rain_snr_max,
                    "cicada_peakiness": cfg.cicada_peakiness_min,
                    "cicada_band": cfg.cicada_band_ratio_min,
                    "cicada_persistence": cfg.cicada_persistence_min}
    state = {"wave": torch.as_tensor(audio)}
    out = {}
    for st in graph.stages[:graph._cut()]:
        state = st.apply(state)
        if st.name == "cicada_bandstop":           # 15 s chunks
            for k, thr in thresholds15.items():
                out[k] = {"threshold": thr, "margin":
                          (state["indices"][k] - thr).tolist()}
        if st.name == "detect_silence":            # 5 s chunks
            thr = cfg.silence_snr_threshold
            out["snr5"] = {"threshold": thr, "margin":
                           (I.snr_est(state["power"]) - thr).tolist()}
    return out


def memcpy_summary(trace_path):
    """Per kind of copy in a Chrome trace of the profiler ("Memcpy HtoD
    (Pageable -> Device)", ...): count, device ms, total and largest
    bytes."""
    events = json.loads(Path(trace_path).read_text())["traceEvents"]
    out = {}
    for e in events:
        if e.get("cat") != "gpu_memcpy":
            continue
        rec = out.setdefault(e["name"], {"count": 0, "ms": 0.0, "bytes": 0,
                                         "max_bytes": 0})
        n = int(e["args"]["bytes"])
        rec["count"] += 1
        rec["ms"] += e["dur"] / 1e3
        rec["bytes"] += n
        rec["max_bytes"] = max(rec["max_bytes"], n)
    return out


def device_profile(torch, pre, batches, trace_path):
    """Device time by kernel over one pass of the main path under
    `torch.profiler`, the share of that pass's wall time the device was
    busy, and the copies by kind (`memcpy_summary` of the pass's trace,
    written to `trace_path`). The profiler slows the host side, so the
    share is a lower bound of the unprofiled run's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        list(pre.run(batches))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            by_name[e.key] = (us / 1e3, e.count)
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace_path))
    copies = memcpy_summary(trace_path)
    if not by_name:
        return {"device_busy_ms": "not measured", "wall_ms": wall_ms,
                "copies": copies}
    busy = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_busy_share": busy / wall_ms, "copies": copies,
            "top": [[k[:80], ms, n] for k, (ms, n) in top]}


# cell -> (plan, plan arguments); the first is the one the others are held
# against bitwise (same fused tail), the two two_phase cells are also held
# against the port's CPU run
CELLS = {"serf_two_phase_fused": ("two_phase", {}),
         "serf_two_phase_staged": ("two_phase", {"fuse_tail": False}),
         "serf_async_fused": ("async", {}),
         "serf_streaming_fused": ("streaming", {})}
# kernels a cell's main-path run must launch (the fused path's by default)
NEED = {"serf_two_phase_staged": ("fir_hpf", "stft_dft", "mmse_stsa")}


def pageable_uploads(copies, batch_bytes):
    """The kinds of pageable host-to-device copy in `copies` that moved a
    whole batch at once."""
    return [name for name, rec in copies.items()
            if "HtoD" in name and "Pageable" in name
            and rec["max_bytes"] >= batch_bytes]


def main_path(torch, np, card):
    from repro_torch import kernels
    from repro_torch.configs import SERF_AUDIO
    from repro_torch.core.plans import Preprocessor
    from repro_torch.data.loader import audio_batch_maker

    make = audio_batch_maker(seed=25, batch_long_chunks=4)
    batches = [(w, make(w)) for w in range(3)]     # set-up, not timed
    src = sum(c.nbytes for _, (c, _) in batches)
    batch_bytes = batches[0][1][0].nbytes
    cells = {label: Preprocessor(SERF_AUDIO, plan=plan, **kw)
             for label, (plan, kw) in CELLS.items()}
    results, launch_counts, uploads, in_flight = {}, {}, {}, {}
    for label, pre in cells.items():
        check(pre.device.type == "cuda", "Preprocessor did not pick the card")
        # warm-up over one batch: cuFFT plans, the allocators, the staging
        # ring's cudaHostAlloc
        list(pre.run(batches[:1]))
        torch.cuda.synchronize()
        staging = pre.plan.staging
        if staging is not None:
            staging.log.clear()
        kernels.reset_launches()
        run = list(pre.run(batches))               # the main-path run
        torch.cuda.synchronize()
        launch_counts[label] = kernels.launches()
        # the asynchronous plans hand out `cleaned` as views of pinned
        # buffers; keep copies, so that the timed passes find those
        # buffers free in the caching host allocator as a consumer that
        # drops its results leaves them (no cudaHostAlloc in a pass)
        results[label] = [dataclasses.replace(r, cleaned=r.cleaned.copy())
                          for r in run]
        del run
        if staging is not None:
            in_flight[label] = [t["in_flight"]
                                for t in pre.plan.last_timings]
            uploads[label] = [{"staging_ms": a, "dma_ms": b}
                              for a, b in staging.upload_times()]
    # timed passes, the cells in turns, the order reversed every other
    # pass so that no cell always runs first; and the host staging ms the
    # asynchronous cells spent in each pass
    pass_times = {label: [] for label in cells}
    pass_staging = {label: [] for label in uploads}
    for rep in range(PASSES):
        for label in (list(cells) if rep % 2 == 0 else list(cells)[::-1]):
            staging = cells[label].plan.staging
            logged = len(staging.log) if staging is not None else 0
            t0 = time.perf_counter()
            list(cells[label].run(batches))
            torch.cuda.synchronize()
            pass_times[label].append(time.perf_counter() - t0)
            if staging is not None:
                pass_staging[label].append(1e3 * sum(
                    e[0] for e in list(staging.log)[logged:]))

    runs = {}
    for label, pre in cells.items():
        res, counts, pass_s = (results[label], launch_counts[label],
                               pass_times[label])
        mb_per_s = sorted(src / 2**20 / s for s in pass_s)
        # per-layer split: one more pass, synchronising between the phases
        detect_ms, tail_ms = [], []
        for _, (audio, _) in batches:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            det = pre.plan.detect(audio)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            pre.plan._finish(det)
            t3 = time.perf_counter()
            detect_ms.append((t2 - t1) * 1e3)
            tail_ms.append((t3 - t2) * 1e3)
        kept = sum(r.n_kept for r in res)
        chunks = sum(int(r.det.keep.numel()) for r in res)
        for r in res:
            check(r.cleaned.shape == (r.n_kept, SERF_AUDIO.final_split_samples)
                  and np.isfinite(r.cleaned).all(),
                  f"{label}: cleaned batch {r.wid} is malformed")
        med = statistics.median(mb_per_s)
        profile = device_profile(
            torch, pre, batches,
            ROOT / "build" / "chip_smoke" / f"trace_{label}.json")
        rec = {"main_path": label, "plan": pre.plan.name,
               "fuse_tail": pre.plan.fuse_tail, "launches": counts,
               "passes": PASSES, "pass_s": pass_s, "mb_per_s_median": med,
               "mb_per_s_min": mb_per_s[0], "mb_per_s_max": mb_per_s[-1],
               "src_mb": src / 2**20, "kept": kept, "chunks": chunks,
               "detect_ms": detect_ms, "tail_ms": tail_ms,
               "timings": [r.timings for r in res], "profile": profile}
        if label in uploads:
            rec.update(depth=pre.plan.depth, in_flight=in_flight[label],
                       uploads=uploads[label],
                       pass_staging_ms=pass_staging[label])
        runs[label] = dict(rec, res=res)
        print(f"plan={pre.plan.name} cell={label} card={card}  "
              f"{src / 2**20:.0f} MB source audio per pass, median of "
              f"{PASSES} passes  ->  {med:.2f} MB/s "
              f"({mb_per_s[0]:.2f}-{mb_per_s[-1]:.2f})", flush=True)
        print(f"chunks kept {kept}/{chunks} ({label})", flush=True)
        for i, u in enumerate(uploads.get(label, ())):
            print(f"{label} upload of batch {i}: host staging "
                  f"{u['staging_ms']:.3f} ms, DMA {u['dma_ms']:.3f} ms",
                  flush=True)
        print(json.dumps(rec), flush=True)

    for label, r in runs.items():
        for n in NEED.get(label, ("fir_hpf", "stft_dft", "fused_tail")):
            check(r["launches"][n] > 0,
                  f"main path ({label}) never launched kernel {n}")
    for label in in_flight:
        check(max(in_flight[label]) >= 2,
              f"{label}: no dispatch overlapped another batch "
              f"(in_flight {in_flight[label]})")
    bad = pageable_uploads(runs["serf_async_fused"]["profile"]["copies"],
                           batch_bytes)
    check(not bad, f"serf_async_fused: the profiled pass copied a batch "
                   f"from pageable memory ({bad})")

    base = runs["serf_two_phase_fused"]["res"]
    for label in ("serf_two_phase_staged", "serf_async_fused",
                  "serf_streaming_fused"):
        bitwise = label != "serf_two_phase_staged"
        for a, b in zip(base, runs[label]["res"]):
            check(a.wid == b.wid, f"{label}: batches out of order")
            for m in ("keep", "rain", "silence", "cicada15"):
                check(bool((getattr(a.det, m) == getattr(b.det, m)).all()),
                      f"{label}: the {m} mask differs from two_phase's")
            check(a.cleaned.shape == b.cleaned.shape and (
                np.array_equal(a.cleaned, b.cleaned) if bitwise
                else np.allclose(a.cleaned, b.cleaned, rtol=2e-4,
                                 atol=2e-4)),
                f"{label}: cleaned audio differs from two_phase's fused "
                f"tail" + (" (bitwise)" if bitwise else " beyond 2e-4"))

    # batch 0 against the port's own CPU run on the same numpy input
    chunks0 = batches[0][1][0]
    cpu_pre = Preprocessor(SERF_AUDIO, plan="two_phase", device="cpu")
    cpu = cpu_pre(chunks0)
    report = {}
    for label in ("serf_two_phase_fused", "serf_two_phase_staged"):
        gpu = runs[label]["res"][0]
        flips = {}
        for m in ("keep", "rain", "silence", "cicada15"):
            g = getattr(gpu.det, m).cpu().numpy()
            c = getattr(cpu.det, m).numpy()
            if not (g == c).all():
                flips[m] = np.flatnonzero(g != c).tolist()
        if flips:
            print(json.dumps({"mask_flips": flips, "margins": mask_margins(
                torch, cpu_pre.graph, chunks0)}), flush=True)
        check(not flips, f"{label}: masks differ from the CPU run: {flips}")
        rtol, atol = TOL["main_path"]
        diff = (float(np.abs(gpu.cleaned - cpu.cleaned).max())
                if cpu.n_kept else 0.0)
        report[label] = diff
        check(gpu.cleaned.shape == cpu.cleaned.shape and np.allclose(
            gpu.cleaned, cpu.cleaned, rtol=rtol, atol=atol),
            f"{label}: cleaned audio differs from the CPU run "
            f"(max |err| {diff:.3g})")
    print(json.dumps({"batch0_vs_cpu": report, "kept": cpu.n_kept,
                      "chunks": int(cpu.det.keep.numel())}), flush=True)
    return runs


# ------------------------------------------------------------------- main

def main():
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script; "
              "run it from a checkout of the repo", file=sys.stderr)
        return 2
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    # plain versions on the card run in full f32, as the kernels do
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from repro_torch.kernels import KERNELS, _build

    # phase 1: device + build
    card_line = nvidia_smi("name,power.limit")
    print(card_line, flush=True)
    max_clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    props = torch.cuda.get_device_properties(0)
    peak_flops = props.multi_processor_count * 128 * 2 * max_clock_mhz * 1e6
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "sms": props.multi_processor_count,
                      "max_sm_clock_mhz": max_clock_mhz,
                      "f32_fma_peak_tflops": peak_flops / 1e12}), flush=True)
    t0 = time.perf_counter()
    _build.build()
    print(f"build: {len(_build.SOURCES)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)

    try:
        timer = Timer(torch)
        results = kernel_checks(torch, np, timer, peak_flops)
        runs = main_path(torch, np, card_line)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1

    for name, rec in results.items():
        rec["launches"] = sum(r["launches"][name] for r in runs.values())
        rec["launches_per_run"] = {k: r["launches"][name]
                                   for k, r in runs.items()}
    if set(results) != set(KERNELS):
        print("chip_smoke: FAIL: not every kernel was checked",
              file=sys.stderr)
        return 1
    summary = {"kernels": [results[n] for n in KERNELS]}
    print(card_line, flush=True)
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
