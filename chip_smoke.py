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
     function). The direct-DFT paths of the STFT and fused-tail kernels
     (`stft_dft_generic`, `fused_tail_generic`) at windows 382 and 200, the
     fused tail with and without the high-pass and, at 382, with
     noise_est_frames = 100. Beside each kernel's median: the least and
     the most of its 10 runs and the SM clock read right after them.
  3. main path: eight cells (`CELLS`) of `Preprocessor(SERF_AUDIO, ...)`
     on the card over 3 batches of `audio_batch_maker(seed=25,
     batch_long_chunks=4)` (12 minutes of stereo 44.1 kHz audio):
     `two_phase` with the fused tail and with `fuse_tail=False`, the
     asynchronous `async` (depth 2) and `streaming` plans with the fused
     tail, the no-early-exit `fused` plan, `cached` around two_phase,
     cold (every run from an emptied store) and warm (every batch a hit),
     and the in-process `sharded` plan over 2 shards (its survivors
     re-sliced across them on the device for the staged tail).
     Each is warmed up (over one batch; the warm cached cell over all
     three, which fills its store), then driven once with the launch
     counts set to 0 just before and read just after: every kernel of its
     path must have launched, and none in the warm cached cell. The
     two_phase cells' batch 0 must match the port's own CPU run (equal
     masks, cleaned audio within 2e-4); the staged cell the fused one
     within 2e-4; the async, streaming and both cached cells the fused
     two_phase cell bitwise, with at least one dispatch of the async cell
     that overlapped another batch and no batch copied from pageable
     memory in its profiled pass; the fused plan's masks the two_phase
     cell's exactly and its kept rows the staged cell's survivors within
     rtol 1e-4 / atol 1e-5 (reported: whether bitwise). Printed: MB/s of
     source audio (median, min and max of 5 timed passes per cell, the
     cells in turns), the chunks kept, the host staging and DMA ms of each
     upload of the asynchronous cells, and one profiled pass per cell
     (device time by kernel, copies by kind; its trace goes to
     `build/chip_smoke/`). Then a kill and resume of the cached cell with
     a run journal (one result taken, the generator closed, the run
     resumed: batches [0, 1, 2] once each, 2 misses, output bitwise equal
     to two_phase's), and the 3 batches at a 382-sample window through
     two_phase (`serf_w382_two_phase`), whose run must launch the
     direct-DFT kernels and whose batch 0 must match the port's CPU run,
     timed in turns with `serf_two_phase_fused` (5 passes each, both MB/s
     printed). The sharded cell's masks must equal the fused two_phase
     cell's and its cleaned audio the staged cell's within rtol 1e-4 /
     atol 1e-5.
  4. worker processes: two cells (`PROC_CELLS`) of the sharded plan with
     2 real worker processes on the one card (`transport="proc"`, one work
     id a lease), over 8 batches of the same stream (wids 0-2 the cells'
     batches above), with the socket data plane and with a `ChunkStore`
     data plane emptied before every pass. The master's launch counts must
     stay 0: the workers report theirs at sign-off, and their FIR, STFT and
     fused-tail launches must be there, with device `cuda` and the bytes
     their allocators hold on the card; `nvidia-smi --query-compute-apps`
     is read while the fleet runs, and the worker pids must be listed (or,
     where it lists pids of another namespace than this process's, the
     card's used memory must fall by 256 MiB a worker once they exit);
     every wid emitted once, in order, batches 0-2 bitwise equal to the
     fused two_phase cell.
     Printed: MB/s of a whole run as a
     user sees it, fleet spawn included (median, min and max of
     `PROC_PASSES` passes, the two cells in turns), the fleet's start (run()
     to the last hello), each worker's idle and busy seconds, the bytes
     through the master's socket or the store. Then the kill phase: a
     `CrashInjector` SIGKILLs shard 1 at its second lease; every wid must
     be emitted once, bitwise equal to the unkilled run, with at least one
     redelivery.
     Then the serving cells (a `WorkerPool` behind a `ContinuousBatcher`,
     in-process and over 2 worker processes), a pool SIGKILL, and the
     observability phase.
  5. chaos: one pass of the first seed's stream without chaos (its wall
     against the fleet's start), then `ft.chaos` schedules for seeds
     `CHAOS_SEEDS` (at least one
     SIGKILL, mid-run join, drain and SIGSTOP stall each, fired on
     progress) against an elastic `ShardedPlan` of 2 worker processes on
     the card over `CHAOS_BATCHES` batches of 2 long chunks: every wid
     once, masks and cleaned audio bitwise equal to the in-process
     two_phase on the card, every event fired, every `bye` from the card,
     afterwards no worker process running or stopped and the card's used
     memory within 256 MiB of its level before; across the seeds at least
     one redelivery and one late joiner registered. Then
     `chaos_speculation`: the holder of the last of 6 one-chunk batches
     SIGSTOPped for 15 s at its grant, with speculation (factor 0) the idle
     worker must win a duplicate lease and the stopped one be recorded
     `"speculated"` in the telemetry; the same without speculation; both
     walls and end-of-stream tails printed.
  6. lm_serve, language-model serving (no hand kernel on its path; the
     launch counts must stay 0): the ten archs at `reduced` widths and
     f32, parameters drawn on the CPU and copied to the card, loss,
     prefill logits and one decode step's logits (its caches built by the
     engine's `decode_caches`) against the port's CPU run within rtol =
     atol = 1e-4; llama3.2-3b and zamba2-1.2b at full width and f32,
     decoding token 127 against the prefill cache of 127 tokens against
     prefill of all 128 (B = 2) within 5e-3 (zamba2's 127-token prefill
     runs its SSD scan with chunks of 1, 127 chunks a layer: the check's
     wall is printed); then llama3.2-3b and zamba2-1.2b in bf16 each:
     `launch.serve`'s LM mode in process (8 requests, batch 4, prompt 128,
     32 tokens), and a RequestQueue over one engine twice on the same 8
     prompts (the same tokens both times, each below the vocab size, each
     request answered once); xlstm-125m in bf16: greedy `generate` twice on
     4 prompts of 128 tokens, 32 new, the same tokens both times. Printed
     beside the card's line: parameters, peak memory, prefill ms (B = 4,
     S = 128) and decode ms a step (CUDA events, median of 10), generated
     tokens a second, the least times (`decode_bound_ms`,
     `prefill_bound_ms`), the Python threads alive when the phase began,
     each arch's decode step timed and traced in a fresh process
     (`scripts/lm_profile.py`: device-busy share, kernels a step) and the
     phase's wall.
  7. one JSON line with every kernel's numbers (its launches summed over
     the main-path runs, the workers' included), the whole run's wall,
     then the card's line and the result line `{"ok": true, "device":
     {...}}` last.

It imports only `repro_torch`, `torch` and numpy.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
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
       "stft_dft_generic": (2e-4, 2e-4), "fused_tail_generic": (2e-4, 2e-4),
       "main_path": (2e-4, 2e-4),
       "plan_equivalence": (1e-4, 1e-5)}   # (rtol, atol)
# kernel -> (source, the headers of csrc/ its path runs)
SOURCES = {"fir_hpf": ("fir.cu", ()),
           "stft_dft": ("stft.cu", ("fft.cuh",)),
           "mmse_stsa": ("mmse.cu", ("mmse.cuh",)),
           "fused_tail": ("fused_tail.cu", ("fft.cuh", "mmse.cuh")),
           "stft_dft_generic": ("stft.cu", ("dft.cuh",)),
           "fused_tail_generic": ("fused_tail.cu", ("dft.cuh", "mmse.cuh"))}
REPLACES = {"fir_hpf": "src/repro/kernels/fir_hpf/kernel.py:62",
            "stft_dft": "src/repro/kernels/stft_dft/kernel.py:82",
            "mmse_stsa": "src/repro/kernels/mmse_stsa/kernel.py:91",
            "fused_tail": "src/repro/kernels/fused_tail/kernel.py:201",
            "stft_dft_generic": "src/repro/kernels/stft_dft/kernel.py:82",
            "fused_tail_generic":
                "src/repro/kernels/fused_tail/kernel.py:201"}
W382 = {"stft_window": 382, "stft_hop": 191}    # a window only the DFT takes
W200 = {"stft_window": 200, "stft_hop": 100}


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
        return statistics.median(self.times(fn, reps, warmup))

    def kernel(self, fn):
        """A kernel's median (`ms`) with the least and the most of its 10
        runs and the SM clock read right after them: what tells an
        outlier from a change."""
        times = self.times(fn)
        return {"ms": statistics.median(times), "ms_min": min(times),
                "ms_max": max(times),
                "sm_clock_mhz": float(nvidia_smi("clocks.sm").split()[0])}

    def times(self, fn, reps=10, warmup=2):
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
        return times


SPREAD = ("ms_min", "ms_max", "sm_clock_mhz")   # beside every kernel's ms


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
        cu, headers = SOURCES[name]
        rec = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/kernels/csrc/{cu}",
               "headers": [f"src/repro_torch/kernels/csrc/{h}"
                           for h in headers],
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
            **timer.kernel(lambda: fir_ops.fir_cuda(x, taps_np, stride)),
            plain_ms=timer(lambda: fir_ref.fir_ref(x, taps_np, stride)),
            library_ms=timer(lambda: F.conv1d(xp, w, stride=stride)),
            n_bytes=n_bytes, n_flops=n_flops, bound_ms=b_ms, bound_by=b_by)

    # FIR: the compress stage, (4, 2,646,000) -> (4, 1,323,000), 129 taps,
    # and the staged tail's hpf stage, (48, 110,250) at stride 1
    s1 = fir_case(48, 110_250, 1, fir_ref.highpass_taps(
        cfg.hpf_cutoff_hz, cfg.target_rate_hz, cfg.hpf_taps))
    check(s1["ok"], f"fir_hpf (stride 1): kernel disagrees with its plain "
                    f"version (max |err| {s1['err']:.3g})")
    band = fir_ref.bandpass_decimate_taps(1000.0, 11_025.0, 44_100, 129)
    # the serving tier's smallest batch: one long chunk
    s1b = fir_case(1, 2_646_000, 2, band)
    check(s1b["ok"], f"fir_hpf (serving batch of 1): kernel disagrees with "
                     f"its plain version (max |err| {s1b['err']:.3g})")
    c = fir_case(4, 2_646_000, 2, band)

    def sub(d):
        return {"shape": d["shape"], "max_abs_err": d["err"], "ms": d["ms"],
                **{k: d[k] for k in SPREAD},
                "plain_ms": d["plain_ms"], "library_ms": d["library_ms"],
                "bound_ms": d["bound_ms"], "bound_by": d["bound_by"],
                "bytes": d["n_bytes"], "flops": d["n_flops"]}

    record("fir_hpf", c["shape"], c["err"], c["ok"], c["ms"], c["plain_ms"],
           c["library_ms"], c["n_bytes"], c["n_flops"],
           **{k: c[k] for k in SPREAD},
           library_call="torch.nn.functional.conv1d (cuDNN, TF32 off)",
           stride1=sub(s1), serving_batch1=sub(s1b))

    # STFT: the detection STFT, (16, 330,750) -> (16, 2582, 129); and the
    # direct-DFT path at windows 382 and 200 on the same rows
    S = 330_750
    x16 = torch.randn((16, S), generator=gen, device="cuda") * 0.3

    def stft_case(W, x):
        B = x.shape[0]
        H, K = W // 2, W // 2 + 1
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
        del got, want, lib
        n_bytes = 4 * B * ((Fr - 1) * H + W) + 4 * 3 * W + 8 * B * Fr * K
        n_flops = stft_flops(B * Fr, W)
        b_ms, b_by = bound(n_bytes, n_flops, peak_flops)
        c = dict(
            shape=f"x ({B}, {S}) -> ({B}, {Fr}, {K}) complex, W={W}",
            err=err, ok=ok,
            **timer.kernel(lambda: stft_ops.stft_cuda(x, W, H)),
            plain_ms=timer(lambda: stft_ref.stft_ref(x, W, H)),
            library_ms=timer(lambda: torch.stft(
                x, n_fft=W, hop_length=H, window=win, center=False,
                return_complex=True)),
            n_bytes=n_bytes, n_flops=n_flops, bound_ms=b_ms, bound_by=b_by,
            library_max_abs_err=lib_err)
        c["kernel_over_library"] = c["ms"] / c["library_ms"]
        return c

    def stft_record(name, c, **more):
        record(name, c["shape"], c["err"], c["ok"], c["ms"], c["plain_ms"],
               c["library_ms"], c["n_bytes"], c["n_flops"],
               **{k: c[k] for k in SPREAD},
               library_call="torch.stft (cuFFT; (B, K, F) layout)",
               library_max_abs_err=c["library_max_abs_err"],
               kernel_over_library=c["kernel_over_library"], **more)

    # the serving tier's smallest batch: one long chunk, 4 detection rows
    x4 = torch.randn((4, S), generator=gen, device="cuda") * 0.3
    c4 = stft_case(cfg.stft_window, x4)
    check(c4["ok"], f"stft_dft (serving batch of 1): kernel disagrees with "
                    f"its plain version (max |err| {c4['err']:.3g})")
    stft_record("stft_dft", stft_case(cfg.stft_window, x16),
                serving_batch1={
                    k: c4[k] for k in ("shape", "ms", *SPREAD, "plain_ms",
                                       "library_ms", "bound_ms", "bound_by",
                                       "kernel_over_library")}
                | {"max_abs_err": c4["err"], "bytes": c4["n_bytes"],
                   "flops": c4["n_flops"]})
    del x4
    c200 = stft_case(200, x16)
    check(c200["ok"], f"stft_dft_generic (W=200): kernel disagrees with its "
                      f"plain version (max |err| {c200['err']:.3g})")
    stft_record("stft_dft_generic", stft_case(382, x16), w200={
        k: c200[k] for k in ("shape", "ms", *SPREAD, "plain_ms",
                             "library_ms", "bound_ms", "bound_by",
                             "kernel_over_library")}
        | {"max_abs_err": c200["err"], "bytes": c200["n_bytes"],
           "flops": c200["n_flops"]})
    del x16

    # MMSE gain: the staged survivor tail, power (16, 860, 129), and
    # (35, 860, 129), the main path's largest survivor batch
    Fv, K = 860, cfg.n_bins
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
            **timer.kernel(lambda: mmse_ops.mmse_gain_cuda(power, noise,
                                                           *args)),
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
           **{k: m[k] for k in SPREAD},
           chain_ms=chain_ms, chain_shape=f"(1, {Fv}, 1)",
           ms_over_chain=m["ms"] / chain_ms,
           rows35={"shape": m35["shape"], "max_abs_err": m35["err"],
                   "ms": m35["ms"], **{k: m35[k] for k in SPREAD},
                   "ms_over_chain": m35["ms"] / chain_ms,
                   "bound_ms": m35["bound_ms"], "bound_by": m35["bound_by"],
                   "bytes": m35["n_bytes"], "flops": m35["n_flops"]})
    del m, m35, p1, n1

    # fused tail: wave (48, 110,250), 16 indices with one pad slot, and all
    # 48 rows; with and without the high-pass; noise_est_frames = 100; and
    # the direct-DFT kernel at windows 382 and 200
    S = 110_250
    wave48 = torch.randn((48, S), generator=gen, device="cuda") * 0.3
    real = np.sort(np.random.RandomState(7).choice(48, 15, replace=False))

    def fused_case(idx_np, tcfg, hpf, time_plain=True, wave=wave48):
        B = wave.shape[0]
        W, H = tcfg.stft_window, tcfg.stft_hop
        K = W // 2 + 1
        Fv = stft_ref.num_frames(S, W, H)
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
            shape=f"wave ({B}, {S}), idx ({len(idx_np)},) with "
                  f"{len(pads)} pad slot(s) -> ({len(idx_np)}, {Fv}, {K}) "
                  f"complex, W={W}, hpf={hpf}, "
                  f"noise_est_frames={tcfg.noise_est_frames}",
            **timer.kernel(lambda: ft_ops.fused_tail_spectrum_cuda(
                wave, idx, tcfg, hpf)),
            plain_ms=(timer(lambda: ft_ref.fused_tail_spectrum_ref(
                wave, idx, tcfg, hpf), reps=3, warmup=1) if time_plain
                else None),
            n_bytes=n_bytes, n_flops=n_flops, bound_ms=b_ms, bound_by=b_by)

    idx16 = [*real.tolist(), 48]
    idx48 = list(range(48))
    noise100 = dataclasses.replace(cfg, noise_est_frames=100)
    cases = {"hpf": fused_case(idx16, cfg, True),
             "rows48": fused_case(idx48, cfg, False, time_plain=False),
             "rows48_hpf": fused_case(idx48, cfg, True, time_plain=False),
             "noise100": fused_case(idx16, noise100, False,
                                    time_plain=False),
             "noise100_hpf": fused_case(idx16, noise100, True,
                                        time_plain=False),
             # the serving tier's smallest batch: one long chunk is 12
             # final chunks, 8 of them survivors
             "serving_batch1": fused_case(
                 np.sort(np.random.RandomState(8).choice(12, 8,
                                                         replace=False)),
                 cfg, False, wave=wave48[:12].contiguous())}
    v = fused_case(idx16, cfg, False)
    cfg382 = dataclasses.replace(cfg, **W382)
    generic = {"hpf": fused_case(idx16, cfg382, True, time_plain=False),
               # the noise prologue runs in every bin tile of a row
               "noise100": fused_case(
                   idx16, dataclasses.replace(cfg382, noise_est_frames=100),
                   False, time_plain=False),
               "w200": fused_case(idx16, dataclasses.replace(cfg, **W200),
                                  False),
               "w200_hpf": fused_case(idx16, dataclasses.replace(cfg, **W200),
                                      True, time_plain=False)}
    g = fused_case(idx16, cfg382, False)
    for name, group in (("fused_tail", cases), ("fused_tail_generic",
                                                generic)):
        for label, c in group.items():
            check(c["ok"], f"{name} ({label}): kernel disagrees with its "
                           f"plain version (max |err| {c['err']:.3g})")

    def extra(c):
        return {"rows": c["rows"], "max_abs_err": c["err"],
                "cleaned_max_abs_err": c["wave_err"], "ms": c["ms"],
                **{k: c[k] for k in SPREAD},
                "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                "bound_by": c["bound_by"], "shape": c["shape"]}

    record("fused_tail", v["shape"], v["err"], v["ok"], v["ms"],
           v["plain_ms"], None, v["n_bytes"], v["n_flops"],
           cleaned_max_abs_err=v["wave_err"], chain_ms=chain_ms,
           **{k: v[k] for k in SPREAD},
           ms_over_chain=v["ms"] / chain_ms,
           **{label: extra(c) for label, c in cases.items()})
    record("fused_tail_generic", g["shape"], g["err"], g["ok"], g["ms"],
           g["plain_ms"], None, g["n_bytes"], g["n_flops"],
           cleaned_max_abs_err=g["wave_err"], chain_ms=chain_ms,
           **{k: g[k] for k in SPREAD},
           ms_over_chain=g["ms"] / chain_ms,
           **{label: extra(c) for label, c in generic.items()})
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


STORES = ROOT / "build" / "chip_smoke" / "stores"
# cell -> (plan, plan arguments); the first is the one the others are held
# against (bitwise where they run the same fused tail), the two two_phase
# cells are also held against the port's CPU run
CELLS = {"serf_two_phase_fused": ("two_phase", {}),
         "serf_two_phase_staged": ("two_phase", {"fuse_tail": False}),
         "serf_async_fused": ("async", {}),
         "serf_streaming_fused": ("streaming", {}),
         "serf_fused": ("fused", {}),
         "serf_cached_two_phase": ("cached", {"store": str(STORES / "cold")}),
         "serf_cached_two_phase_warm": ("cached",
                                        {"store": str(STORES / "warm")}),
         "serf_sharded_inproc": ("sharded", {"shards": 2,
                                             "transport": "inproc",
                                             "lease_items": 1})}
# kernels a cell's main-path run must launch (the fused path's by default)
NEED = {"serf_two_phase_staged": ("fir_hpf", "stft_dft", "mmse_stsa"),
        "serf_fused": ("fir_hpf", "stft_dft", "mmse_stsa"),
        "serf_cached_two_phase_warm": (),
        "serf_sharded_inproc": ("fir_hpf", "stft_dft", "mmse_stsa")}
# the sharded plan with 2 real worker processes on the one card
# (`transport="proc"`, one work id a lease), over 8 batches of the stream
# (wids 0-2 the other cells' batches): cell -> further plan arguments. The
# store cell's data plane is emptied before every pass.
PROC_CELLS = {"serf_sharded_proc": {},
              "serf_sharded_proc_store": {"data_plane": str(STORES / "plane")}}
PROC_BATCHES = 8
PROC_PASSES = 3                 # timed passes of a proc cell, each with its
#                                 fleet's spawn (5 for the other cells)
PROC_NEED = ("fir_hpf", "stft_dft", "fused_tail")   # in the workers
# the cached cell whose every run starts from an emptied store (all
# misses), and the one whose store the warm-up fills (all hits)
COLD, WARM = "serf_cached_two_phase", "serf_cached_two_phase_warm"


def pageable_uploads(copies, batch_bytes):
    """The kinds of pageable host-to-device copy in `copies` that moved a
    whole batch at once."""
    return [name for name, rec in copies.items()
            if "HtoD" in name and "Pageable" in name
            and rec["max_bytes"] >= batch_bytes]


def empty_store(pre):
    """Empty a cached cell's store on disk (the plan keeps its handle)."""
    objects = Path(pre.plan.store.directory) / "objects"
    shutil.rmtree(objects)
    objects.mkdir()


def main_path(torch, np, card):
    from repro_torch import kernels
    from repro_torch.configs import SERF_AUDIO
    from repro_torch.core.plans import Preprocessor
    from repro_torch.data.loader import audio_batch_maker

    make = audio_batch_maker(seed=25, batch_long_chunks=4)
    batches = [(w, make(w)) for w in range(3)]     # set-up, not timed
    src = sum(c.nbytes for _, (c, _) in batches)
    batch_bytes = batches[0][1][0].nbytes
    shutil.rmtree(STORES, ignore_errors=True)
    cells = {label: Preprocessor(SERF_AUDIO, plan=plan, **kw)
             for label, (plan, kw) in CELLS.items()}

    def before_run(label):
        if label == COLD:
            empty_store(cells[label])

    results, launch_counts, uploads, in_flight, store_run = {}, {}, {}, {}, {}
    for label, pre in cells.items():
        check(pre.device.type == "cuda", "Preprocessor did not pick the card")
        # warm-up over one batch: cuFFT plans, the allocators, the staging
        # ring's cudaHostAlloc; over all three for the warm cached cell,
        # which fills its store
        before_run(label)
        list(pre.run(batches if label == WARM else batches[:1]))
        torch.cuda.synchronize()
        staging = getattr(pre.plan, "staging", None)
        if staging is not None:
            staging.log.clear()
        before_run(label)
        stats0 = (pre.plan.stats.as_dict() if pre.plan.name == "cached"
                  else None)
        kernels.reset_launches()
        run = list(pre.run(batches))               # the main-path run
        torch.cuda.synchronize()
        launch_counts[label] = kernels.launches()
        if stats0 is not None:                     # this run's hits, misses
            stats1 = pre.plan.stats.as_dict()
            store_run[label] = {k: stats1[k] - stats0[k]
                                for k in ("hits", "misses", "writes")}
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
            staging = getattr(cells[label].plan, "staging", None)
            logged = len(staging.log) if staging is not None else 0
            before_run(label)
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
        # (the two-phase plans; the fused, cached and sharded plans have no
        # such split)
        detect_ms, tail_ms = [], []
        split = hasattr(pre.plan, "_finish") and pre.plan.name != "sharded"
        for _, (audio, _) in (batches if split else ()):
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
        before_run(label)
        profile = device_profile(
            torch, pre, batches,
            ROOT / "build" / "chip_smoke" / f"trace_{label}.json")
        rec = {"main_path": label, "plan": pre.plan.name,
               "fuse_tail": getattr(pre.plan, "fuse_tail", None),
               "launches": counts,
               "passes": PASSES, "pass_s": pass_s, "mb_per_s_median": med,
               "mb_per_s_min": mb_per_s[0], "mb_per_s_max": mb_per_s[-1],
               "src_mb": src / 2**20, "kept": kept, "chunks": chunks,
               "detect_ms": detect_ms, "tail_ms": tail_ms,
               "timings": [r.timings for r in res], "profile": profile}
        if label in uploads:
            rec.update(depth=pre.plan.depth, in_flight=in_flight[label],
                       uploads=uploads[label],
                       pass_staging_ms=pass_staging[label])
        if label in store_run:
            # the content keys of one pass alone (sha256 of the source on
            # the host), three times: what of the pass no kernel does
            hash_ms = []
            for _ in range(3):
                t1 = time.perf_counter()
                for _, (audio, _) in batches:
                    pre.plan._key(audio)
                hash_ms.append((time.perf_counter() - t1) * 1e3)
            rec.update(store_main_path_run=store_run[label],
                       store=pre.plan.stats.as_dict(),
                       hash_ms_per_pass=hash_ms)
        runs[label] = dict(rec, res=res)
        note = {COLD: " (cold: every pass starts from an emptied store; "
                      "kernels + hashing + disk writes)",
                WARM: " (warm: every batch a hit; hashing + disk reads, "
                      "no kernel)"}.get(label, "")
        print(f"plan={pre.plan.name} cell={label} card={card}  "
              f"{src / 2**20:.0f} MB source audio per pass, median of "
              f"{PASSES} passes  ->  {med:.2f} MB/s "
              f"({mb_per_s[0]:.2f}-{mb_per_s[-1]:.2f}){note}", flush=True)
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
    check(not any(runs[WARM]["launches"].values()),
          f"{WARM}: a warm pass launched kernels {runs[WARM]['launches']}")
    for label, want in ((COLD, {"hits": 0, "misses": 3, "writes": 3}),
                        (WARM, {"hits": 3, "misses": 0, "writes": 0})):
        check(runs[label]["store_main_path_run"] == want,
              f"{label}: the main-path run's store counts are "
              f"{runs[label]['store_main_path_run']}, not {want}")
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
                  "serf_streaming_fused", "serf_fused", COLD, WARM):
        bitwise = label not in ("serf_two_phase_staged", "serf_fused")
        for a, b in zip(base, runs[label]["res"]):
            check(a.wid == b.wid, f"{label}: batches out of order")
            check_masks(a.det, b.det, f"{label} against two_phase's")
            if label == "serf_fused":
                continue              # held against the staged cell below
            check(a.cleaned.shape == b.cleaned.shape and (
                np.array_equal(a.cleaned, b.cleaned) if bitwise
                else np.allclose(a.cleaned, b.cleaned, rtol=2e-4,
                                 atol=2e-4)),
                f"{label}: cleaned audio differs from two_phase's fused "
                f"tail" + (" (bitwise)" if bitwise else " beyond 2e-4"))
    for r in runs[WARM]["res"]:
        check(not bool(r.det.wave5.any()), f"{WARM}: a hit's wave5 is not "
                                           f"zeros")
    # the no-early-exit plan's kept rows against the staged two_phase
    # survivors: the same STFT and MMSE kernels on the same rows
    diffs, bitwise = [], True
    for a, b in zip(runs["serf_two_phase_staged"]["res"],
                    runs["serf_fused"]["res"]):
        check(a.cleaned.shape == b.cleaned.shape,
              f"serf_fused: kept rows {b.cleaned.shape} against the staged "
              f"cell's {a.cleaned.shape}")
        bitwise &= bool(np.array_equal(a.cleaned, b.cleaned))
        diffs.append(float(np.abs(a.cleaned - b.cleaned).max())
                     if a.n_kept else 0.0)
        check(np.allclose(b.cleaned, a.cleaned,
                          *TOL["plan_equivalence"]),
              f"serf_fused: kept rows differ from the staged cell's "
              f"survivors beyond rtol 1e-4 / atol 1e-5 (max |err| "
              f"{max(diffs):.3g})")
    print(json.dumps({"serf_fused_vs_staged": {
        "bitwise": bitwise, "max_abs_diff": diffs}}), flush=True)
    # the in-process sharded cell: the same detection as two_phase (masks
    # equal), its survivors re-sliced across 2 shards for the staged tail
    # (cleaned within the plan-equivalence bound of the staged cell)
    diffs, bitwise = [], True
    for a, b, c in zip(base, runs["serf_two_phase_staged"]["res"],
                       runs["serf_sharded_inproc"]["res"]):
        check(a.wid == c.wid, "serf_sharded_inproc: batches out of order")
        check_masks(a.det, c.det, "serf_sharded_inproc against two_phase's")
        check(b.cleaned.shape == c.cleaned.shape,
              f"serf_sharded_inproc: cleaned {c.cleaned.shape} against the "
              f"staged cell's {b.cleaned.shape}")
        bitwise &= bool(np.array_equal(b.cleaned, c.cleaned))
        diffs.append(float(np.abs(b.cleaned - c.cleaned).max())
                     if b.n_kept else 0.0)
        check(np.allclose(c.cleaned, b.cleaned, *TOL["plan_equivalence"]),
              f"serf_sharded_inproc: cleaned audio differs from the staged "
              f"cell's beyond rtol 1e-4 / atol 1e-5 (max |err| "
              f"{max(diffs):.3g})")
    print(json.dumps({"serf_sharded_inproc_vs_staged": {
        "bitwise": bitwise, "max_abs_diff": diffs}}), flush=True)

    # batch 0 against the port's own CPU run on the same numpy input
    chunks0 = batches[0][1][0]
    cpu_pre = Preprocessor(SERF_AUDIO, plan="two_phase", device="cpu")
    cpu = cpu_pre(chunks0)
    report = {label: against_cpu(torch, np, label, runs[label]["res"][0],
                                 cpu, cpu_pre.graph, chunks0)
              for label in ("serf_two_phase_fused", "serf_two_phase_staged")}
    print(json.dumps({"batch0_vs_cpu": report, "kept": cpu.n_kept,
                      "chunks": int(cpu.det.keep.numel())}), flush=True)

    kill_and_resume(torch, np, batches, base)
    runs["serf_w382_two_phase"] = window382(
        torch, np, batches, cells["serf_two_phase_fused"], card)
    # the in-process cells' buffers go before the workers take the card
    del cells, results, cpu_pre, cpu
    stream8 = batches + [(w, make(w)) for w in range(3, PROC_BATCHES)]
    runs.update(proc_cells(torch, np, stream8, base, card))
    runs.update(serve_cells(torch, np, batches, base, stream8))
    runs.update(chaos_phases(np))
    return runs


# ------------------------------------------------- the worker-process cells

def gpu_apps():
    """The card's compute processes as `nvidia-smi` lists them, [(pid,
    used memory)], and the card's used memory in MiB."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    apps = []
    for line in out.stdout.strip().splitlines():
        pid, _, mem = line.partition(",")
        if pid.strip().isdigit():
            apps.append((int(pid), mem.strip()))
    return {"apps": apps,
            "used_mib": float(nvidia_smi("memory.used").split()[0])}


def check_workers_on_card(label, pids, during, after):
    """The workers held contexts on the card while their fleet ran. Where
    `nvidia-smi` lists this process's own pid among the compute processes,
    each worker pid must be listed too. A machine whose process namespace
    `nvidia-smi` cannot see lists other pids (one entry, pid 1): there the
    card's used memory must have dropped, once the fleet exited, by at
    least 256 MiB a worker (a CUDA context and its allocations). Returns
    which of the two was held."""
    listed = {pid for pid, _ in during["apps"]}
    if os.getpid() in listed:
        check(set(pids) <= listed,
              f"{label}: worker pids {pids} are not among the card's "
              f"compute processes {sorted(listed)}")
        return "pids listed"
    freed = during["used_mib"] - after["used_mib"]
    check(freed >= 256 * len(pids),
          f"{label}: the card's used memory fell by {freed:.0f} MiB when "
          f"the {len(pids)} workers exited (nvidia-smi lists pids "
          f"{sorted(listed)}, not this namespace's)")
    return f"memory freed at exit: {freed:.0f} MiB"


def plane_bytes():
    """The data-plane bytes this process's metrics registry has counted
    so far: fetched and pushed, through the master's socket and the
    store."""
    from repro_torch.obs import metrics as obs_metrics
    snap = obs_metrics.get_registry().snapshot()
    out = {}
    for d in ("fetch", "push"):
        series = snap.get(f"dist_{d}_bytes_total", {"series": []})["series"]
        for plane in ("socket", "store"):
            out[f"{d}_bytes_{plane}"] = sum(
                x["value"] for x in series if x["labels"]["plane"] == plane)
    return out


def proc_pass(pre, batches, watch=None):
    """One run of a proc cell over the stream, as a user makes it: the
    fleet's spawn, the 8 batches, the workers' sign-off. Returns (results,
    wall seconds, what `watch` returned when it was called once, after
    the first result, while the fleet still ran, the data-plane bytes the
    run moved)."""
    dp = pre.plan.data_plane
    if dp is not None:
        shutil.rmtree(dp, ignore_errors=True)
    before = plane_bytes()
    t0 = time.perf_counter()
    out, seen = [], None
    for r in pre.run(batches):
        out.append(r)
        if watch is not None and len(out) == 1:
            seen = watch()
    wall = time.perf_counter() - t0
    moved = {k: v - before[k] for k, v in plane_bytes().items()}
    return out, wall, seen, moved


def fleet_record(plan, moved):
    """What one proc run's master saw: the fleet's start (run() to the
    last hello), each worker's idle/busy split and launches, and the
    data-plane bytes through the master's socket and the store (`moved`,
    from `proc_pass`)."""
    return {"fleet_start_s": plan.fleet_start_s,
            "redeliveries": plan.redeliveries,
            "workers": [{"worker": st.worker, "pid": st.pid,
                         "state": st.state, "chunks_done": st.chunks_done,
                         "idle_s": st.idle_s, "busy_s": st.busy_s,
                         "launches": (st.report or {}).get("launches"),
                         "cuda_reserved_bytes": (st.report or {}).get(
                             "cuda_reserved_bytes")}
                        for st in plan.worker_stats],
            "bytes": moved}


def proc_cells(torch, np, batches, base, card):
    """The sharded plan over 2 worker processes on the card, socket and
    store data planes: a main-path run per cell (the master's launch counts
    set to 0 before and read after: none, every kernel is launched in the
    workers, which report theirs at sign-off; the workers' pids listed by
    `nvidia-smi` while the fleet runs), checks against the fused two_phase
    cell (batches 0-2 bitwise, every wid once and in order), PROC_PASSES
    timed passes in turns, then the kill phase."""
    from repro_torch import kernels
    from repro_torch.configs import SERF_AUDIO
    from repro_torch.core.plans import Preprocessor

    src = sum(c.nbytes for _, (c, _) in batches)
    cells = {label: Preprocessor(SERF_AUDIO, plan="sharded", shards=2,
                                 transport="proc", lease_items=1, **kw)
             for label, kw in PROC_CELLS.items()}
    runs = {}
    for label, pre in cells.items():
        check(pre.device.type == "cuda", "Preprocessor did not pick the card")
        kernels.reset_launches()
        res, wall, during, moved = proc_pass(pre, batches, watch=gpu_apps)
        master = kernels.launches()
        time.sleep(1.0)             # the exited workers' contexts freed
        after = gpu_apps()
        fleet = fleet_record(pre.plan, moved)
        reports = [st.report or {} for st in pre.plan.worker_stats]
        launches = {n: sum(r.get("launches", {}).get(n, 0) for r in reports)
                    for n in kernels.KERNELS}
        pids = sorted(st.pid for st in pre.plan.worker_stats)
        rec = {"main_path": label, "plan": "sharded", "transport": "proc",
               "data_plane": "store" if PROC_CELLS[label] else "socket",
               "launches": launches, "master_launches": master,
               "master_pid": os.getpid(), "worker_pids": pids,
               "gpu_apps_during": during, "gpu_apps_after": after,
               "wall_s": wall, "batches": len(batches), **fleet}
        print(json.dumps(rec), flush=True)
        rec["workers_on_card"] = check_workers_on_card(label, pids, during,
                                                       after)
        print(f"{label}: worker pids {pids} on the card ("
              f"{rec['workers_on_card']}); nvidia-smi compute apps while "
              f"the fleet ran: {during['apps']}", flush=True)
        check([r.wid for r in res] == list(range(len(batches))),
              f"{label}: emitted {[r.wid for r in res]}, not every wid "
              f"once in order")
        check(len(reports) == 2 and all(r.get("device") == "cuda"
                                        for r in reports),
              f"{label}: the workers did not all sign off from the card")
        check(all((r.get("cuda_reserved_bytes") or 0) > 0 for r in reports),
              f"{label}: a worker held no memory on the card at sign-off")
        for n in PROC_NEED:
            check(launches[n] > 0, f"{label}: the workers never launched "
                                   f"kernel {n}")
        check(not any(master.values()),
              f"{label}: the master launched kernels {master}")
        for r in res:
            check(r.cleaned.shape == (r.n_kept,
                                      SERF_AUDIO.final_split_samples)
                  and np.isfinite(r.cleaned).all(),
                  f"{label}: cleaned batch {r.wid} is malformed")
        for a, b in zip(base, res):
            check_masks(a.det, b.det, f"{label} against two_phase's")
            check(np.array_equal(a.cleaned, b.cleaned),
                  f"{label}: batch {b.wid} differs from two_phase's fused "
                  f"cell (bitwise)")
        runs[label] = dict(rec, res=res)

    pass_times = {label: [] for label in cells}
    fleets = {label: [] for label in cells}
    for rep in range(PROC_PASSES):
        for label in (list(cells) if rep % 2 == 0 else list(cells)[::-1]):
            _, wall, _, moved = proc_pass(cells[label], batches)
            pass_times[label].append(wall)
            fleets[label].append(fleet_record(cells[label].plan, moved))
    for label, pre in cells.items():
        mb_per_s = sorted(src / 2**20 / s for s in pass_times[label])
        med = statistics.median(mb_per_s)
        kept = sum(r.n_kept for r in runs[label]["res"])
        chunks = sum(int(r.det.keep.numel()) for r in runs[label]["res"])
        runs[label].update(passes=PROC_PASSES, pass_s=pass_times[label],
                           mb_per_s_median=med, mb_per_s_min=mb_per_s[0],
                           mb_per_s_max=mb_per_s[-1], src_mb=src / 2**20,
                           kept=kept, chunks=chunks, pass_fleets=fleets[label])
        plane = runs[label]["data_plane"]
        print(f"plan=sharded cell={label} card={card}  {src / 2**20:.0f} MB "
              f"source audio per pass, 2 worker processes, data plane "
              f"{plane}, median of {PROC_PASSES} passes (fleet spawn "
              f"included)  ->  {med:.2f} MB/s ({mb_per_s[0]:.2f}-"
              f"{mb_per_s[-1]:.2f})", flush=True)
        print(f"chunks kept {kept}/{chunks} ({label})", flush=True)
        for i, f in enumerate(fleets[label]):
            split = ", ".join(f"{w['worker']} idle {w['idle_s']:.3f} s / busy "
                              f"{w['busy_s']:.3f} s" for w in f["workers"])
            b = f["bytes"]
            print(f"{label} pass {i}: fleet start {f['fleet_start_s']:.3f} s; "
                  f"{split}; socket {b['fetch_bytes_socket'] / 2**20:.1f} MB "
                  f"out + {b['push_bytes_socket'] / 2**20:.1f} MB back, "
                  f"store keys {b['fetch_bytes_store']} B out + "
                  f"{b['push_bytes_store']} B back", flush=True)
        print(json.dumps({k: v for k, v in runs[label].items()
                          if k != "res"}), flush=True)

    sharded_proc_kill(np, batches, runs["serf_sharded_proc"]["res"])
    for rec in runs.values():
        del rec["res"]
    return runs


def sharded_proc_kill(np, batches, want):
    """A CrashInjector SIGKILLs shard 1 at its second lease, while it
    holds it: each wid must be emitted exactly once, bitwise equal to the
    unkilled run of the socket-plane cell (`want`), and the lease must
    have been redelivered."""
    from repro_torch.configs import SERF_AUDIO
    from repro_torch.core.plans import Preprocessor
    from repro_torch.ft.failure import CrashInjector

    inj = CrashInjector()
    inj.kill(1, after_items=1)
    pre = Preprocessor(SERF_AUDIO, plan="sharded", shards=2,
                       transport="proc", lease_items=1, injector=inj)
    res, wall, _, moved = proc_pass(pre, batches)
    rec = {"sharded_proc_kill": {
        "emitted": [r.wid for r in res], "wall_s": wall,
        "killed_alive": inj.alive(1), **fleet_record(pre.plan, moved)}}
    print(json.dumps(rec), flush=True)
    check([r.wid for r in res] == list(range(len(batches))),
          f"sharded_proc_kill: emitted {[r.wid for r in res]}, not every "
          f"wid exactly once")
    check(not inj.alive(1), "sharded_proc_kill: shard 1 was never killed")
    check(pre.plan.redeliveries >= 1,
          "sharded_proc_kill: the killed worker's lease was not redelivered")
    for r, w in zip(res, want):
        check_masks(r.det, w.det, f"sharded_proc_kill, batch {r.wid}")
        check(np.array_equal(r.cleaned, w.cleaned),
              f"sharded_proc_kill: batch {r.wid} differs from the unkilled "
              f"run (bitwise)")
    return rec

# ------------------------------------------------------- the serving cells

SERVE_WAVES = 3
SERVE_CLIENTS = 4
SERVE_PER_CLIENT = 3            # 4 clients x 3 requests = 12 a wave
SERVE_NEED = ("fir_hpf", "stft_dft", "fused_tail")
OBS_PASSES = 3                  # timed passes each with observability on / off


def serve_wave(np, batcher, chunks):
    """One wave of 12 requests: SERVE_CLIENTS threads each send
    SERVE_PER_CLIENT single long chunks one after another (submit, wait
    for the answer, the next); client c's request i is chunk
    c * SERVE_PER_CLIENT + i. Returns (record by request id, chunk index
    by request id, latencies in s, wall s)."""
    import threading
    recs, which, lat, errors = {}, {}, [], []
    lock = threading.Lock()

    def client(c):
        try:
            for i in range(SERVE_PER_CLIENT):
                k = c * SERVE_PER_CLIENT + i
                t0 = time.perf_counter()
                rid = batcher.submit(chunks[k])
                rec = batcher.wait(rid, timeout_s=300.0)
                dt = time.perf_counter() - t0
                with lock:
                    if rid in recs:
                        errors.append(f"request {rid} answered twice")
                    recs[rid], which[rid] = rec, k
                    lat.append(dt)
        except Exception as e:          # reported, then the phase fails
            errors.append(f"client {c}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    check(not errors, f"serving wave failed: {errors}")
    return recs, which, lat, wall


def wave_record(np, i, log, lat, wall, pids):
    """What one wave showed: wall time, requests a second, request latency
    p50 and max (a wave holds 12 requests: too few for a p99; the cell
    reports its p99 over all its waves), the batches by occupancy (real
    rows / padded rows) and the workers' pids."""
    occ = {}
    for e in log:
        key = f"{e['n_real']}/{e['rows']}"
        occ[key] = occ.get(key, 0) + 1
    return {"wave": i, "requests": len(lat), "wall_s": wall,
            "req_per_s": len(lat) / wall,
            "p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "max_ms": float(np.max(lat)) * 1e3,
            "batches": len(log), "occupancy": occ, "pids": pids}


def latency_record(np, lats):
    """Request latency over every wave of a cell, in ms."""
    return {"requests": len(lats),
            "p50_ms": float(np.percentile(lats, 50)) * 1e3,
            "p99_ms": float(np.percentile(lats, 99)) * 1e3,
            "max_ms": float(np.max(lats)) * 1e3}


def check_served(np, label, log, recs, which, chunks, two_phase):
    """Every request answered once, ok, and in exactly one dispatched
    batch; every batch, rebuilt from `batch_log` with its zero pad rows
    and run through the in-process fused two_phase on the card, gives
    each of its requests the masks and cleaned rows it was served, bitwise.
    Returns the number of batches checked."""
    rids = sorted(r for e in log for r in e["rids"])
    check(rids == sorted(recs), f"{label}: the batches hold requests "
                                f"{rids}, not each answered one once")
    bad = [rid for rid, rec in recs.items() if not rec["ok"]]
    check(not bad, f"{label}: requests {bad} were not served")
    for e in log:
        batch = np.stack([chunks[which[r]] for r in e["rids"]])
        if e["rows"] > len(e["rids"]):
            batch = np.concatenate([batch, np.zeros(
                (e["rows"] - len(e["rids"]),) + batch.shape[1:],
                np.float32)])
        res = two_phase(batch)
        masks = {m: getattr(res.det, m).cpu().numpy()
                 for m in ("keep", "rain", "silence")}
        per = masks["keep"].size // e["rows"]
        offs = np.concatenate([[0], np.cumsum(masks["keep"])]).astype(int)
        for j, rid in enumerate(e["rids"]):
            lo, hi = j * per, (j + 1) * per
            rec = recs[rid]
            for m, v in masks.items():
                check(np.array_equal(rec[m], v[lo:hi]),
                      f"{label}: request {rid}'s {m} mask differs from the "
                      f"in-process two_phase on its batch")
            check(np.array_equal(rec["cleaned"],
                                 res.cleaned[offs[lo]:offs[hi]]),
                  f"{label}: request {rid}'s cleaned rows differ from the "
                  f"in-process two_phase on its batch (bitwise)")
    return len(log)


def wait_for_hellos(pool, n, timeout_s=180.0):
    """Seconds from now until `n` workers have signed in to the pool."""
    deadline = time.monotonic() + timeout_s
    while len(pool.service.workers) < n:
        check(time.monotonic() < deadline,
              f"only {len(pool.service.workers)} of {n} workers signed in "
              f"within {timeout_s:.0f} s")
        check(len(pool.pids) == n, "a pool worker exited before its hello")
        time.sleep(0.01)


def serve_cell(torch, np, label, transport, chunks, two_phase):
    """A WorkerPool of 2 workers (threads of this process, or processes
    on the one card) behind ContinuousBatcher(max_batch=4, linger_s=0.02),
    3 waves of 12 requests on the same pool. The launch counts are set to
    0 before the pool starts and read after it shut down: in the proc
    cell the master's stay 0 and the workers report theirs at sign-off."""
    from repro_torch import kernels
    from repro_torch.configs import SERF_AUDIO
    from repro_torch.serve import ContinuousBatcher, WorkerPool

    procs = transport == "proc"
    kernels.reset_launches()
    t0 = time.monotonic()
    pool = WorkerPool(SERF_AUDIO, workers=2, transport=transport,
                      poll_s=0.002).start()
    ok = False
    try:
        check(pool.device.type == "cuda", f"{label}: the pool is not on "
                                          f"the card")
        fleet_start_s = None
        if procs:
            wait_for_hellos(pool, 2)
            fleet_start_s = max(st.joined_at for st in
                                pool.service.workers.values()) - t0
        batcher = ContinuousBatcher(pool=pool, max_batch=4, linger_s=0.02)
        waves, recs, which, lats = [], {}, {}, []
        with batcher:
            for i in range(SERVE_WAVES):
                n0 = len(batcher.batch_log)
                r, w, lat, wall = serve_wave(np, batcher, chunks)
                recs.update(r)
                which.update(w)
                lats += lat
                pids = sorted(pool.pids.values()) if procs else [os.getpid()]
                waves.append(wave_record(np, i, list(batcher.batch_log)[n0:],
                                         lat, wall, pids))
                print(json.dumps({label: waves[-1]}), flush=True)
        log = list(batcher.batch_log)
        stats = batcher.stats()
        during = gpu_apps() if procs else None
        ok = True
    finally:
        pool.shutdown(drain=ok)
    master = kernels.launches()
    rec = {"main_path": label, "plan": "serve", "transport": transport,
           "workers": 2, "max_batch": 4, "linger_s": 0.02,
           "fleet_start_s": fleet_start_s, "waves": waves,
           "latency": latency_record(np, lats), "batcher": stats,
           "master_launches": master}
    if procs:
        time.sleep(1.0)             # the exited workers' contexts freed
        after = gpu_apps()
        reports = [st.report or {} for st in pool.worker_stats]
        pids = sorted(st.pid for st in pool.worker_stats)
        rec.update(
            launches={n: sum(r.get("launches", {}).get(n, 0)
                             for r in reports) for n in kernels.KERNELS},
            worker_reports=[{"worker": st.worker, "pid": st.pid,
                             "chunks_done": st.chunks_done,
                             "device": (st.report or {}).get("device"),
                             "launches": (st.report or {}).get("launches"),
                             "cuda_reserved_bytes": (st.report or {}).get(
                                 "cuda_reserved_bytes"),
                             "idle_s": st.idle_s, "busy_s": st.busy_s}
                            for st in pool.worker_stats],
            gpu_apps_during=during, gpu_apps_after=after,
            workers_on_card=check_workers_on_card(label, pids, during,
                                                  after))
        check(all(w["pids"] == waves[0]["pids"] for w in waves)
              and len(waves[0]["pids"]) == 2,
              f"{label}: the workers' pids changed between waves "
              f"{[w['pids'] for w in waves]}")
        check(not any(master.values()),
              f"{label}: the master launched kernels {master}")
        check(len(reports) == 2 and all(r.get("device") == "cuda"
                                        for r in reports),
              f"{label}: the workers did not all sign off from the card")
        check(all((r.get("cuda_reserved_bytes") or 0) > 0 for r in reports),
              f"{label}: a worker held no memory on the card at sign-off")
    else:
        rec["launches"] = master
    for n in SERVE_NEED:
        check(rec["launches"][n] > 0, f"{label}: kernel {n} was never "
                                      f"launched")
    check(len(recs) == SERVE_WAVES * SERVE_CLIENTS * SERVE_PER_CLIENT,
          f"{label}: {len(recs)} requests answered")
    rec["batches_checked"] = check_served(np, label, log, recs, which,
                                          chunks, two_phase)
    print(json.dumps(rec), flush=True)
    for w in waves:
        print(f"{label} wave {w['wave']}: {w['requests']} requests in "
              f"{w['wall_s']:.3f} s ({w['req_per_s']:.2f} req/s), latency "
              f"p50 {w['p50_ms']:.1f} ms max {w['max_ms']:.1f} ms, "
              f"occupancy {w['occupancy']}, pids {w['pids']}", flush=True)
    la = rec["latency"]
    print(f"{label}: latency over the {la['requests']} requests p50 "
          f"{la['p50_ms']:.1f} ms p99 {la['p99_ms']:.1f} ms max "
          f"{la['max_ms']:.1f} ms", flush=True)
    if fleet_start_s is not None:
        print(f"{label}: fleet start {fleet_start_s:.3f} s (pool start to "
              f"the last hello)", flush=True)
    return rec


def serve_proc_kill(torch, np, chunks, two_phase):
    """A proc pool of 2 with respawn: shard 0 is SIGKILLed the moment it
    is granted its first lease, holding it. Every request must be served
    once and bitwise, the lease redelivered, one respawn, and the new
    shard 0 process must sign off from the card. The waves' records keep
    their latencies: the respawn shows in them."""
    from repro_torch.configs import SERF_AUDIO
    from repro_torch.serve import ContinuousBatcher, WorkerPool

    pool = WorkerPool(SERF_AUDIO, workers=2, transport="proc", poll_s=0.002,
                      respawn=True).start()
    killed = []
    ok = False
    try:
        wait_for_hellos(pool, 2)
        first_pid = pool.pids[0]

        def on_grant(worker, wid):
            if worker == "shard0" and not killed:
                killed.append(wid)
                pool.kill_worker(0)

        pool.service.on_grant = on_grant
        batcher = ContinuousBatcher(pool=pool, max_batch=4, linger_s=0.02)
        recs, which, log, waves, lats = {}, {}, [], [], []
        with batcher:
            for i in range(SERVE_WAVES):       # until shard 0 took a lease
                n0 = len(batcher.batch_log)
                r, w, lat, wall = serve_wave(np, batcher, chunks)
                recs.update(r)
                which.update(w)
                lats += lat
                waves.append(wave_record(np, i, list(batcher.batch_log)[n0:],
                                         lat, wall, sorted(pool.pids.values())))
                if killed:
                    break
        log = list(batcher.batch_log)
        ok = True
    finally:
        pool.shutdown(drain=ok)
    st0 = pool.service.workers["shard0"]
    rec = {"serve_proc_kill": {
        "killed_at_wid": killed, "killed_pid": first_pid,
        "respawned_pid": st0.pid, "respawns": pool.respawns,
        "redeliveries": pool.queue.redeliveries, "requests": len(recs),
        "respawned_device": (st0.report or {}).get("device"),
        "respawned_launches": (st0.report or {}).get("launches"),
        "waves": waves, "latency": latency_record(np, lats)}}
    print(json.dumps(rec), flush=True)
    check(killed, "serve_proc_kill: shard 0 never took a lease")
    check(pool.respawns == 1, f"serve_proc_kill: {pool.respawns} respawns, "
                              f"not 1")
    check(pool.queue.redeliveries >= 1,
          "serve_proc_kill: the killed worker's lease was not redelivered")
    check(st0.pid != first_pid and (st0.report or {}).get("device")
          == "cuda", "serve_proc_kill: the respawned shard 0 did not sign "
                     "off from the card")
    check_served(np, "serve_proc_kill", log, recs, which, chunks, two_phase)
    return rec


def obs_phase(torch, np, batches, base, stream8):
    """The fused two_phase cell with the metrics registry, a tracer and
    telemetry on against all off, OBS_PASSES passes each in turns: the
    output bitwise equal to the main path's fused cell both ways, the trace
    through `validate_chrome_trace`, one telemetry "done" record per work
    id, the MB/s of on over off (reported, not gated). Then one pass of
    the serf_sharded_proc cell under a tracer: the workers' lease / fetch
    / compute / push spans must arrive parented under the master's run
    span."""
    from repro_torch.configs import SERF_AUDIO
    from repro_torch.core.plans import Preprocessor
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import telemetry as obs_telemetry
    from repro_torch.obs import tracing as obs_tracing

    out_dir = ROOT / "build" / "chip_smoke" / "obs"
    shutil.rmtree(out_dir, ignore_errors=True)
    src = sum(c.nbytes for _, (c, _) in batches)
    pre = Preprocessor(SERF_AUDIO, plan="two_phase")
    list(pre.run(batches[:1]))                     # warm-up
    torch.cuda.synchronize()
    prev = obs_metrics.get_registry()

    def one_pass(on, k):
        reg = obs_metrics.MetricsRegistry() if on else \
            obs_metrics.NullRegistry()
        obs_metrics.set_registry(reg)
        tracer = obs_tracing.Tracer() if on else None
        obs_tracing.set_tracer(tracer)
        writer = (obs_telemetry.TelemetryWriter(out_dir / f"telemetry{k}")
                  if on else None)
        try:
            if tracer is not None:
                tracer.start_run("obs_run")
            t0 = time.perf_counter()
            out = []
            for r in pre.run(batches):
                out.append(r)
                if writer is not None:
                    obs_telemetry.record_result(writer, r.wid, r)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if tracer is not None:
                tracer.finish_run()
        finally:
            obs_metrics.set_registry(prev)
            obs_tracing.set_tracer(None)
            if writer is not None:
                writer.close()
        return out, dt, reg, tracer

    times = {True: [], False: []}
    for k in range(OBS_PASSES):
        for on in ((False, True) if k % 2 == 0 else (True, False)):
            out, dt, reg, tracer = one_pass(on, k)
            times[on].append(dt)
            for a, b in zip(base, out):
                check_masks(a.det, b.det, f"obs (on={on}) against two_phase's")
                check(np.array_equal(a.cleaned, b.cleaned),
                      f"obs: with observability on={on} batch {b.wid} "
                      f"differs from the fused two_phase cell (bitwise)")
            if not on:
                continue
            counts = obs_tracing.validate_chrome_trace(tracer.chrome())
            tracer.save(out_dir / "trace_two_phase.json")
            recs = obs_telemetry.read_records(str(out_dir / f"telemetry{k}"))
            done = sorted(r["wid"] for r in recs if r["status"] == "done")
            check(done == [w for w, _ in batches],
                  f"obs: telemetry done records for wids {done}")
            (nb,) = reg.snapshot()["plan_batches_total"]["series"]
            check(nb["value"] == len(batches),
                  f"obs: plan_batches_total is {nb['value']}")
    mb = {on: sorted(src / 2**20 / t for t in times[on]) for on in times}
    ratio = statistics.median(mb[True]) / statistics.median(mb[False])

    # one serf_sharded_proc pass under a tracer
    tracer = obs_tracing.Tracer()
    obs_tracing.set_tracer(tracer)
    try:
        tracer.start_run("sharded_proc_run")
        sp = Preprocessor(SERF_AUDIO, plan="sharded", shards=2,
                          transport="proc", lease_items=1)
        res = list(sp.run(stream8))
        tracer.finish_run()
    finally:
        obs_tracing.set_tracer(None)
    trace = tracer.chrome()
    phases = obs_tracing.validate_chrome_trace(trace)
    tracer.save(out_dir / "trace_sharded_proc.json")
    pids = {st.pid for st in sp.plan.worker_stats}
    worker_evs = [e for e in trace["traceEvents"] if e["pid"] in pids]
    names = sorted({e["name"] for e in worker_evs})
    orphans = [e["name"] for e in worker_evs
               if e["args"].get("trace") != tracer.trace_id
               or (e["ph"] != "E"
                   and e["args"].get("parent") != tracer.run_span_id)]
    rec = {"obs": {"passes": OBS_PASSES, "mb_per_s_on": mb[True],
                   "mb_per_s_off": mb[False], "on_over_off": ratio,
                   "trace_events": counts, "bitwise": True,
                   "sharded_proc": {"trace_phases": phases,
                                    "worker_pids": sorted(pids),
                                    "worker_events": len(worker_evs),
                                    "worker_span_names": names,
                                    "orphans": orphans[:10]}}}
    print(json.dumps(rec), flush=True)
    print(f"obs: two_phase fused with metrics + tracing + telemetry on "
          f"{statistics.median(mb[True]):.2f} MB/s against off "
          f"{statistics.median(mb[False]):.2f} MB/s (on/off {ratio:.3f}, "
          f"median of {OBS_PASSES} passes each); output bitwise equal",
          flush=True)
    check([r.wid for r in res] == list(range(len(stream8))),
          "obs: the traced sharded proc pass did not emit every wid once")
    for a, b in zip(base, res):
        check(np.array_equal(a.cleaned, b.cleaned),
              f"obs: the traced sharded proc pass differs at batch {b.wid}")
    check({"lease", "fetch_many", "compute", "push"} <= set(names),
          f"obs: the workers' spans are missing from the trace ({names})")
    check(not orphans, f"obs: worker spans not parented under the run "
                       f"span: {orphans[:10]}")
    return rec


def serve_cells(torch, np, batches, base, stream8):
    """The serving cells on the main path's 12 long chunks, the kill
    phase, then the observability phase."""
    from repro_torch.configs import SERF_AUDIO
    from repro_torch.core.plans import Preprocessor
    chunks = [c for _, (cs, _) in batches for c in cs]
    two_phase = Preprocessor(SERF_AUDIO, plan="two_phase")
    runs = {label: serve_cell(torch, np, label, transport, chunks,
                              two_phase)
            for label, transport in (("serf_serve_inproc", "inproc"),
                                     ("serf_serve_proc", "proc"))}
    serve_proc_kill(torch, np, chunks, two_phase)
    obs_phase(torch, np, batches, base, stream8)
    return runs


# ---------------------------------------------------------- the chaos phases

CHAOS_SEEDS = (11, 23, 37)
CHAOS_BATCHES = 6               # batches of 2 long chunks a seed's stream
CHAOS_NEED = ("fir_hpf", "stft_dft", "fused_tail")
CHAOS_MEM_SLACK_MIB = 256       # the card's used memory after a chaos run
SPEC_BATCHES = 6
SPEC_STALL_S = 15.0


def proc_state(pid):
    """The state letter in /proc/<pid>/stat ("T": stopped), None once the
    pid is gone."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0]
    except OSError:
        return None


def used_mib():
    return float(nvidia_smi("memory.used").split()[0])


def fleet_leftovers(fleet):
    """Worker processes of a finished run still running or stopped:
    [(shard, pid, state)]."""
    out = []
    for k, h in sorted(fleet.handles.items()):
        st = proc_state(h.pid)
        if h.poll() is None or st in ("T", "t"):
            out.append((k, h.pid, st))
    return out


def memory_back(before, slack):
    """The card's used memory, read until it is within `slack` MiB of
    `before` (the exited workers' contexts are freed a moment after they
    exit) or 20 s have passed."""
    for _ in range(40):
        now = used_mib()
        if now <= before + slack:
            break
        time.sleep(0.5)
    return now


def caching_maker(make):
    """`make` remembering what it made: the chaos run's batches, later
    compared with two_phase on the same arrays without synthesising
    them again."""
    made = {}

    def get(wid):
        if wid not in made:
            made[wid] = make(wid)
        return made[wid]
    return get, made


def check_against_two_phase(np, label, results, made, two_phase, n):
    wids = sorted(r.wid for r in results)
    check(wids == list(range(n)),
          f"{label}: emitted {wids}, not every wid exactly once")
    for r in results:
        want = two_phase(made[r.wid][0])
        check_masks(want.det, r.det, f"{label}, batch {r.wid}")
        check(np.array_equal(want.cleaned, r.cleaned),
              f"{label}: batch {r.wid} differs from two_phase on the card "
              f"(bitwise)")


def workers_record(plan):
    return [{"worker": st.worker, "pid": st.pid, "state": st.state,
             "chunks_done": st.chunks_done, "idle_s": st.idle_s,
             "busy_s": st.busy_s,
             "device": (st.report or {}).get("device"),
             "launches": (st.report or {}).get("launches")}
            for st in plan.worker_stats]


def chaos_baseline():
    """The first seed's stream with no chaos (2 worker processes, not
    elastic): its wall against the fleet's start. A joiner fired after 1-2
    accepted chunks needs about one fleet start to say hello, so this is
    the yardstick for CHAOS_BATCHES."""
    from repro_torch import kernels
    from repro_torch.configs import SERF_AUDIO
    from repro_torch.core.plans import Preprocessor
    from repro_torch.data.loader import audio_batch_maker, make_shard_pool

    make = audio_batch_maker(seed=CHAOS_SEEDS[0], batch_long_chunks=2)
    pool = make_shard_pool(make, CHAOS_BATCHES, 2, lease_timeout_s=300.0)
    pre = Preprocessor(SERF_AUDIO, plan="sharded", shards=2,
                       transport="proc")
    t0 = time.perf_counter()
    wids = sorted(r.wid for r in pre.run(pool))
    wall = time.perf_counter() - t0
    workers = workers_record(pre.plan)
    start = pre.plan.fleet_start_s
    rec = {"seed": CHAOS_SEEDS[0], "batches": CHAOS_BATCHES, "wall_s": wall,
           "fleet_start_s": start, "wall_over_fleet_start": wall / start,
           "workers": workers,
           "launches": {n: sum(w["launches"][n] for w in workers)
                        for n in kernels.KERNELS}}
    print(json.dumps({"chaos_baseline": rec}), flush=True)
    check(wids == list(range(CHAOS_BATCHES)),
          f"chaos_baseline: emitted {wids}")
    return rec


def chaos_seed(np, seed, two_phase):
    """One seeded schedule (a SIGKILL, a mid-run join, a drain and a
    SIGSTOP stall at least) against 2 worker processes on the card over
    CHAOS_BATCHES batches: each wid once, bitwise equal to the in-process
    two_phase, every event fired, every bye from the card, no worker left
    running or stopped, the card's memory back."""
    from repro_torch import kernels
    from repro_torch.configs import SERF_AUDIO
    from repro_torch.core.plans import Preprocessor
    from repro_torch.data.loader import audio_batch_maker, make_shard_pool
    from repro_torch.ft.chaos import ACTIONS, ChaosRunner, make_schedule

    label = f"chaos seed {seed}"
    make, made = caching_maker(audio_batch_maker(seed=seed,
                                                 batch_long_chunks=2))
    pool = make_shard_pool(make, CHAOS_BATCHES, 2, lease_timeout_s=300.0)
    pre = Preprocessor(SERF_AUDIO, plan="sharded", shards=2,
                       transport="proc", elastic=True)
    check(pre.device.type == "cuda", "Preprocessor did not pick the card")
    schedule = make_schedule(seed, CHAOS_BATCHES)
    before = used_mib()
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        results, fired = ChaosRunner(pre.plan, pool, schedule,
                                     seed=seed).run()
    except RuntimeError as e:
        raise SmokeFailure(f"{label}: the run raised: {e}") from e
    wall = time.perf_counter() - t0
    master = kernels.launches()
    plan = pre.plan
    leftovers = fleet_leftovers(plan.fleet)
    after = memory_back(before, CHAOS_MEM_SLACK_MIB)
    workers = workers_record(plan)
    names = {w["worker"] for w in workers}
    joiners = sorted({f"shard{e.target}" for e in fired
                      if e.action == "join"} & names)
    byes = [w for w in workers if w["device"] is not None]
    launches = {n: sum((w["launches"] or {}).get(n, 0) for w in byes)
                for n in kernels.KERNELS}
    by_action = {a: sum(e.action == a for e in fired) for a in ACTIONS}
    rec = {"chaos": {
        "seed": seed, "batches": CHAOS_BATCHES,
        "fired": [{"action": e.action, "after_done": e.after_done,
                   "fired_at_done": e.fired_at_done, "target": e.target,
                   "deferred": e.deferred, "stall_s": e.stall_s}
                  for e in fired],
        "by_action": by_action,
        "redeliveries": plan.redeliveries,
        "speculations": plan.speculations,
        "speculations_lost": plan.speculations_lost,
        "joiners_registered": joiners, "fleet_start_s": plan.fleet_start_s,
        "wall_s": wall, "workers": workers, "launches": launches,
        "master_launches": master, "leftovers": leftovers,
        "used_mib_before": before, "used_mib_after": after}}
    print(json.dumps(rec), flush=True)
    check([e.action for e in schedule if not e.fired] == [],
          f"{label}: events never fired: "
          f"{[e.action for e in schedule if not e.fired]}")
    check(all(by_action[a] >= 1 for a in ACTIONS),
          f"{label}: not every action fired ({by_action})")
    check(not leftovers, f"{label}: worker processes left running or "
                         f"stopped: {leftovers}")
    check(after <= before + CHAOS_MEM_SLACK_MIB,
          f"{label}: the card's used memory is {after:.0f} MiB after the "
          f"run, {before:.0f} MiB before")
    check(byes and all(w["device"] == "cuda" for w in byes),
          f"{label}: a worker signed off from another device than the card")
    check(all(sum((w["launches"] or {}).values()) > 0
              for w in byes if w["chunks_done"]),
          f"{label}: a worker that did chunks reported no kernel launches")
    for n in CHAOS_NEED:
        check(launches[n] > 0, f"{label}: the workers never launched {n}")
    check(not any(master.values()),
          f"{label}: the master launched kernels {master}")
    check_against_two_phase(np, label, results, made, two_phase,
                            CHAOS_BATCHES)
    return rec["chaos"]


def straggler_pass(np, speculate, two_phase):
    """seed 7, SPEC_BATCHES batches of one long chunk, 2 worker processes
    on the card: the holder of the last chunk is SIGSTOPped for
    SPEC_STALL_S the moment it is granted it. With speculation (factor 0,
    history 1: any item in flight is a straggler once one is done) the
    idle worker must win a duplicate lease and the stopped one be recorded
    as its loser. Returns the record, with the end-of-stream tail: the
    gap between the last two acceptances in the telemetry."""
    import tempfile
    import threading

    from repro_torch import kernels
    from repro_torch.configs import SERF_AUDIO
    from repro_torch.core.plans import Preprocessor
    from repro_torch.data.loader import audio_batch_maker, make_shard_pool
    from repro_torch.obs.telemetry import (TelemetryWriter, read_records,
                                           worker_ledger)

    label = f"chaos_speculation (speculate={speculate})"
    make, made = caching_maker(audio_batch_maker(seed=7,
                                                 batch_long_chunks=1))
    pool = make_shard_pool(make, SPEC_BATCHES, 2, lease_timeout_s=300.0)
    out = ROOT / "build" / "chip_smoke"
    out.mkdir(parents=True, exist_ok=True)
    tdir = tempfile.mkdtemp(prefix="chaos_spec_", dir=out)
    telem = TelemetryWriter(tdir)
    kw = ({"speculate": True, "straggler_factor": 0.0,
           "straggler_min_history": 1} if speculate else
          {"speculate": False})
    pre = Preprocessor(SERF_AUDIO, plan="sharded", shards=2,
                       transport="proc", telemetry=telem, **kw)
    plan = pre.plan
    results, err, stalled = [], [], []

    def consume():
        try:
            results.extend(plan.run(pool))
        except BaseException as e:      # noqa: BLE001 (checked below)
            err.append(e)

    def on_grant(worker, wid):
        if wid == SPEC_BATCHES - 1 and not stalled:
            stalled.append(worker)
            plan.fleet.stall(plan.fleet.service.workers[worker].shard,
                             SPEC_STALL_S)

    before = used_mib()
    t = threading.Thread(target=consume, daemon=True, name="spec-consumer")
    t0 = time.perf_counter()
    t.start()
    try:
        while plan.fleet is None and t.is_alive():
            time.sleep(0.005)
        if plan.fleet is not None:
            plan.fleet.service.on_grant = on_grant
        t.join(600.0)
        wall = time.perf_counter() - t0
        check(not t.is_alive(), f"{label}: the run hung")
        check(not err, f"{label}: the run raised {err[:1]}")
    finally:
        telem.close()
    recs = read_records(tdir)
    shutil.rmtree(tdir, ignore_errors=True)
    leftovers = fleet_leftovers(plan.fleet)
    after = memory_back(before, CHAOS_MEM_SLACK_MIB)
    ts = sorted(r["accept_ts"] for r in recs
                if r.get("status") == "done" and r.get("accept_ts"))
    tail = float(ts[-1] - ts[-2]) if len(ts) >= 2 else 0.0
    last = [r for r in recs if r.get("status") == "done"
            and r["wid"] == SPEC_BATCHES - 1]
    lost = sorted({r["worker"] for r in recs
                   if r.get("status") == "redelivered"
                   and r.get("reason") == "speculated"})
    ledger = worker_ledger(recs)
    workers = workers_record(plan)
    launches = {n: sum((w["launches"] or {}).get(n, 0) for w in workers)
                for n in kernels.KERNELS}
    rec = {"speculate": speculate, "stalled": stalled,
           "stall_s": SPEC_STALL_S,
           "last_chunk_done_by": [r["worker"] for r in last],
           "speculated_losers": lost,
           "speculation_lost": {w: e["speculation_lost"]
                                for w, e in ledger.items()},
           "speculations": plan.speculations,
           "speculations_lost": plan.speculations_lost,
           "fleet_start_s": plan.fleet_start_s, "wall_s": wall,
           "tail_s": tail, "workers": workers, "launches": launches,
           "leftovers": leftovers, "used_mib_before": before,
           "used_mib_after": after}
    check(stalled, f"{label}: the last chunk was never granted")
    check(not leftovers, f"{label}: worker processes left running or "
                         f"stopped: {leftovers}")
    check(after <= before + CHAOS_MEM_SLACK_MIB,
          f"{label}: the card's used memory is {after:.0f} MiB after the "
          f"run, {before:.0f} MiB before")
    done = sorted(r["wid"] for r in recs if r.get("status") == "done")
    check(done == list(range(SPEC_BATCHES)),
          f"{label}: telemetry done records for wids {done}")
    check_against_two_phase(np, label, results, made, two_phase,
                            SPEC_BATCHES)
    if speculate:
        check(plan.speculations >= 1 and plan.speculations_lost >= 1,
              f"{label}: {plan.speculations} speculations, "
              f"{plan.speculations_lost} lost")
        check([r["worker"] for r in last] != stalled,
              f"{label}: the stopped worker {stalled} completed the last "
              f"chunk, not the idle survivor")
        check(lost == stalled, f"{label}: losers attributed "
                               f"\"speculated\" are {lost}, not {stalled}")
    else:
        check(plan.speculations == 0 and not lost,
              f"{label}: speculation ran with speculate=False")
    return rec


def chaos_phases(np):
    """The chaos gate over CHAOS_SEEDS, then the straggler scenario with
    speculation on and off. Returns {label: {"launches": ...}}, the
    workers' launches, for the kernel lines."""
    from repro_torch.configs import SERF_AUDIO
    from repro_torch.core.plans import Preprocessor

    two_phase = Preprocessor(SERF_AUDIO, plan="two_phase")
    t0 = time.perf_counter()
    baseline = chaos_baseline()
    runs = {f"chaos_seed{seed}": chaos_seed(np, seed, two_phase)
            for seed in CHAOS_SEEDS}
    redeliveries = sum(r["redeliveries"] for r in runs.values())
    joiners = {s: r["joiners_registered"] for s, r in runs.items()}
    chaos_wall = time.perf_counter() - t0
    print(f"chaos: seeds {list(CHAOS_SEEDS)}, {CHAOS_BATCHES} batches each, "
          f"exactly once and bitwise; redeliveries {redeliveries}, late "
          f"joiners registered {joiners}; phase wall {chaos_wall:.1f} s",
          flush=True)
    check(redeliveries >= 1, "chaos: no schedule produced a redelivery")
    check(any(joiners.values()),
          "chaos: no late joiner registered before its stream drained")

    t1 = time.perf_counter()
    spec = {on: straggler_pass(np, on, two_phase) for on in (True, False)}
    spec_wall = time.perf_counter() - t1
    rec = {"chaos_speculation": {
        "batches": SPEC_BATCHES, "stall_s": SPEC_STALL_S,
        "on": spec[True], "off": spec[False], "phase_wall_s": spec_wall}}
    print(json.dumps(rec), flush=True)
    print(f"chaos_speculation: a {SPEC_STALL_S:.0f} s stall of the last "
          f"chunk's holder; speculation on: wall {spec[True]['wall_s']:.3f} "
          f"s, tail {spec[True]['tail_s']:.3f} s (won by "
          f"{spec[True]['last_chunk_done_by']}, loser "
          f"{spec[True]['speculated_losers']}); off: wall "
          f"{spec[False]['wall_s']:.3f} s, tail {spec[False]['tail_s']:.3f} "
          f"s; phase wall {spec_wall:.1f} s", flush=True)
    runs.update({f"chaos_speculation_{'on' if on else 'off'}": r
                 for on, r in spec.items()}, chaos_baseline=baseline)
    return {label: {"launches": r["launches"]} for label, r in runs.items()}


def check_masks(a, b, what):
    for m in ("keep", "rain", "silence", "cicada15"):
        check(bool((getattr(a, m).cpu() == getattr(b, m).cpu()).all()),
              f"{what}: the {m} masks differ")


def against_cpu(torch, np, label, gpu, cpu, cpu_graph, chunks0):
    """Hold one card result against the port's CPU run of the same batch:
    equal masks (a flip prints every detector's margin to its threshold)
    and cleaned audio within 2e-4. Returns the largest difference."""
    flips = {}
    for m in ("keep", "rain", "silence", "cicada15"):
        g = getattr(gpu.det, m).cpu().numpy()
        c = getattr(cpu.det, m).numpy()
        if not (g == c).all():
            flips[m] = np.flatnonzero(g != c).tolist()
    if flips:
        print(json.dumps({"mask_flips": flips, "cell": label,
                          "margins": mask_margins(torch, cpu_graph,
                                                  chunks0)}), flush=True)
    check(not flips, f"{label}: masks differ from the CPU run: {flips}")
    rtol, atol = TOL["main_path"]
    diff = (float(np.abs(gpu.cleaned - cpu.cleaned).max())
            if cpu.n_kept else 0.0)
    check(gpu.cleaned.shape == cpu.cleaned.shape and np.allclose(
        gpu.cleaned, cpu.cleaned, rtol=rtol, atol=atol),
        f"{label}: cleaned audio differs from the CPU run "
        f"(max |err| {diff:.3g})")
    return diff


def kill_and_resume(torch, np, batches, base):
    """The cached two_phase cell with a run journal: take one result from
    `run`, close the generator (the kill), then resume. Each batch must be
    emitted once across the two runs, the resumed outputs must equal the
    uncached two_phase cell's bitwise, and the resumed run must miss on
    exactly the two batches the killed run never reached."""
    from repro_torch.configs import SERF_AUDIO
    from repro_torch.core.plans import Preprocessor
    store = STORES / "resume"
    pre = Preprocessor(SERF_AUDIO, plan="cached", store=store, journal=True)
    gen = pre.run(batches)
    first = [next(gen)]
    gen.close()
    pre2 = Preprocessor(SERF_AUDIO, plan="cached", store=store,
                        journal=True, resume=True)
    rest = list(pre2.run(batches))
    torch.cuda.synchronize()
    wids = sorted(r.wid for r in first + rest)
    stats = pre2.plan.stats.as_dict()
    rec = {"kill_and_resume": {"first": [r.wid for r in first],
                               "resumed": [r.wid for r in rest],
                               "store": stats}}
    print(json.dumps(rec), flush=True)
    check(wids == [0, 1, 2], f"kill and resume emitted {wids}, not "
                             f"[0, 1, 2] once each")
    check(stats["misses"] == 2, f"the resumed run missed {stats['misses']} "
                                f"times, not 2")
    for r in first + rest:
        want = base[r.wid]
        check_masks(r.det, want.det, f"kill and resume, batch {r.wid}")
        check(np.array_equal(r.cleaned, want.cleaned),
              f"kill and resume: batch {r.wid} differs from two_phase's "
              f"(bitwise)")
    return rec


def window382(torch, np, batches, base_pre, card):
    """The 3-batch stream at a 382-sample window (the STFT and fused tail
    through the direct DFT) through two_phase on the card: warmed up over
    one batch, driven once with the launch counts set to 0 just before and
    read just after, its batch 0 held against the port's CPU run of the
    same batch; then timed as the other cells are, `PASSES` passes in
    turns with `serf_two_phase_fused` (`base_pre`), whose MB/s is printed
    beside it."""
    from repro_torch import kernels
    from repro_torch.configs import SERF_AUDIO
    from repro_torch.core.plans import Preprocessor
    label, base = "serf_w382_two_phase", "serf_two_phase_fused"
    cfg = dataclasses.replace(SERF_AUDIO, **W382)
    pre = Preprocessor(cfg, plan="two_phase")
    list(pre.run(batches[:1]))                     # warm-up
    torch.cuda.synchronize()
    kernels.reset_launches()
    run = list(pre.run(batches))                   # the main-path run
    torch.cuda.synchronize()
    counts = kernels.launches()
    chunks0 = batches[0][1][0]
    cpu_pre = Preprocessor(cfg, plan="two_phase", device="cpu")
    cpu = cpu_pre(chunks0)
    diff = against_cpu(torch, np, label, run[0], cpu, cpu_pre.graph, chunks0)
    for n in ("fir_hpf", "stft_dft_generic", "fused_tail_generic"):
        check(counts[n] > 0, f"{label} never launched {n}")
    check(counts["stft_dft"] == 0 and counts["fused_tail"] == 0,
          f"{label} launched an FFT kernel ({counts})")
    pass_s = {label: [], base: []}
    cells = [(label, pre), (base, base_pre)]
    for rep in range(PASSES):
        for lab, p in (cells if rep % 2 == 0 else cells[::-1]):
            t0 = time.perf_counter()
            list(p.run(batches))
            torch.cuda.synchronize()
            pass_s[lab].append(time.perf_counter() - t0)
    src = sum(c.nbytes for _, (c, _) in batches)
    mb = {lab: sorted(src / 2**20 / t for t in ts)
          for lab, ts in pass_s.items()}
    med = {lab: statistics.median(v) for lab, v in mb.items()}
    rec = {"main_path": label, "window": 382, "launches": counts,
           "kept": sum(r.n_kept for r in run),
           "chunks": sum(int(r.det.keep.numel()) for r in run),
           "vs_cpu_max_abs_err": diff, "passes": PASSES,
           "pass_s": pass_s[label], "mb_per_s_median": med[label],
           "mb_per_s_min": mb[label][0], "mb_per_s_max": mb[label][-1],
           base: {"pass_s": pass_s[base], "mb_per_s_median": med[base],
                  "mb_per_s_min": mb[base][0],
                  "mb_per_s_max": mb[base][-1]}}
    print(f"plan=two_phase cell={label} card={card}  {src / 2**20:.0f} MB "
          f"source audio per pass, median of {PASSES} passes  ->  "
          f"{med[label]:.2f} MB/s ({mb[label][0]:.2f}-{mb[label][-1]:.2f}); "
          f"{base} in turns with it {med[base]:.2f} MB/s "
          f"({mb[base][0]:.2f}-{mb[base][-1]:.2f})", flush=True)
    print(json.dumps(rec), flush=True)
    return rec


# ------------------------------------------------------- the LM serving phase

LM_ARCH = "llama3.2-3b"         # the full-width arch: 3.21 B parameters
HYBRID_ARCH = "zamba2-1.2b"     # Mamba2 + a shared attention block: 1.10 B
XLSTM_ARCH = "xlstm-125m"       # mLSTM / sLSTM: 0.19 B
LM_TOL = {"card_vs_cpu": 1e-4, "decode_vs_prefill": 5e-3}   # rtol = atol
BF16_PEAK_FLOPS = 989e12        # H100 SXM dense bf16 (NVIDIA data sheet)


def lm_inputs(np, cfg, B, S, seed=1):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": tokens, "targets": tokens}
    if cfg.num_prefix_tokens:
        batch["prefix"] = rng.randn(B, cfg.num_prefix_tokens,
                                    cfg.d_model).astype(np.float32)
    if cfg.is_enc_dec:
        batch["enc_frames"] = rng.randn(B, 16, cfg.d_model).astype(
            np.float32)
    return batch


def prefill_then_step(torch, model, batch, cache_dtype):
    """prefill(tokens[:, :k]) into caches of S (+ prefix) rows (the engine's
    `decode_caches`), then one decode step on token k = S - 1: (loss,
    prefill logits, step logits, prefill(tokens) logits)."""
    from repro_torch.serve.engine import decode_caches
    cfg = model.cfg
    B, S = batch["tokens"].shape
    k, P = S - 1, cfg.num_prefix_tokens or 0
    with torch.inference_mode():
        loss, _ = model.loss_fn(batch)
        logits, pf = model.prefill(dict(batch, tokens=batch["tokens"][:, :k]))
        cache = decode_caches(model, pf, S + P, dtype=cache_dtype)
        step, _ = model.decode_step(cache, torch.as_tensor(
            batch["tokens"][:, k], device=model.device), P + k)
        full, _ = model.prefill(batch)
    return loss, logits, step, full


def lm_reduced_archs(torch, np):
    """The ten archs at `reduced` widths, f32: parameters drawn once on the
    CPU and copied to the card; loss, prefill logits and one decode step's
    logits on the card against the port's CPU run."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models.zoo import build_model
    errs = {}
    for arch in sorted(ARCHS):
        cfg = dataclasses.replace(reduced(ARCHS[arch]), dtype="float32")
        cpu = build_model(cfg, device="cpu")
        gpu = build_model(cfg, device="cuda")
        gpu.load_state_dict(cpu.state_dict())
        check(gpu.emb["tok"].device.type == "cuda", "model not on the card")
        batch = lm_inputs(np, cfg, 2, 32)
        want = prefill_then_step(torch, cpu, batch, torch.float32)[:3]
        got = prefill_then_step(torch, gpu, batch, torch.float32)[:3]
        tol = LM_TOL["card_vs_cpu"]
        errs[arch] = {}
        for what, g, w in zip(("loss", "prefill", "decode"), got, want):
            err, ok = compare(torch, g.cpu(), w, tol, tol)
            check(ok, f"{arch} {what}: card against CPU max abs err {err}")
            errs[arch][what] = err
    check(len(errs) == 10, f"{len(errs)} archs checked, not ten")
    return errs


def lm_full_width_f32(torch, np, arch):
    """`arch` at f32 on the card: decoding token k against the prefill
    cache of tokens[:k] reproduces prefill(tokens[:k+1])'s next-token
    logits (B = 2, a 128-token prompt, the cache f32); the check's wall."""
    from repro_torch.configs import ARCHS
    from repro_torch.models.zoo import build_model
    cfg = dataclasses.replace(ARCHS[arch], dtype="float32")
    model = build_model(cfg)
    batch = lm_inputs(np, cfg, 2, 128)
    t0 = time.perf_counter()
    _, _, step, full = prefill_then_step(torch, model, batch, torch.float32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tol = LM_TOL["decode_vs_prefill"]
    err, ok = compare(torch, step, full, tol, tol)
    check(ok, f"{arch} f32: decode against prefill max abs err {err}")
    rec = {"max_abs_err": err, "tol": tol, "max_abs_logit":
           float(full.abs().max()), "params": sum(
               p.numel() for p in model.parameters()), "wall_s": wall}
    print(json.dumps({f"{arch}_f32_decode_vs_prefill": rec}), flush=True)
    del model, step, full
    torch.cuda.empty_cache()
    return rec


def least_times(model, B, S, cache_rows):
    """The least times of a prefill of (B, S) and of one decode step with
    caches of `cache_rows` rows: decode reads the weights once (the
    hybrid's shared block once more for each further application), the
    recurrent states read and written and the K/V read, at the HBM rate;
    prefill the larger of the weights' bytes at that rate and
    2 * active params * B * S at the bf16 peak."""
    from repro_torch.models.mamba2 import mamba_dims
    cfg = model.cfg
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    active, read = n_params, param_bytes
    state_bytes = kv_bytes = 0
    kv_el = 2                                   # bf16 caches
    if cfg.family == "hybrid":
        reps = len(model.group_sizes()) - 1
        active += reps * sum(p.numel() for p in model.shared.parameters())
        read += reps * sum(p.numel() * p.element_size()
                           for p in model.shared.parameters())
        d_inner, H, P, N = mamba_dims(cfg)
        state_bytes = 2 * cfg.num_layers * B * H * P * N * 4
        kv_bytes = 2 * (reps + 1) * B * cache_rows * cfg.kv_dim * kv_el
    elif cfg.family == "ssm":
        state = model.init_cache(B)
        state_bytes = 2 * sum(t.numel() * t.element_size()
                              for v in state.values() for t in v)
        del state
    else:
        kv_bytes = 2 * cfg.num_layers * B * cache_rows * cfg.kv_dim * kv_el
    return {"params": n_params, "active_params_per_token": active,
            "decode_bytes": read + state_bytes + kv_bytes,
            "decode_bound_ms": (read + state_bytes + kv_bytes)
            / HBM_BYTES_PER_S * 1e3,
            "prefill_bound_ms": max(param_bytes / HBM_BYTES_PER_S,
                                    2 * active * B * S / BF16_PEAK_FLOPS)
            * 1e3}


def step_times(torch, np, timer, model, prompts, cache_rows):
    """Prefill of `prompts` and one decode step after it, CUDA events,
    median of 10 each."""
    from repro_torch.serve.engine import decode_caches
    cfg = model.cfg
    B, S = prompts.shape
    batch = {"tokens": prompts}
    with torch.inference_mode():
        prefill_ms = timer(lambda: model.prefill(batch), reps=10)
        logits, pf = model.prefill(batch)
        caches = decode_caches(model, pf, cache_rows)
        tok = logits[:, :cfg.vocab_size].argmax(-1)
        decode_ms = timer(lambda: model.decode_step(caches, tok, S), reps=10)
    del caches, pf, logits
    return {"prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms}


def lm_serving(torch, np, timer, arch):
    """`arch` in bf16: the launcher's LM mode in process, then a
    RequestQueue over one engine twice on the same 8 prompts (the same
    tokens both times, every token below the vocab size, every request
    answered once), prefill and decode-step times and the peak memory."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch import serve
    from repro_torch.models.zoo import build_model
    from repro_torch.serve.engine import RequestQueue, ServeEngine
    B, S, GEN, N = 4, 128, 32, 8
    done = serve.main(["--arch", arch, "--batch", str(B), "--prompt-len",
                       str(S), "--gen", str(GEN), "--requests", str(N)])
    check(sorted(done) == list(range(N)), f"launcher served {done}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = ARCHS[arch]
    model = build_model(cfg)
    engine = ServeEngine(model, max_seq=S + GEN + 8)
    prompts = np.random.RandomState(7).randint(0, cfg.vocab_size, (N, S))
    runs = []
    for _ in range(2):
        q = RequestQueue(engine, B, S, GEN)
        rids = [q.submit(p) for p in prompts]
        t0 = time.perf_counter()
        answered = []
        while len(answered) < N:
            answered.extend(q.pump())
        wall = time.perf_counter() - t0
        check(sorted(answered) == rids and len(set(answered)) == N,
              f"requests answered {answered}, submitted {rids}")
        out = {r: q.result(r) for r in rids}
        check(all(q.result(r) is None for r in rids),
              "a result was handed over twice")
        toks = np.stack([out[r] for r in rids])
        check(toks.shape == (N, GEN) and (toks >= 0).all()
              and (toks < cfg.vocab_size).all(), "tokens out of range")
        runs.append((toks, wall))
    check(np.array_equal(runs[0][0], runs[1][0]),
          f"{arch}: two runs on the same prompts gave different tokens")
    rec = {"arch": arch, "dtype": cfg.dtype,
           "batch": B, "prompt_len": S, "gen": GEN, "requests": N,
           **step_times(torch, np, timer, model, prompts[:B], S + GEN),
           "generated_tok_per_s": [N * GEN / w for _, w in runs],
           "queue_wall_s": [w for _, w in runs],
           "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
           **least_times(model, B, S, S + GEN)}
    del engine, model
    torch.cuda.empty_cache()
    print(json.dumps({f"{arch}_bf16_serving": rec}), flush=True)
    return rec


def lm_generate_twice(torch, np, timer, arch):
    """`arch` in bf16: greedy `generate` twice on 4 prompts of 128 tokens,
    32 new ones: the same tokens both times, each below the vocab size;
    prefill and decode-step times."""
    from repro_torch.configs import ARCHS
    from repro_torch.models.zoo import build_model
    from repro_torch.serve.engine import ServeEngine
    B, S, GEN = 4, 128, 32
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = ARCHS[arch]
    model = build_model(cfg)
    engine = ServeEngine(model, max_seq=S + GEN + 8)
    prompts = np.random.RandomState(8).randint(0, cfg.vocab_size, (B, S))
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        toks = engine.generate(prompts, GEN)
        runs.append((toks, time.perf_counter() - t0))
        check(toks.shape == (B, GEN) and (toks >= 0).all()
              and (toks < cfg.vocab_size).all(), "tokens out of range")
    check(np.array_equal(runs[0][0], runs[1][0]),
          f"{arch}: two runs on the same prompts gave different tokens")
    rec = {"arch": arch, "dtype": cfg.dtype, "batch": B, "prompt_len": S,
           "gen": GEN,
           **step_times(torch, np, timer, model, prompts, S + GEN),
           "generated_tok_per_s": [B * GEN / w for _, w in runs],
           "generate_wall_s": [w for _, w in runs],
           "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
           **least_times(model, B, S, S + GEN)}
    del engine, model
    torch.cuda.empty_cache()
    print(json.dumps({f"{arch}_bf16_generate": rec}), flush=True)
    return rec


def fresh_process_decode(arch):
    """The arch's bf16 decode step timed and traced in a fresh process
    (scripts/lm_profile.py): the device-busy share and kernels a step."""
    out = subprocess.run([sys.executable, str(ROOT / "scripts" /
                                              "lm_profile.py"),
                          "--arch", arch],
                         capture_output=True, text=True, timeout=600)
    check(out.returncode == 0,
          f"lm_profile.py --arch {arch} failed: {out.stderr[-2000:]}")
    prof = json.loads(out.stdout.strip().splitlines()[-1])
    return {k: prof[k] for k in (
        "decode_ms_per_step", "traced_wall_ms_per_step",
        "device_busy_ms_per_step", "device_busy_share", "kernels_per_step")}


def lm_serve(torch, np, timer, card):
    """Phase 6: language-model serving on the card (no hand kernel runs on
    this path: the counts must stay 0)."""
    import threading

    from repro_torch import kernels
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    kernels.reset_launches()
    # the decode loop is host-bound: other Python threads left by earlier
    # phases share its interpreter lock
    rec = {"python_threads": sorted(
        t.name for t in threading.enumerate()
        if t is not threading.main_thread())}
    rec["reduced_card_vs_cpu"] = lm_reduced_archs(torch, np)
    print(json.dumps({"lm_reduced_card_vs_cpu": rec["reduced_card_vs_cpu"]}),
          flush=True)
    rec["full_width_f32_decode_vs_prefill"] = {
        arch: lm_full_width_f32(torch, np, arch)
        for arch in (LM_ARCH, HYBRID_ARCH)}
    rec["bf16_serving"] = {arch: lm_serving(torch, np, timer, arch)
                           for arch in (LM_ARCH, HYBRID_ARCH)}
    rec["bf16_generate"] = {XLSTM_ARCH: lm_generate_twice(torch, np, timer,
                                                          XLSTM_ARCH)}
    rec["fresh_process_decode"] = {
        arch: fresh_process_decode(arch)
        for arch in (LM_ARCH, HYBRID_ARCH, XLSTM_ARCH)}
    launched = kernels.launches()
    check(not any(launched.values()),
          f"a hand kernel launched on the LM path: {launched}")
    rec["hand_kernel_launches"] = launched
    rec["wall_s"] = time.perf_counter() - t0
    print(card, flush=True)
    print(json.dumps({"lm_serve": rec}), flush=True)
    return rec


# ------------------------------------------------------------------- main

def main():
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script; "
              "run it from a checkout of the repo", file=sys.stderr)
        return 2
    t_smoke = time.perf_counter()
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
        lm_serve(torch, np, timer, card_line)
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
    print(f"chip_smoke: wall {time.perf_counter() - t_smoke:.1f} s",
          flush=True)
    print(card_line, flush=True)
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
