#!/usr/bin/env python3
"""Split the time of the direct-DFT kernels (`csrc/dft.cuh`, `stft.cu`
stft_dft_kernel, `fused_tail.cu` fused_tail_dft_kernel) on the card.

    python3 scripts/dft_variants.py [--sass DIR]

Builds variants of `dft.cuh`, `stft.cu` and `fused_tail.cu` with nvcc (one
per source, in parallel) into `build/dft_variants/` and times each at the
shapes `chip_smoke.py` times them: the STFT at W = 382 and 200 on (16,
330,750), the fused tail at W = 382 and 200 on wave (48, 110,250) with 16
indices (one a pad slot), with and without the high-pass: the median of
10 runs by CUDA events with the 50 MB L2 overwritten before each, every
variant timed twice, in turns. The variants marked * compute wrong values
on purpose; only their times mean anything. Every other variant is held to
the kernels' tolerance (rtol = atol = 2e-4) against the plain versions,
and the script exits 1 when one misses it:

  kernel        the kernels as they are
  cvt_rna       the TF32 rounding by cvt.rna.tf32.f32 itself (four
                instructions on sm_90a) instead of its add and mask
  one_product * one TF32 product (hi hi) a step instead of three
  no_store *    the STFT's tile results summed into one store per thread
  no_gemm *     the STFT without its products and stores
  no_copy *     the STFT copying only each group's first tile
  groups2       the STFT's blocks with two warp groups, not three
  trunc_hi      hi = a with its low 13 bits cleared (truncation), not rna
  unroll2       the STFT tile's k-loop unrolled twice (more registers;
                the fused tail's is)
  mt2           the STFT's warps on 32 frames x 32 bins, not 16 x 32

The SASS of each variant's DFT kernels is counted by opcode (cuobjdump):
one JSON line per variant with the counts of HMMA, F2F / F2FP (the
conversions), LDS, STS, FFMA, FADD and the total. With --sass DIR it also
writes the SASS to DIR/<variant>_<source>.sass. One JSON line per variant
and case, the card's name, power limit and SM clock first.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import dataclasses
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "dft_variants"
RTOL = ATOL = 2e-4
WRONG = {"one_product", "no_store", "no_gemm", "no_copy"}

RNA = "  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;"
PRODUCTS = """        mma_tf32(re[i][j], el[i], ch);
        mma_tf32(re[i][j], eh[i], cl);
        mma_tf32(re[i][j], eh[i], ch);
        mma_tf32(im[i][j], ol[i], sh);
        mma_tf32(im[i][j], oh[i], sl);
        mma_tf32(im[i][j], oh[i], sh);"""
STORE = """                               if (f < n_f && b0 + n < K)
                                 ot[static_cast<long long>(f) * K + n] =
                                     make_float2(re, im);"""
GEMM = "    for (int m = warp; m < FM / 16; m += DFT_GROUP_THREADS / 32)"
NEXT = "    if (i + groups < i1) copy_item(i + groups);\n"
GROUPS = "constexpr int DFT_GROUPS = 3;"
SHARE = ("      dft_warp_tile<1, 4, 1>(seg, coef, basis_s, basis_s + "
         "DFT_BINS * R, W,\n                             16 * m, 0, lane,")
UNROLL = "<1, 4, 1>"
TRUNC = ("  hi = tf32_rna(x);", "  hi = __float_as_uint(x) & 0xFFFFE000u;")
CVT_RNA = (RNA, """  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;""")

# name -> (dft.cuh substitutions, stft.cu substitutions)
VARIANTS = {
    "kernel": ([], []),
    "cvt_rna": ([CVT_RNA], []),
    "one_product": ([(PRODUCTS, """        mma_tf32(re[i][j], eh[i], ch);
        mma_tf32(im[i][j], oh[i], sh);""")], []),
    "no_store": ([], [(STORE, 31 * " " + "if (re == 1234.5f && im == n_f)\n"
                       + 33 * " " + "ot[0] = make_float2(re, im);")]),
    "no_gemm": ([], [(GEMM, GEMM.replace("m = warp;", "m = warp + FM;"))]),
    "no_copy": ([], [(NEXT, "")]),
    "groups2": ([], [(GROUPS, "constexpr int DFT_GROUPS = 2;")]),
    "trunc_hi": ([TRUNC], []),
    "unroll2": ([], [(UNROLL, "<1, 4, 2>")]),
    "mt2": ([], [(GEMM, GEMM.replace("FM / 16", "FM / 32")),
                 (SHARE, SHARE.replace("<1, 4, 1>", "<2, 4, 1>")
                  .replace("16 * m", "32 * m"))]),
}
OPS = ("HMMA", "F2F", "F2FP", "LDS", "STS", "FFMA", "FADD", "LOP3", "IADD3")


def patched(text, subs, what):
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"dft_variants: {what} has changed; "
                             f"{old[:60]!r} not found")
        text = text.replace(old, new)
    return text


def build(csrc, nvcc, flags):
    cuh = (csrc / "dft.cuh").read_text()
    stft = (csrc / "stft.cu").read_text()
    tail = (csrc / "fused_tail.cu").read_text()
    procs = {}
    for name, (cuh_subs, stft_subs) in VARIANTS.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "dft.cuh").write_text(patched(cuh, cuh_subs, f"{name}: dft.cuh"))
        (d / "stft.cu").write_text(patched(stft, stft_subs,
                                           f"{name}: stft.cu"))
        (d / "fused_tail.cu").write_text(tail)
        for src in ("stft", "fused_tail"):
            procs[name, src] = subprocess.Popen(
                [nvcc, *flags, "-I", str(d), "-I", str(csrc), "-o",
                 str(d / f"lib{src}.so"), str(d / f"{src}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for (name, src), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            for other in procs.values():
                other.kill()
                other.wait()
            raise SystemExit(f"dft_variants: nvcc failed for {name} "
                             f"{src}:\n{log}")
        lines = log.splitlines()
        regs = [ln.strip() for i, ln in enumerate(lines)
                if "registers" in ln and "dft" in " ".join(lines[i - 3:i])]
        print(json.dumps({"variant": name, "source": src, "ptxas": regs}),
              flush=True)


def sass_counts(cuobjdump, lib, kernel, dump):
    """Opcode counts of the SASS of the kernel whose mangled name starts
    with `kernel`, in a library."""
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True).stdout
    text = next((part for part in text.split("Function : ")
                 if part.startswith(kernel)), "")
    if dump is not None:
        dump.write_text(text)
    ops = collections.Counter()
    for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)",
                         text):
        ops[m.group(1)] += 1
    return {"total": sum(ops.values()),
            **{op: ops.get(op, 0) for op in OPS}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sass", type=Path, default=None,
                    help="write cuobjdump -sass of the kernels here")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("dft_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import SERF_AUDIO
    from repro_torch.kernels import _build
    from repro_torch.kernels.fir_hpf import ref as FR
    from repro_torch.kernels.fused_tail import ref as TR
    from repro_torch.kernels.stft_dft import fft_tables as FT
    from repro_torch.kernels.stft_dft import ref as SR

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    nvcc = _build._nvcc()
    build(_build.CSRC, nvcc, _build.NVCC_FLAGS)
    cuobjdump = Path(nvcc).with_name("cuobjdump")
    if not cuobjdump.exists():
        cuobjdump = Path(shutil.which("cuobjdump") or "cuobjdump")
    if args.sass is not None:
        args.sass.mkdir(parents=True, exist_ok=True)
    for name in VARIANTS:
        for src, kernel in (("stft", "_Z15stft_dft_kernel"),
                            ("fused_tail", "_Z21fused_tail_dft_kernel")):
            dump = (args.sass / f"{name}_{src}.sass" if args.sass else None)
            print(json.dumps({"variant": name, "source": src, "sass":
                              sass_counts(cuobjdump, OUT / name /
                                          f"lib{src}.so", kernel, dump)}),
                  flush=True)

    flush = torch.empty(256 * 2**20 // 4, device="cuda")

    def timed(fn, reps=10):
        for _ in range(2):
            fn()
        times = []
        for _ in range(reps):
            flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    def entry(name, src, symbol, n_args):
        fn = getattr(ctypes.CDLL(str(OUT / name / f"lib{src}.so")), symbol)
        fn.argtypes = n_args
        fn.restype = ctypes.c_int
        return fn

    P, I, L, F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_float)
    gen = torch.Generator(device="cuda").manual_seed(11)
    x16 = torch.randn((16, 330_750), generator=gen, device="cuda") * 0.3
    wave = torch.randn((48, 110_250), generator=gen, device="cuda") * 0.3
    real = np.sort(np.random.RandomState(7).choice(48, 15, replace=False))
    idx = torch.as_tensor(np.asarray([*real.tolist(), 48], np.int32),
                          device="cuda")
    cases = []
    for W in (382, 200):
        tab = torch.as_tensor(FT.kernel_tables(W), device="cuda")
        cases.append((f"stft W={W}", "stft", tab, W, None,
                      SR.stft_ref(x16, W, W // 2)))
        for hpf in (False, True):
            cfg = dataclasses.replace(SERF_AUDIO, stft_window=W,
                                      stft_hop=W // 2)
            cases.append((f"fused_tail W={W} hpf={hpf}", "fused_tail", tab,
                          W, (cfg, hpf),
                          TR.fused_tail_spectrum_ref(wave, idx, cfg, hpf)))
    taps = torch.as_tensor(FR.highpass_taps(
        SERF_AUDIO.hpf_cutoff_hz, SERF_AUDIO.target_rate_hz,
        SERF_AUDIO.hpf_taps), device="cuda")
    failed = 0
    for label, src, tab, W, tail, want in cases:
        times, errs, oks = {}, {}, {}
        for rep in range(2):                 # in turns: forward, backward
            for name in (list(VARIANTS) if rep == 0
                         else list(VARIANTS)[::-1]):
                got = torch.empty(want.shape + (2,), device="cuda")
                stream = torch.cuda.current_stream().cuda_stream
                if tail is None:
                    fn = entry(name, src, "stft_forward",
                               [P, P, P, I, L, I, I, P])
                    args_ = (x16.data_ptr(), tab.data_ptr(), got.data_ptr(),
                             16, x16.shape[1], want.shape[1], W, stream)
                else:
                    cfg, hpf = tail
                    fn = entry(name, src, "fused_tail_forward",
                               [P, P, P, P, P, I, L, I, I, I, I, I, F32,
                                F32, P])
                    args_ = (wave.data_ptr(), idx.data_ptr(), tab.data_ptr(),
                             taps.data_ptr() if hpf else None,
                             got.data_ptr(), 48, wave.shape[1], 16,
                             want.shape[1], W, taps.shape[0] if hpf else 0,
                             cfg.noise_est_frames, cfg.mmse_alpha,
                             cfg.mmse_gain_floor, stream)

                def call(fn=fn, args_=args_):
                    err = fn(*args_)
                    if err:
                        raise RuntimeError(f"{name} {label}: CUDA error "
                                           f"{err}")

                call()
                torch.cuda.synchronize()
                d = (got - torch.view_as_real(want)).abs()
                errs[name] = float(d.max())
                oks[name] = oks.get(name, True) and bool(
                    (d <= ATOL + RTOL * torch.view_as_real(want).abs()).all())
                times.setdefault(name, []).append(timed(call))
        for name in VARIANTS:
            rec = {"case": label, "variant": name, "ms": times[name],
                   "max_abs_err": errs[name]}
            if name not in WRONG:
                rec["within_tolerance"] = oks[name]
                failed += not oks[name]
            print(json.dumps(rec), flush=True)
    if failed:
        print(f"dft_variants: {failed} variant runs outside rtol {RTOL}, "
              f"atol {ATOL}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
