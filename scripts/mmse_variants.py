#!/usr/bin/env python3
"""Split the MMSE kernel's time (`csrc/mmse.cu`) between its copies, its
stores and the recurrence's chain, on the card.

    python3 scripts/mmse_variants.py [--sass DIR]

Builds variants of `mmse.cu` and `mmse.cuh` with nvcc (one per source, in
parallel) into `build/mmse_variants/` and times each at the staged tail's
shapes, power (16, 860, 129) and (35, 860, 129), and on one chain,
(1, 860, 1): the median of 20 runs by CUDA events with the 50 MB L2
overwritten before each, as `chip_smoke.py` times kernels, every variant
timed twice, in turns. The variants marked * compute wrong values on
purpose; only their times mean anything. Every other variant is held to
the kernel's tolerance (rtol 1e-4, atol 2e-5) against the plain version,
and the script exits 1 when one misses it:

  kernel        the kernel as it is
  no_copy *     no copies and no waits: each frame's power is made from
                the frame index in registers
  no_store *    the gains summed into one store per thread instead of
                stored
  chain_only *  neither copies nor stores: the recurrence alone
  row           the other layout: blocks of 160 bins (5 warps), one per
                row at K = 129
  chunk32       chunks of 32 frames instead of 64
  frame_at_use  each frame's terms formed just before its step, from a
                power read one frame ahead
  horner        the step's polynomials by plain Horner
  estrin        the step's polynomials by Estrin's scheme

Then single-thread chains of dependent instructions, timed by the SM's
clock (cycles per link, 16 links unrolled per loop trip): MUFU rcp (with
an FMA after each, since ptxas folds rcp(rcp(x)); subtract the FMA),
rsqrt and ex2 (`.approx.ftz`), an FMA, a max (FMNMX), a multiply, and one
whole mmse_step (mmse.cuh) per link, as the kernels run it. With
--sass DIR it writes `cuobjdump -sass` of the kernel and of the chains to
DIR/mmse_kernel.sass and DIR/mmse_chains.sass. One JSON line per variant
and shape, the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "mmse_variants"
SHAPES = [(16, 860, 129), (35, 860, 129), (1, 860, 1)]
CHAIN = 864                     # links of a chain, a multiple of 16
RTOL, ATOL = 1e-4, 2e-5         # the kernel's tolerance (chip_smoke.py)
WRONG = {"no_copy", "no_store", "chain_only"}   # wrong values on purpose

ISSUE_PROLOGUE = """      mmse_issue(origin, base, end, mmse_run(base, b, F, K, k0, nb, fc, c),
                 ring + c * stage_floats, &full[c]);"""
ISSUE_LOOP = """      mmse_issue(origin, base, end, mmse_run(base, b, F, K, k0, nb, fc, cn),
                 ring + sn * stage_floats, &full[sn]);"""
WAIT = "    mbar_wait(&full[slot], (c / MMSE_STAGES) & 1);"
READ0 = "      MmseFrame next = mmse_frame(st[0], inv_lam, alpha);"
READ1 = "      float p_next = st[min(1, nf - 1) * K];"
READ = "        p_next = st[min(f + 2, nf - 1) * K];"
STORE = "        *out = fmaxf(g, gain_floor);"
CARRY = "  MmseCarry carry = mmse_carry_init(alpha);"
KERNEL_END = """        out += K;
      }
    }
  }
}"""
LOOP = """      MmseFrame next = mmse_frame(st[0], inv_lam, alpha);
      float p_next = st[min(1, nf - 1) * K];
#pragma unroll 4
      for (int f = 0; f < nf; ++f) {
        const MmseFrame fr = next;
        next = mmse_frame(p_next, inv_lam, alpha);
        p_next = st[min(f + 2, nf - 1) * K];
        const float g = mmse_step(fr, carry);"""
AT_USE = """      float p_next = st[0];
#pragma unroll 4
      for (int f = 0; f < nf; ++f) {
        const MmseFrame fr = mmse_frame(p_next, inv_lam, alpha);
        p_next = st[min(f + 1, nf - 1) * K];
        const float g = mmse_step(fr, carry);"""
NO_COPY = [
    (ISSUE_PROLOGUE, "      (void)end;"),
    (ISSUE_LOOP, "      (void)sn;"),
    (WAIT, "    (void)slot;"),
    (READ0, "      MmseFrame next = mmse_frame(1.f + (kk & 7), inv_lam, "
            "alpha); (void)st;"),
    (READ1, "      float p_next = 1.37f;"),
    (READ, "        p_next = 1.f + 0.37f * ((f + c) & 15);"),
]
NO_STORE = [
    (CARRY, CARRY + "\n  float sink = 0.f;"),
    (STORE, "        sink += g;"),
    (KERNEL_END, KERNEL_END[:-1]
     + "  if (live) gain[static_cast<long long>(b) * F * K + k0 + kk] = sink;"
       "\n}"),
]
SPLIT7 = "  return fmaf(x, od, ev);\n}\n__device__ __forceinline__ float mmse_split9"
SPLIT9 = "  return fmaf(x, od, ev);\n}\n\n// What a frame's step needs"
HORNER = [
    (SPLIT7, """  (void)ev; (void)od; (void)x2;
  float acc = c[6];
#pragma unroll
  for (int i = 5; i >= 0; --i) acc = fmaf(acc, x, c[i]);
  return acc;
}
__device__ __forceinline__ float mmse_split9"""),
    (SPLIT9, """  (void)ev; (void)od; (void)x2;
  float acc = c[8];
#pragma unroll
  for (int i = 7; i >= 0; --i) acc = fmaf(acc, x, c[i]);
  return acc;
}

// What a frame's step needs"""),
]
ESTRIN = [
    (SPLIT7, """  (void)ev; (void)od;
  const float x4 = x2 * x2;
  const float a = fmaf(c[1], x, c[0]), b = fmaf(c[3], x, c[2]);
  const float d = fmaf(c[5], x, c[4]);
  return fmaf(x4, fmaf(c[6], x2, d), fmaf(x2, b, a));
}
__device__ __forceinline__ float mmse_split9"""),
    (SPLIT9, """  (void)ev; (void)od;
  const float x4 = x2 * x2;
  const float a = fmaf(c[1], x, c[0]), b = fmaf(c[3], x, c[2]);
  const float d = fmaf(c[5], x, c[4]), e = fmaf(c[7], x, c[6]);
  return fmaf(x4, fmaf(x4, c[8], fmaf(x2, e, d)), fmaf(x2, b, a));
}

// What a frame's step needs"""),
]
# name: (patches of mmse.cu, patches of mmse.cuh)
VARIANTS = {
    "kernel": ([], []),
    "no_copy": (NO_COPY, []),
    "no_store": (NO_STORE, []),
    "chain_only": (NO_COPY + NO_STORE, []),
    "row": ([("constexpr int MMSE_BINS = 32;",
              "constexpr int MMSE_BINS = 160;")], []),
    "chunk32": ([("constexpr int MMSE_CHUNK = 64;",
                  "constexpr int MMSE_CHUNK = 32;")], []),
    "frame_at_use": ([(LOOP, AT_USE)], []),
    "horner": ([], HORNER),
    "estrin": ([], ESTRIN),
}

# single-thread chains of dependent links, clock64() around them
CHAINS_CU = r"""
#include <cuda_runtime.h>
#include "mmse.cuh"

template <int OP>
__device__ __forceinline__ float link(float x, float a) {
  float y, t;
  if (OP == 0) {
    asm volatile("rcp.approx.ftz.f32 %0, %1;" : "=f"(t) : "f"(x));
    asm volatile("fma.rn.f32 %0, %1, %2, %2;" : "=f"(y) : "f"(t), "f"(a));
  }
  if (OP == 1) asm volatile("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  if (OP == 2) asm volatile("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  if (OP == 3)
    asm volatile("fma.rn.f32 %0, %1, %2, %2;" : "=f"(y) : "f"(x), "f"(a));
  if (OP == 4) asm volatile("max.f32 %0, %1, %2;" : "=f"(y) : "f"(x), "f"(a));
  if (OP == 5) asm volatile("mul.f32 %0, %1, %2;" : "=f"(y) : "f"(x), "f"(a));
  return y;
}

template <int OP>
__global__ void chain(float x, float a, float* out, long long* cycles) {
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < N_LINKS / 16; ++i) {
#pragma unroll
    for (int j = 0; j < 16; ++j) x = link<OP>(x, a);
  }
  const long long t1 = clock64();
  out[0] = x;
  cycles[0] = t1 - t0;
}

// the recurrence as the kernels run it: the chain runs through s only
__global__ void step_chain(float alpha, float* out, long long* cycles) {
  MmseCarry s = mmse_carry_init(alpha);
  float g = 0.f;
  const long long t0 = clock64();
#pragma unroll 4
  for (int i = 0; i < N_LINKS; ++i)
    g += mmse_step(1.5f + 0.25f * (i & 7), 1.f, alpha, s);
  const long long t1 = clock64();
  out[0] = g + s.g2;
  cycles[0] = t1 - t0;
}

extern "C" int chain_forward(int op, float* out, long long* cycles,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (op) {
    case 0: chain<0><<<1, 1, 0, st>>>(1.5f, 0.98f, out, cycles); break;
    case 1: chain<1><<<1, 1, 0, st>>>(1.5f, 0.98f, out, cycles); break;
    case 2: chain<2><<<1, 1, 0, st>>>(1.5f, 0.98f, out, cycles); break;
    case 3: chain<3><<<1, 1, 0, st>>>(1.5f, 0.98f, out, cycles); break;
    case 4: chain<4><<<1, 1, 0, st>>>(1.5f, -0.98f, out, cycles); break;
    case 5: chain<5><<<1, 1, 0, st>>>(1.5f, 0.98f, out, cycles); break;
    default: step_chain<<<1, 1, 0, st>>>(0.98f, out, cycles); break;
  }
  return static_cast<int>(cudaGetLastError());
}
"""
CHAIN_OPS = ["rcp_then_fma", "rsqrt", "ex2", "fma", "fmnmx", "fmul",
             "mmse_step"]


def patched(text, subs, what):
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"mmse_variants: {what} has changed; "
                             f"{old[:60]!r} not found")
        text = text.replace(old, new)
    return text


def build(csrc, nvcc, flags):
    cu = (csrc / "mmse.cu").read_text()
    cuh = (csrc / "mmse.cuh").read_text()
    sources = {name: (patched(cu, cu_subs, f"{name}: mmse.cu"),
                      patched(cuh, cuh_subs, f"{name}: mmse.cuh"))
               for name, (cu_subs, cuh_subs) in VARIANTS.items()}
    sources["chains"] = (CHAINS_CU.replace("N_LINKS", str(CHAIN)), cuh)
    procs = {}
    for name, (src, header) in sources.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "mmse.cu").write_text(src)
        (d / "mmse.cuh").write_text(header)
        procs[name] = subprocess.Popen(
            [nvcc, *flags, "-I", str(d), "-I", str(csrc), "-o",
             str(d / "lib.so"), str(d / "mmse.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"mmse_variants: nvcc failed for {name}:\n{log}")
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(json.dumps({"variant": name, "ptxas": regs}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sass", type=Path, default=None,
                    help="write cuobjdump -sass of the kernel here")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("mmse_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.mmse_stsa import ref as MR

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    nvcc = _build._nvcc()
    build(_build.CSRC, nvcc, _build.NVCC_FLAGS)
    if args.sass is not None:
        cuobjdump = Path(nvcc).with_name("cuobjdump")
        if not cuobjdump.exists():
            cuobjdump = Path(shutil.which("cuobjdump") or "cuobjdump")
        args.sass.mkdir(parents=True, exist_ok=True)
        for lib in ("kernel", "chains"):
            sass = subprocess.run([str(cuobjdump), "-sass",
                                   str(OUT / lib / "lib.so")],
                                  capture_output=True, text=True)
            path = args.sass / f"mmse_{lib}.sass"
            path.write_text(sass.stdout + sass.stderr)
            print(json.dumps({"sass": str(path),
                              "lines": len(sass.stdout.splitlines())}),
                  flush=True)

    flush = torch.empty(256 * 2**20 // 4, device="cuda")

    def timed(fn, reps=20):
        for _ in range(3):
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

    rng = torch.Generator(device="cuda").manual_seed(5)
    fns = {}
    for name in VARIANTS:
        fn = ctypes.CDLL(str(OUT / name / "lib.so")).mmse_forward
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    failed = 0
    for B, F, K in SHAPES:
        power = torch.empty((B, F, K), device="cuda").exponential_(
            generator=rng)
        power[:, F // 4:F // 2, :K // 3 + 1] += 40.0
        noise = MR.estimate_noise_psd(power, 16)
        want = MR.mmse_stsa_gain_ref(power, noise)
        times, errs, oks = {}, {}, {}
        for rep in range(2):                 # in turns: forward, backward
            for name in (list(VARIANTS) if rep == 0
                         else list(VARIANTS)[::-1]):
                gains = torch.empty_like(power)

                def call(fn=fns[name], gains=gains):
                    err = fn(power.data_ptr(), noise.data_ptr(),
                             gains.data_ptr(), B, F, K, 0.98, 0.1,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")

                call()
                torch.cuda.synchronize()
                errs[name] = float((gains - want).abs().max())
                oks[name] = oks.get(name, True) and bool(
                    ((gains - want).abs() <= ATOL + RTOL * want.abs()).all())
                times.setdefault(name, []).append(timed(call))
        for name in VARIANTS:
            rec = {"shape": f"({B}, {F}, {K})", "variant": name,
                   "ms": times[name], "max_abs_err": errs[name]}
            if name not in WRONG:
                rec["within_tolerance"] = oks[name]
                failed += not oks[name]
            print(json.dumps(rec), flush=True)

    lib = ctypes.CDLL(str(OUT / "chains" / "lib.so"))
    lib.chain_forward.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_void_p]
    lib.chain_forward.restype = ctypes.c_int
    out = torch.empty(1, device="cuda")
    cycles = torch.empty(1, dtype=torch.int64, device="cuda")
    for op, name in enumerate(CHAIN_OPS):
        err = lib.chain_forward(op, out.data_ptr(), cycles.data_ptr(),
                                torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if err:
            raise RuntimeError(f"chain {name}: CUDA error {err}")
        print(json.dumps({"chain": name, "links": CHAIN,
                          "cycles": int(cycles.item()),
                          "cycles_per_link": cycles.item() / CHAIN}),
              flush=True)
    if failed:
        print(f"mmse_variants: {failed} variant runs outside rtol {RTOL}, "
              f"atol {ATOL}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
