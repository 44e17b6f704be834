#!/usr/bin/env python3
"""Split the FIR kernel's time (`csrc/fir.cu`) between its copies, its
shared and constant loads and its FMAs, on the card.

    python3 scripts/fir_variants.py

Builds variants of `fir.cu` with nvcc (one per source, in parallel) into
`build/fir_variants/` and times each at the main path's compress shape,
(4, 2,646,000) -> (4, 1,323,000) at stride 2, and the staged tail's
high-pass shape, (48, 110,250) at stride 1, both with 129 taps: the median
of 20 runs by CUDA events with the 50 MB L2 overwritten before each, as
`chip_smoke.py` times kernels. The variants other than `kernel` compute
wrong values on purpose; only their times mean anything:

  kernel            the kernel as it is
  no_copy           the ring's copies removed: loads, FMAs and barriers
  fma_only          also no shared or tap loads: taps are immediates and
                    the window is made in registers
  fma_only_x4       fma_only with every item's taps summed 4 times
  kernel_x4         the kernel with every item's taps summed 4 times
  copy16            the 4-byte copies replaced by 16-byte ones of the same
                    number of bytes
  bulk              the copies replaced by one bulk copy (cp.async.bulk,
                    completion on an mbarrier) of a stage's size per item

The x4 variants separate the per-item work (a quarter of x4 - x1 per
repeat) from what is fixed per launch. One JSON line per variant and
shape, and the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "fir_variants"

COPY_LOOP = """    for (int q = tid; q < sh.Q;
         q += FIR_THREADS, src += step, dst += fir_skew(FIR_THREADS)) {
      const bool in_row = q >= q_lo && q < q_hi;
      cp_async4(dst, in_row ? src : xr, in_row);
    }"""
COPY16 = """    (void)src; (void)dst; (void)step; (void)q_lo; (void)q_hi;
    {
      const long long f0 = (row * sh.S + (g0 > 0 ? g0 : 0)) & ~3LL;
      const long long total = sh.S * (sh.n_tiles / sh.tiles_per_row);
      float* st = smem + slot * sh.Qs;
      for (int g = tid; g < sh.Q / 4; g += FIR_THREADS) {
        const long long f = f0 + 4LL * g;
        const bool ok = f + 4 <= total;
        const unsigned d = static_cast<unsigned>(
            __cvta_generic_to_shared(st + fir_skew(4 * g)));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                     ::"r"(d), "l"(ok ? x + f : x), "r"(ok ? 16 : 0)
                     : "memory");
      }
    }"""
MBAR_INIT = (
    "  const int tid = threadIdx.x;\n  const int i0 = tid * FIR_R;\n",
    """  const int tid = threadIdx.x;
  const int i0 = tid * FIR_R;
  __shared__ __align__(8) unsigned long long mbar[FIR_STAGES];
  if (tid == 0) {
    for (int i = 0; i < FIR_STAGES; ++i) {
      const unsigned a = (unsigned)__cvta_generic_to_shared(&mbar[i]);
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(a)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
""")
BULK_COPY = (COPY_LOOP, """    (void)src; (void)dst; (void)step; (void)q_lo; (void)q_hi;
    if (tid == 0) {
      const long long total = sh.S * (sh.n_tiles / sh.tiles_per_row);
      long long fa = (row * sh.S + (g0 > 0 ? g0 : 0)) & ~3LL;
      const int nfl = (sh.Qs / 4) * 4;
      if (fa + nfl > total) fa = (total - nfl) & ~3LL;
      const unsigned bytes = nfl * 4;
      const unsigned mb = (unsigned)__cvta_generic_to_shared(&mbar[slot]);
      const unsigned d =
          (unsigned)__cvta_generic_to_shared(smem + slot * sh.Qs);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   ::"r"(mb), "r"(bytes) : "memory");
      asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::"
                   "complete_tx::bytes [%0], [%1], %2, [%3];"
                   ::"r"(d), "l"(x + fa), "r"(bytes), "r"(mb) : "memory");
    }""")
BULK_WAIT = (
    """  for (int slot = 0; cur.t < sh.n_tiles;
       slot = slot == FIR_STAGES - 1 ? 0 : slot + 1) {
""",
    """  int n_done = 0;
  for (int slot = 0; cur.t < sh.n_tiles;
       slot = slot == FIR_STAGES - 1 ? 0 : slot + 1, ++n_done) {
    {
      const unsigned mb = (unsigned)__cvta_generic_to_shared(&mbar[slot]);
      const unsigned parity = (n_done / FIR_STAGES) & 1;
      unsigned landed = 0;
      while (!landed)
        asm volatile("{ .reg .pred p; mbarrier.try_wait.parity.shared::cta"
                     ".b64 p, [%1], %2; selp.u32 %0, 1, 0, p; }"
                     : "=r"(landed) : "r"(mb), "r"(parity) : "memory");
    }
""")
NO_COPY = ("cp_async4(dst, in_row ? src : xr, in_row);", "(void)in_row;")
IMM_TAPS = ("const float g = tap(j);",
            "const float g = 0.5f + 0.01f * j; (void)tap;")
REG_WINDOW = ("const float4 t = *reinterpret_cast<const float4*>(src);",
              "const float4 t = make_float4(__int_as_float(q + 4 * v), "
              "__int_as_float(q + 4 * v + 1), __int_as_float(q + 4 * v + 2),"
              " __int_as_float(q + 4 * v + 3)); (void)src;")
X4 = [("    int a0 = 0;\n    for (; a0 + FIR_CHUNK <= ab;",
       "    int a0 = 0;\n    for (int rep = 0; rep < 4; ++rep) { a0 = 0;\n"
       "    for (; a0 + FIR_CHUNK <= ab;"),
      ("[&](int j) { return taps.g[tbase + a0 + j]; });\n    }\n\n",
       "[&](int j) { return taps.g[tbase + a0 + j]; });\n    }\n    }\n\n")]
VARIANTS = {
    "kernel": [],
    "no_copy": [NO_COPY],
    "fma_only": [NO_COPY, IMM_TAPS, REG_WINDOW],
    "fma_only_x4": [NO_COPY, IMM_TAPS, REG_WINDOW, *X4],
    "kernel_x4": X4,
    "copy16": [(COPY_LOOP, COPY16)],
    "bulk": [MBAR_INIT, BULK_COPY, BULK_WAIT],
}


def build(csrc, nvcc, flags):
    base = (csrc / "fir.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        src = base
        for old, new in subs:
            if old not in src:
                raise SystemExit(f"fir_variants: {name}: fir.cu has changed; "
                                 f"{old[:60]!r} not found")
            src = src.replace(old, new)
        cu = OUT / f"fir_{name}.cu"
        cu.write_text(src)
        procs[name] = subprocess.Popen(
            [nvcc, *flags, "-I", str(csrc), "-o", str(OUT / f"lib{name}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"fir_variants: nvcc failed for {name}:\n{log}")


def main():
    import torch
    if not torch.cuda.is_available():
        print("fir_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.fir_hpf import ref as FR
    from repro_torch.kernels.fir_hpf import tiling
    torch.backends.cudnn.allow_tf32 = False

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    build(_build.CSRC, _build._nvcc(), _build.NVCC_FLAGS)

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

    gen = torch.Generator(device="cuda").manual_seed(3)
    shapes = [(4, 2_646_000, 2, FR.bandpass_decimate_taps(
                  1000.0, 11_025.0, 44_100, 129)),
              (48, 110_250, 1, FR.highpass_taps(1000.0, 22_050, 129))]
    for B, S, stride, h in shapes:
        x = torch.randn((B, S), generator=gen, device="cuda") * 0.3
        lay = tiling.layout(h.shape[0], stride)
        table = tiling.phase_taps(h, stride)
        out_len = S // stride
        want = FR.fir_ref(x, h, stride)
        for name in VARIANTS:
            fn = ctypes.CDLL(str(OUT / f"lib{name}.so")).fir_forward
            fn.argtypes = [ctypes.c_void_p] * 4 + [
                ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            y = torch.empty((B, out_len), device="cuda")
            stream = torch.cuda.current_stream().cuda_stream

            def call():
                err = fn(x.data_ptr(), y.data_ptr(), table.ctypes.data, None,
                         B, S, out_len, stride, lay.L, lay.P, lay.A, stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            call()
            torch.cuda.synchronize()
            print(json.dumps({
                "shape": f"({B}, {S}) s={stride}", "variant": name,
                "ms": timed(call),
                "max_abs_err": float((y - want).abs().max())}), flush=True)
        print(json.dumps({"shape": f"({B}, {S}) s={stride}",
                          "variant": "fir_ref (conv1d)",
                          "ms": timed(lambda: FR.fir_ref(x, h, stride))}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
