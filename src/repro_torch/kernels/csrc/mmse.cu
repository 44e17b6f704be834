// Decision-directed MMSE-STSA spectral gain: gains (B, F, K) from power
// (B, F, K) and noise PSD (B, K), sequential over frames, independent per
// (row, bin).
//
// Replaces: src/repro/kernels/mmse_stsa/kernel.py, mmse_gain_pallas (body
// _mmse_kernel, i0e_poly / i1e_poly). On the main path it runs in the
// staged survivor tail: (R, 860, 129) power and (R, 129) noise, R = 19, 35
// and 22 on the seed-25 stream.
//
// What bounds it on an H100: neither bytes nor operations but latency.
// Bytes (8 per step) and flops (about 64 per step) would both take a few
// microseconds, but the recurrence is a chain of F dependent steps of
// about 73 instructions each as built (mmse.cuh), and there are only R*K
// independent chains (2,451 at R = 19): too few threads to hide that
// latency. The kernel can at best run at the chain's pace; everything else
// has to stay off it.
//
// Design:
//   - One block per (row, tile of 32 bins): one warp, one thread per bin
//     carrying the recurrence in registers; 5 blocks per row at K = 129,
//     95 to 175 blocks on the main path. A warp then has its scheduler to
//     itself on all but a few SMs. One block of 5 warps per row puts two
//     chain warps on one of an SM's 4 schedulers, and on an H100 ran about
//     1.3 times as long (scripts/mmse_variants.py, variant `row`).
//   - The frames reach shared memory ahead of the chain, never by a load
//     on it: the block walks its frames in chunks of Fc (at most
//     MMSE_CHUNK), and the power of a chunk's frames and the block's bins,
//     power[b, t0 : t0+Fc, k0 : k0+nb], lies inside one contiguous run of
//     (Fc-1)*K + nb floats. Thread 0 copies that run, other bins included,
//     into a ring of MMSE_STAGES slots with one cp.async.bulk (the Tensor
//     Memory Accelerator's 1-D copy) that completes on the slot's
//     mbarrier, MMSE_STAGES - 1 chunks ahead of the chunk being stepped
//     through. The run is K/32 times the tile's bytes; the row's other
//     blocks read the same runs, from L2, and the card moves them far
//     faster than the chain consumes them.
//   - A run starts wherever (b, t0, k0) puts it: K = 129 makes a frame 516
//     bytes, so a run is 4-byte aligned only, and no tensor map can
//     describe a tile of it. The bulk copy starts at the 16-byte boundary
//     at or below the run and ends at the one at or above it; the slot
//     mirrors memory from that boundary, and the consumers skip the lead-in
//     floats. Where rounding would leave the tensor (a base at an odd float
//     offset at the front, the last run's end at the back), those floats,
//     at most 3 at each end, go by 4-byte cp.async that arrive on the same
//     mbarrier (cp.async.mbarrier.arrive). No copy reads outside the
//     tensor. kernels/mmse_stsa/tiling.py mirrors this schedule on the
//     host, and tests/test_torch_mmse_layout.py checks it on the CPU.
//   - Waits are once per chunk: one __syncthreads (every thread is done
//     with the slot that the next copy overwrites) and one mbarrier wait.
//     Inside a chunk each thread reads its bin of a frame from shared
//     memory once, two frames ahead of the step, and forms the frame's
//     power-only terms (gamma, 1/gamma, the prior) one step ahead, so that
//     neither the read nor those terms sit on the chain.
//   - Gains go out as plain 4-byte stores, a warp's consecutive in memory:
//     nothing waits on them.
// Shared memory at K = 129: 3 slots of 32.7 KB, 98 KB a block, so that two
// blocks fit an SM when the rows outnumber the SMs' share (35 rows: 175
// blocks on 132 SMs).
#include <cstdint>

#include "common.cuh"
#include "mmse.cuh"

constexpr int MMSE_STAGES = 3;       // ring slots
constexpr int MMSE_CHUNK = 64;       // frames of a chunk, at most
constexpr int MMSE_BINS = 32;        // bins a block: one warp
constexpr int MMSE_RING_BYTES = 112 * 1024;  // the ring, at most

struct MmseLayout {
  int tiles;          // blocks a row
  int fc;             // frames a chunk
  int stage_floats;   // floats of one ring slot
};

// Floats of a slot for runs of fc frames of nb bins: the run plus up to 3
// lead-in floats, rounded up to 16 bytes.
static int mmse_stage_floats(int fc, int K, int nb) {
  return (3 + (fc - 1) * K + nb + 3) / 4 * 4;
}

static MmseLayout mmse_layout(int F, int K) {
  MmseLayout L;
  L.tiles = (K + MMSE_BINS - 1) / MMSE_BINS;
  const int nb = MMSE_BINS < K ? MMSE_BINS : K;
  L.fc = 1;
  while (L.fc < MMSE_CHUNK && L.fc < F &&
         MMSE_STAGES * 4 * mmse_stage_floats(L.fc + 1, K, nb) <=
             MMSE_RING_BYTES)
    ++L.fc;
  L.stage_floats = mmse_stage_floats(L.fc, K, nb);
  return L;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// Where chunk c of a block's (row b, bins k0 .. k0+nb) starts, in floats
// from the 16-byte boundary at or below `power`: the run is [s, s + len).
struct MmseRun {
  long long s, len;
};

__device__ __forceinline__ MmseRun mmse_run(long long base, int b, int F,
                                            int K, int k0, int nb, int fc,
                                            int c) {
  const int t0 = c * fc;
  const int nf = min(fc, F - t0);
  return MmseRun{base + (static_cast<long long>(b) * F + t0) * K + k0,
                 static_cast<long long>(nf - 1) * K + nb};
}

// Thread 0: copy run `r` into `slot` (which mirrors memory from the
// 16-byte boundary at or below r.s), completing on `bar`. The tensor is
// [base, end) in the same units; `origin` is float 0.
__device__ void mmse_issue(const float* origin, long long base,
                           long long end, MmseRun r, float* slot,
                           uint64_t* bar) {
  const long long s = r.s, e = r.s + r.len;
  const long long as = s & ~3LL;
  long long bs = as >= base ? as : (s + 3) & ~3LL;     // bulk [bs, be)
  long long be = ((e + 3) & ~3LL) <= end ? (e + 3) & ~3LL : e & ~3LL;
  if (be <= bs) bs = be = e;                  // too short: 4-byte copies
  const unsigned b_addr = smem_addr(bar);
  if (s < bs || be < e) {
    for (long long i = s; i < e; ++i) {
      if (i == bs) i = be;                    // past the bulk copy's part
      if (i >= e) break;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                       smem_addr(slot + (i - as))),
                   "l"(origin + i)
                   : "memory");
    }
    // one more pending arrival, made when those copies have landed
    asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];" ::"r"(
                     b_addr)
                 : "memory");
  }
  const unsigned bytes = static_cast<unsigned>(4 * (be - bs));
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   b_addr),
               "r"(bytes)
               : "memory");
  if (bytes > 0)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_addr(slot + (bs - as))),
        "l"(origin + bs), "r"(bytes), "r"(b_addr)
        : "memory");
}

__global__ void __launch_bounds__(MMSE_BINS)
mmse_kernel(const float* __restrict__ power, const float* __restrict__ noise,
            float* __restrict__ gain, int B, int F, int K, int fc,
            int stage_floats, float alpha, float gain_floor) {
  extern __shared__ __align__(16) float ring[];
  __shared__ __align__(8) uint64_t full[MMSE_STAGES];
  const int b = blockIdx.y;
  const int k0 = blockIdx.x * MMSE_BINS;
  const int nb = min(MMSE_BINS, K - k0);
  const int kk = threadIdx.x;
  const bool live = kk < nb;
  const int n_chunks = (F + fc - 1) / fc;
  // power in floats from the 16-byte boundary at or below it
  const uintptr_t p_addr = reinterpret_cast<uintptr_t>(power);
  const float* origin =
      reinterpret_cast<const float*>(p_addr & ~uintptr_t{15});
  const long long base = static_cast<long long>((p_addr & 15) >> 2);
  const long long end = base + static_cast<long long>(B) * F * K;

  if (threadIdx.x == 0) {
    for (int i = 0; i < MMSE_STAGES; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       smem_addr(&full[i]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int c = 0; c < MMSE_STAGES - 1 && c < n_chunks; ++c)
      mmse_issue(origin, base, end, mmse_run(base, b, F, K, k0, nb, fc, c),
                 ring + c * stage_floats, &full[c]);

  const float inv_lam =
      live ? 1.f / fmaxf(noise[static_cast<long long>(b) * K + k0 + kk],
                         1e-10f)
           : 0.f;
  MmseCarry carry = mmse_carry_init(alpha);
  float* out = gain + static_cast<long long>(b) * F * K + k0 + kk;
  for (int c = 0; c < n_chunks; ++c) {
    const int slot = c % MMSE_STAGES;
    if (c > 0) __syncthreads();     // every thread is done with chunk c-1
    const int cn = c + MMSE_STAGES - 1;
    if (threadIdx.x == 0 && cn < n_chunks) {   // into chunk c-1's slot
      const int sn = cn % MMSE_STAGES;
      mmse_issue(origin, base, end, mmse_run(base, b, F, K, k0, nb, fc, cn),
                 ring + sn * stage_floats, &full[sn]);
    }
    mbar_wait(&full[slot], (c / MMSE_STAGES) & 1);
    if (live) {
      const MmseRun r = mmse_run(base, b, F, K, k0, nb, fc, c);
      const int nf = min(fc, F - c * fc);
      const float* st = ring + slot * stage_floats + (r.s & 3) + kk;
      // frame f+1's terms are formed during step f, from a power read
      // during step f-1
      MmseFrame next = mmse_frame(st[0], inv_lam, alpha);
      float p_next = st[min(1, nf - 1) * K];
#pragma unroll 4
      for (int f = 0; f < nf; ++f) {
        const MmseFrame fr = next;
        next = mmse_frame(p_next, inv_lam, alpha);
        p_next = st[min(f + 2, nf - 1) * K];
        const float g = mmse_step(fr, carry);
        *out = fmaxf(g, gain_floor);
        out += K;
      }
    }
  }
}

// power: (B, F, K), noise: (B, K), gain: (B, F, K); f32, contiguous, on
// the current device (power at any 4-byte alignment). Returns a
// cudaError_t code.
extern "C" int mmse_forward(const float* power, const float* noise,
                            float* gain, int B, int F, int K, float alpha,
                            float gain_floor, void* stream) {
  if (B <= 0 || F <= 0 || K <= 0) return 0;
  const MmseLayout L = mmse_layout(F, K);
  const size_t smem = sizeof(float) * MMSE_STAGES * L.stage_floats;
  cudaError_t err = allow_shared_bytes(mmse_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(L.tiles), static_cast<unsigned>(B));
  mmse_kernel<<<grid, MMSE_BINS, smem,
                static_cast<cudaStream_t>(stream)>>>(
      power, noise, gain, B, F, K, L.fc, L.stage_floats, alpha, gain_floor);
  return static_cast<int>(cudaGetLastError());
}
