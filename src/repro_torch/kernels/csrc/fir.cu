// Causal FIR filter with decimation: y[b, n] = sum_k h[k] * x[b, n*s - k],
// x zero-padded on the left, n < S / s.
//
// Replaces: src/repro/kernels/fir_hpf/kernel.py, fir_pallas (body
// _fir_kernel). On the main path it is the `compress` stage: 129 taps,
// stride 2, (4, 2,646,000) -> (4, 1,323,000); the staged survivor tail's
// `hpf` stage runs it at stride 1.
//
// What bounds it on an H100: about even. It reads 4 bytes and writes 2
// per output pair (about 19 us at 3.35 TB/s at the main-path shape) and
// does 2*129 flops per output (about 20 us at the f32 FMA peak). So the
// FMA units have to run near their peak with the HBM stream behind them,
// and no other unit may be the limit first: one output a thread, with two
// shared loads per FMA, is held by shared-memory wavefronts to about 12x
// the bound. This design runs at about 3x; PERF.md splits its time
// (scripts/fir_variants.py).
//
// Design (the host side, tap table and layout, is fir_hpf/tiling.py; the
// index maps are emulated on the CPU in tests/test_torch_fir_tiling.py):
// - Polyphase. With the taps reversed and zero padded to G[p][a] (phase p,
//   A taps a row), each phase is a stride-1 correlation of its own samples
//   x[(n + a)*s + p - L]: the TPU kernel's polyphase view, here so that a
//   thread's samples are consecutive at any stride.
// - Register tiling. A thread sums R = 16 consecutive outputs. For each
//   chunk of 16 taps it loads a window of 32 samples (8 float4 loads) and
//   does 256 FMAs: 8 warp-FMAs per shared wavefront. An SM issues 4
//   warp-FMAs and serves 1 wavefront a clock, so shared memory needs half
//   the FMA units' time and is off the critical path.
// - Taps off the load path. The table lives in the launch's parameters
//   (constant bank, __grid_constant__) when it has at most FIR_PARAM_TAPS
//   entries: each tap is a warp-uniform constant read, no shared load. A
//   longer table goes through the same kernel (another instance) with each
//   stage's taps in shared memory, read as broadcasts and used 16 times.
// - Conflict-free loads. A stage stores sample q at q + 4*(q/16): the 8
//   float4 loads of a quarter-warp (lanes 16 samples apart) then hit 8
//   distinct groups of 4 banks.
// - Loads that overlap the FMAs. A grid of persistent blocks (as many as
//   fit on the card) walks the (row, tile) list; a tile is P*NB items
//   (phase, block of at most FIR_TAP_BLOCK taps), each one stage of a
//   3-stage ring that cp.async fills two items ahead of the one being
//   summed, with one barrier per item. The copy is 4 bytes a sample,
//   zero-filled outside the row, so the causal halo, the row's end and
//   the phase split need no other path.
// - A finished tile goes through the stage it was summed from, so that y
//   is written in coalesced runs, masked at the row's end.
// The sums run over phases, then taps in ascending order: another order
// than the reference's convolution, well inside rtol 1e-4, atol 1e-5.
#include "common.cuh"

#include <climits>
#include <mutex>

constexpr int FIR_THREADS = 256;
constexpr int FIR_R = 16;                       // outputs per thread
constexpr int FIR_TILE = FIR_THREADS * FIR_R;   // outputs per tile
constexpr int FIR_CHUNK = 16;                   // taps per unrolled chunk
constexpr int FIR_TAP_BLOCK = 256;              // taps of one phase a stage
constexpr int FIR_PARAM_TAPS = 512;             // table size in parameters
constexpr int FIR_STAGES = 3;                   // shared-memory ring

struct FirTaps {
  float g[FIR_PARAM_TAPS];
};

struct FirShape {
  long long S, out_len;
  int tiles_per_row, n_tiles, stride, L, P, A, NB;
  int Q;   // samples a stage holds: FIR_TILE + min(A, FIR_TAP_BLOCK)
  int Qs;  // its skewed length in floats
};

__host__ __device__ constexpr int fir_skew(int q) { return q + 4 * (q >> 4); }
__host__ __device__ constexpr int fir_skewed_len(int n) {
  return n + 4 * ((n + 15) / 16);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// One chunk of C taps into the thread's R accumulators: the window of
// samples q .. q + R + C - 2 of the stage, then R*C FMAs. `tap(j)` is the
// chunk's j-th tap. q is a multiple of 4; in a full chunk it is a multiple
// of 16, and the window's slots are then fixed offsets from q's.
template <int C, typename Tap>
__device__ __forceinline__ void fir_chunk(float (&acc)[FIR_R],
                                          const float* stage, int q,
                                          Tap tap) {
  constexpr int W = (FIR_R + C - 1 + 3) / 4 * 4;
  float w[W];
  const float* win = stage + fir_skew(q);
#pragma unroll
  for (int v = 0; v < W / 4; ++v) {
    const float* src = C % 16 == 0 ? win + 4 * v + 4 * (v / 4)
                                   : stage + fir_skew(q + 4 * v);
    const float4 t = *reinterpret_cast<const float4*>(src);
    w[4 * v] = t.x;
    w[4 * v + 1] = t.y;
    w[4 * v + 2] = t.z;
    w[4 * v + 3] = t.w;
  }
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const float g = tap(j);
#pragma unroll
    for (int r = 0; r < FIR_R; ++r) acc[r] = fmaf(g, w[r + j], acc[r]);
  }
}

// One item of a block's walk: tile t (row t / tiles_per_row), phase p,
// tap block b.
struct FirItem {
  int t, p, b;
  __device__ void advance(const FirShape& sh) {
    if (++b < sh.NB) return;
    b = 0;
    if (++p < sh.P) return;
    p = 0;
    t += gridDim.x;
  }
};

template <bool kSharedTaps>
__global__ void __launch_bounds__(FIR_THREADS, 2)
fir_kernel(const float* __restrict__ x, float* __restrict__ y,
           const float* __restrict__ gtab, const FirShape sh,
           const __grid_constant__ FirTaps taps) {
  extern __shared__ __align__(16) float smem[];
  float* const taps_s = smem + FIR_STAGES * sh.Qs;   // FIR_STAGES blocks
  const int tid = threadIdx.x;
  const int i0 = tid * FIR_R;

  // Starts copying item `it` into stage `slot`. Slot q holds sample
  // g0 + q*stride of the row; the slots in [q_lo, q_hi) lie inside the row
  // and are copied, the others zero-filled.
  auto issue = [&](const FirItem& it, int slot) {
    const int row = it.t / sh.tiles_per_row;
    const long long n0 =
        static_cast<long long>(it.t % sh.tiles_per_row) * FIR_TILE;
    const float* xr = x + row * sh.S;
    const long long g0 =
        (n0 + static_cast<long long>(it.b) * FIR_TAP_BLOCK) * sh.stride -
        sh.L + it.p;
    const int q_lo = g0 >= 0 ? 0
                             : static_cast<int>((sh.stride - 1 - g0) /
                                                sh.stride);
    const long long rem = sh.S - g0;
    const int q_hi =
        rem >= static_cast<long long>(sh.Q) * sh.stride ? sh.Q
        : rem <= 0 ? 0
                   : static_cast<int>((rem + sh.stride - 1) / sh.stride);
    const long long step = static_cast<long long>(FIR_THREADS) * sh.stride;
    const float* src = xr + g0 + static_cast<long long>(tid) * sh.stride;
    float* dst = smem + slot * sh.Qs + fir_skew(tid);
    for (int q = tid; q < sh.Q;
         q += FIR_THREADS, src += step, dst += fir_skew(FIR_THREADS)) {
      const bool in_row = q >= q_lo && q < q_hi;
      cp_async4(dst, in_row ? src : xr, in_row);
    }
    if (kSharedTaps) {
      const int a_end = min(FIR_TAP_BLOCK, sh.A - it.b * FIR_TAP_BLOCK);
      const float* gp = gtab + it.p * sh.A + it.b * FIR_TAP_BLOCK;
      for (int a = tid; a < a_end; a += FIR_THREADS)
        cp_async4(taps_s + slot * FIR_TAP_BLOCK + a, gp + a, true);
    }
  };

  float acc[FIR_R];
#pragma unroll
  for (int r = 0; r < FIR_R; ++r) acc[r] = 0.f;

  // The ring: item i goes to stage i % FIR_STAGES, two items ahead of the
  // one being summed. One barrier per item (and two more per tile for the
  // store): once every thread has passed it, the stage summed in the
  // previous item is free for the next copy.
  FirItem cur{static_cast<int>(blockIdx.x), 0, 0};
  FirItem next = cur;
  for (int i = 0; i < FIR_STAGES - 1; ++i) {
    if (next.t < sh.n_tiles) issue(next, i);
    asm volatile("cp.async.commit_group;" ::: "memory");
    next.advance(sh);
  }
  for (int slot = 0; cur.t < sh.n_tiles;
       slot = slot == FIR_STAGES - 1 ? 0 : slot + 1) {
    asm volatile("cp.async.wait_group %0;" ::"n"(FIR_STAGES - 2)
                 : "memory");
    __syncthreads();                       // item cur is in stage `slot`
    if (next.t < sh.n_tiles)
      issue(next, slot == 0 ? FIR_STAGES - 1 : slot - 1);
    asm volatile("cp.async.commit_group;" ::: "memory");
    next.advance(sh);

    const float* st = smem + slot * sh.Qs;
    const int ab = min(FIR_TAP_BLOCK, sh.A - cur.b * FIR_TAP_BLOCK);
    const float* ts = taps_s + slot * FIR_TAP_BLOCK;
    const int tbase = cur.p * sh.A + cur.b * FIR_TAP_BLOCK;
    int a0 = 0;
    for (; a0 + FIR_CHUNK <= ab; a0 += FIR_CHUNK) {
      if (kSharedTaps)
        fir_chunk<FIR_CHUNK>(acc, st, i0 + a0,
                             [&](int j) { return ts[a0 + j]; });
      else
        fir_chunk<FIR_CHUNK>(acc, st, i0 + a0,
                             [&](int j) { return taps.g[tbase + a0 + j]; });
    }
    for (; a0 < ab; a0 += 4) {
      if (kSharedTaps)
        fir_chunk<4>(acc, st, i0 + a0, [&](int j) { return ts[a0 + j]; });
      else
        fir_chunk<4>(acc, st, i0 + a0,
                     [&](int j) { return taps.g[tbase + a0 + j]; });
    }

    if (cur.p == sh.P - 1 && cur.b == sh.NB - 1) {   // the tile is summed
      // through the stage just summed (refilled only after the next
      // item's barrier), so that y is written in coalesced runs
      float* outs = smem + slot * sh.Qs;
      __syncthreads();
#pragma unroll
      for (int v = 0; v < FIR_R / 4; ++v) {
        *reinterpret_cast<float4*>(outs + fir_skew(i0 + 4 * v)) =
            make_float4(acc[4 * v], acc[4 * v + 1], acc[4 * v + 2],
                        acc[4 * v + 3]);
      }
#pragma unroll
      for (int r = 0; r < FIR_R; ++r) acc[r] = 0.f;
      __syncthreads();
      const int row = cur.t / sh.tiles_per_row;
      const long long n0 =
          static_cast<long long>(cur.t % sh.tiles_per_row) * FIR_TILE;
      const int n_out = static_cast<int>(
          min(static_cast<long long>(FIR_TILE), sh.out_len - n0));
      float* yr = y + row * sh.out_len + n0;
      for (int i = tid; i < n_out; i += FIR_THREADS) yr[i] = outs[fir_skew(i)];
    }
    cur.advance(sh);
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// x: (B, S), y: (B, out_len) with out_len = S / stride, f32, contiguous,
// on the current device. The tap table (P, A) as fir_hpf/tiling.py builds
// it: g_host in host memory, and, when P*A > FIR_PARAM_TAPS, g_dev on the
// device. Returns a cudaError_t code.
extern "C" int fir_forward(const float* x, float* y, const float* g_host,
                           const float* g_dev, int B, long long S,
                           long long out_len, int stride, int L, int P,
                           int A, void* stream) {
  if (B <= 0 || out_len <= 0) return 0;
  const int NB = (A + FIR_TAP_BLOCK - 1) / FIR_TAP_BLOCK;
  const bool shared_taps = P * A > FIR_PARAM_TAPS;
  if (stride < 1 || P < 1 || A < 4 || A % 4 != 0 ||
      (shared_taps && g_dev == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);

  const long long tiles_per_row = (out_len + FIR_TILE - 1) / FIR_TILE;
  if (tiles_per_row * B > INT_MAX / 2)       // tile indices stay in int
    return static_cast<int>(cudaErrorInvalidValue);
  FirShape sh;
  sh.S = S;
  sh.out_len = out_len;
  sh.tiles_per_row = static_cast<int>(tiles_per_row);
  sh.n_tiles = static_cast<int>(tiles_per_row * B);
  sh.stride = stride;
  sh.L = L;
  sh.P = P;
  sh.A = A;
  sh.NB = NB;
  sh.Q = FIR_TILE + (A < FIR_TAP_BLOCK ? A : FIR_TAP_BLOCK);
  sh.Qs = fir_skewed_len(sh.Q);
  FirTaps taps{};
  if (!shared_taps)
    for (int i = 0; i < P * A; ++i) taps.g[i] = g_host[i];

  const size_t smem =
      sizeof(float) * FIR_STAGES *
      (sh.Qs + (shared_taps ? FIR_TAP_BLOCK : 0));
  auto kernel = shared_taps ? fir_kernel<true> : fir_kernel<false>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long fit = 0;
  {
    // blocks that fit on the card, per device, instance and shared size:
    // the attribute and occupancy queries cost more than the launch
    struct Fit {
      size_t smem;
      long long blocks;
    };
    static std::mutex mu;
    static Fit cache[2][64];
    std::lock_guard<std::mutex> lock(mu);
    Fit* c = dev < 64 ? &cache[shared_taps][dev] : nullptr;
    if (c != nullptr && c->smem == smem && c->blocks > 0) {
      fit = c->blocks;
    } else {
      int sms = 0, per_sm = 0;
      err = allow_shared_bytes(kernel, smem);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, FIR_THREADS, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      fit = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
      if (c != nullptr) *c = {smem, fit};
    }
  }
  const unsigned grid =
      static_cast<unsigned>(sh.n_tiles < fit ? sh.n_tiles : fit);
  kernel<<<grid, FIR_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      x, y, shared_taps ? g_dev : nullptr, sh, taps);
  return static_cast<int>(cudaGetLastError());
}
