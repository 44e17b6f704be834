// The windowed real FFT of a tile of overlapping frames in shared memory,
// shared by stft.cu and fused_tail.cu.
//
// A tile is FftShape<W>::FRAMES consecutive frames of W samples, one every
// hop = W/2 samples, so the tile reads one contiguous span of
// (FRAMES + 1) * W/2 samples. Each frame's W-point real FFT is an
// N = W/2-point complex FFT of z[n] = w[2n] x[2n] + i w[2n+1] x[2n+1]
// (w the Hamming window, applied as the frame is read), followed by the
// even/odd split into bins 0..N:
//
//   X[k] = (Z[k] + conj Z[N-k]) / 2 + e^{-2 pi i k / W} (Z[k] - conj Z[N-k]) / 2i
//
// The complex FFT is Stockham's autosort form (natural order in and out):
// radix-4 passes and, where log2 N is odd, one radix-2 pass, each between
// two buffers of FRAMES * N complex values, with a barrier after each pass.
// A pass reads its butterfly's inputs N/R apart (consecutive threads on
// consecutive addresses) and writes them Ns apart. The P threads that share
// a tile each run FRAMES * N / R / P butterflies per pass.
//
// Tables, built on the host in float64 and cast to f32 (fft_tables.py):
// tw[t] = e^{-2 pi i t / W}, t = 0 .. W-1, as (re, im) pairs, then the
// window w[0 .. W-1]. A pass's twiddle e^{-2 pi i r m / (R Ns)} is
// tw[2 N r m / (R Ns)]; the split's is tw[k]. Plain f32 on the CUDA cores.
#pragma once

template <int W>
struct FftShape {
  static_assert(W == 128 || W == 256 || W == 512, "window 128, 256 or 512");
  static constexpr int N = W / 2;             // complex points; also the hop
  static constexpr int K = N + 1;             // bins
  static constexpr int FRAMES = 8192 / W;     // FRAMES * N = 4096 complex
  static constexpr int SPAN = (FRAMES + 1) * N;   // samples a tile reads
  static constexpr int BUF = FRAMES * N;      // complex values per buffer
  static constexpr int TABLE_FLOATS = 3 * W;  // twiddles (2W) + window (W)
  // the first pass, then radix-4 passes and at most one radix-2 pass
  static constexpr int PASSES = W == 128 ? 3 : 4;
};

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// Starts copying row samples [s0, s0 + len) into dst, zeros outside
// [0, S), by P threads (thread t): cp.async of 4 bytes each, zero-filled
// where the source size is 0, so a span that starts anywhere in a row of
// any length needs no alignment case. One commit group per thread; wait
// with cp.async.wait_group and then a barrier before reading dst.
template <int P>
__device__ __forceinline__ void copy_span_async(const float* row, long long S,
                                                long long s0, int len,
                                                float* dst, int t) {
  for (int j = t; j < len; j += P) {
    const long long q = s0 + j;
    const bool in_row = q >= 0 && q < S;
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst + j));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
                 "l"(in_row ? row + q : row), "r"(in_row ? 4 : 0)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Copies the tables into shared memory (tw_s: W complex, win_s: W floats).
template <int W>
__device__ __forceinline__ void load_tables(const float* __restrict__ tables,
                                            float* tab_s, int t, int n) {
  for (int i = t; i < FftShape<W>::TABLE_FLOATS; i += n) tab_s[i] = tables[i];
}

// y = DFT_4(v) in place.
__device__ __forceinline__ void dft4(float2& v0, float2& v1, float2& v2,
                                     float2& v3) {
  const float2 a0 = cadd(v0, v2), a1 = csub(v0, v2);
  const float2 a2 = cadd(v1, v3), d = csub(v1, v3);
  const float2 a3 = make_float2(d.y, -d.x);           // -i (v1 - v3)
  v0 = cadd(a0, a2);
  v1 = cadd(a1, a3);
  v2 = csub(a0, a2);
  v3 = csub(a1, a3);
}

// First radix-4 pass (Ns = 1, no twiddles), reading the windowed frames
// straight from the span: frame f's z[n] is span[f*N + 2n .. 2n+1] times
// win[2n .. 2n+1].
template <int W, int P>
__device__ __forceinline__ void fft_pass_first(const float* span,
                                               const float* win,
                                               float2* dst, int t) {
  using Sh = FftShape<W>;
  constexpr int N = Sh::N, Q = N / 4;
  const float2* sp = reinterpret_cast<const float2*>(span);
  const float2* wp = reinterpret_cast<const float2*>(win);
  for (int i = t; i < Sh::FRAMES * Q; i += P) {
    const int f = i / Q, j = i % Q;
    const float2* s = sp + f * (N / 2);               // frame f at f*N floats
    float2 v[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float2 x = s[j + r * Q], w = wp[j + r * Q];
      v[r] = make_float2(x.x * w.x, x.y * w.y);
    }
    dft4(v[0], v[1], v[2], v[3]);
    float2* d = dst + f * N + 4 * j;
#pragma unroll
    for (int r = 0; r < 4; ++r) d[r] = v[r];
  }
}

// A radix-R pass (R = 4 or 2) of Stockham's FFT with sub-transform length
// Ns > 1: butterfly j of frame f reads src[j + r*N/R], multiplies input r
// by e^{-2 pi i r m / (R Ns)} with m = j mod Ns, and writes output r to
// dst[(j / Ns) * Ns * R + m + r * Ns].
template <int W, int R, int P>
__device__ __forceinline__ void fft_pass(const float2* src, float2* dst,
                                         const float2* tw, int Ns, int t) {
  using Sh = FftShape<W>;
  constexpr int N = Sh::N, Q = N / R;
  for (int i = t; i < Sh::FRAMES * Q; i += P) {
    const int f = i / Q, j = i % Q;
    const int m = j & (Ns - 1);
    const int step = m * (2 * N / (R * Ns));          // tw index of r = 1
    const float2* s = src + f * N;
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = s[j + r * Q];
#pragma unroll
    for (int r = 1; r < R; ++r) v[r] = cmul(v[r], tw[r * step]);
    if (R == 4) {
      dft4(v[0], v[1], v[2], v[3]);
    } else {
      const float2 a = v[0];
      v[0] = cadd(a, v[1]);
      v[1] = csub(a, v[1]);
    }
    float2* d = dst + f * N + (j - m) * R + m;
#pragma unroll
    for (int r = 0; r < R; ++r) d[r * Ns] = v[r];
  }
}

// The complex FFT of every frame of the tile, run by P threads (thread t):
// span -> out, in natural order, through the buffers a and b. The first
// pass writes a, the passes between alternate b, a, ..., and the last
// writes out, which may be the buffer the ping-pong would write next (or
// any other) but not one the last pass reads. The span may lie in b.
// `sync` is the barrier of the P threads; it has run before this returns.
template <int W, int P, typename Sync>
__device__ __forceinline__ void fft_frames(const float* span,
                                           const float* tab_s, float2* a,
                                           float2* b, float2* out, int t,
                                           Sync sync) {
  using Sh = FftShape<W>;
  constexpr int N = Sh::N;
  const float2* tw = reinterpret_cast<const float2*>(tab_s);
  const float* win = tab_s + 2 * W;
  fft_pass_first<W, P>(span, win, a, t);
  sync();
  float2* src = a;
  float2* other = b;
  int pass = 1;
#pragma unroll
  for (int Ns = 4; Ns < N; Ns *= 4, ++pass) {
    float2* dst = pass == Sh::PASSES - 1 ? out : other;
    if (Ns * 4 <= N) {
      fft_pass<W, 4, P>(src, dst, tw, Ns, t);
    } else {
      fft_pass<W, 2, P>(src, dst, tw, Ns, t);
    }
    sync();
    other = src;
    src = dst;
  }
}

// Bin k (0 .. N) of a frame whose complex FFT Z (N values) is in shared
// memory: the even/odd split of the real FFT.
template <int W>
__device__ __forceinline__ float2 rfft_bin(const float2* Z, const float2* tw,
                                           int k) {
  constexpr int N = FftShape<W>::N;
  const float2 a = Z[k & (N - 1)];
  const float2 b = Z[(N - k) & (N - 1)];
  const float2 e = make_float2(0.5f * (a.x + b.x), 0.5f * (a.y - b.y));
  const float2 o = make_float2(0.5f * (a.y + b.y), -0.5f * (a.x - b.x));
  return cadd(e, cmul(tw[k], o));
}
