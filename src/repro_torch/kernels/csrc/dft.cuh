// The windowed real DFT of a tile of frames on the tensor cores, for the
// windows that the FFT passes of fft.cuh do not take: every even W from 4
// to 510 other than 128 and 256. Shared by stft.cu and fused_tail.cu.
//
// Replaces the TPU kernels' DFT matmul (src/repro/kernels/stft_dft/
// kernel.py, _stft_kernel; the same basis in fused_tail/kernel.py) with
// the same idea folded in half. With v = w x the windowed frame (w the
// Hamming window) and hop = W/2, fold each frame around its middle:
//
//   e[n] = v[n] + v[W-n],  o[n] = v[n] - v[W-n]     (0 < n < W/2)
//   e[0] = v[0], e[W/2] = v[W/2]
//
// Then, for the bins k = 0 .. W/2,
//
//   Re X[k] = sum_{n=0}^{W/2} e[n] cos(2 pi n k / W)
//   Im X[k] = sum_{n=1}^{W/2-1} o[n] (-sin(2 pi n k / W))
//
// two products of depth W/2 + 1 (padded with zeros to D, a multiple of 8)
// in place of one of depth W. The basis comes from the host's f32 table
// (fft_tables.dft_basis: for each bin its cos row, then its -sin row, D
// floats each, zero where a row has no term); the window follows it.
//
// Precision: TF32 keeps 10 mantissa bits, and one TF32 product misses the
// kernels' 2e-4 tolerance (max |err| 3e-3 at W = 382 in the CPU
// emulation). So each operand is split, a = hi + lo with hi = rna(a) and
// lo = rna(a - hi), rna being cvt.rna.tf32.f32's rounding (the tensor
// core would truncate a raw f32), and each step runs three products,
// lo hi + hi lo + hi hi, with f32 accumulation ("3xTF32"): within 1e-5 of
// a float64 rfft. cvt.rna.tf32.f32 compiles to four instructions on
// sm_90a (an add, a test for Inf and NaN, a select, a mask); every operand
// here is finite, so tf32_rna keeps the add and the mask, the same bits.
//
// The tile: a block stages the basis of DFT_BINS bins once (cp.async, 16
// bytes) and the samples of its frames as segments of hop + 1 samples,
// one segment every dft_seg(W) floats: frame f is segments f and f + 1.
// Its warps run mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 on
// 16 MT frames x 8 NT bins each (16 x 32 in the STFT, 16 x 16 in the
// fused tail), the cos and the -sin product with the same (frame, bin)
// fragment coordinates, so a lane ends up holding Re and Im of the same
// bins. A lane folds its own A fragments
// from the segments as it loads them (e and o of one (frame, n) from the
// same two samples), so the tile needs no e and o rows in shared memory
// and no pass of its own to fold them. Segments and basis rows are an odd
// multiple of 4 floats apart, so the 32 lanes' fragment loads (8 rows, 4
// consecutive floats each) hit 32 different banks. W is a runtime value:
// one instance serves every window.
//
// What bounds it on an H100: neither the tensor cores (at W = 382 the
// folded product is 6.1 G multiply-adds for the main path's 27,680
// frames, 0.025 ms at the TF32 peak) nor bytes (0.019 ms), but the
// instructions around each mma.sync: every fragment value is loaded from
// shared memory, folded or not, and split (about four instructions), 11
// issue slots an mma in the fused tail's k-loop (SASS). wgmma, with B read
// from shared memory by the tensor cores, is the next step if the tile
// stays above twice its bound.
#pragma once

#include <cstdint>

constexpr int DFT_BINS = 32;   // bins of a block's basis tile

// The folded depth, n = 0 .. W/2 padded to a multiple of 8 (one k-step).
__host__ __device__ constexpr int dft_depth(int W) {
  return (W / 2 + 1 + 7) / 8 * 8;
}
// Floats between basis rows in shared memory: an odd multiple of 4.
__host__ __device__ constexpr int dft_row(int W) { return dft_depth(W) + 4; }
// Floats between segments: a segment holds hop + 1 samples (its last one
// opens the next segment too), rounded up to an odd multiple of 4.
__host__ __device__ constexpr int dft_seg(int W) {
  return W / 2 + 1 + (3 - W / 2 % 8 + 8) % 8;
}
// Floats of a block's basis tile: a cos and a -sin plane of DFT_BINS rows.
__host__ __device__ constexpr int dft_basis_floats(int W) {
  return 2 * DFT_BINS * dft_row(W);
}
// Floats of the fold's coefficients: w[n] for n <= W/2 and w[W - n] for
// 0 < n < W/2, zero elsewhere, D of each.
__host__ __device__ constexpr int dft_coef_floats(int W) {
  return 2 * dft_depth(W);
}
// Floats of the FM + 1 segments that FM frames read.
__host__ __device__ constexpr int dft_span_floats(int W, int FM) {
  return (FM + 1) * dft_seg(W);
}
// Offset of the window in the table: it follows the basis (K bins x 2 x D).
__host__ __device__ constexpr long long dft_window_offset(int W) {
  return static_cast<long long>(W / 2 + 1) * 2 * dft_depth(W);
}

// cvt.rna.tf32.f32 for a finite x: round to 10 mantissa bits, ties away
// from zero, as the bits of an f32 with the low 13 clear.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}
// d += a b for one 16 x 8 x 8 TF32 tile, f32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Starts copying the basis rows of bins b0 .. b0 + DFT_BINS - 1 (zeros for
// bins >= K) into the tile's planes, by P threads (thread t): bin b0 + n's
// cos row to basis_s[n R ..], its -sin row to basis_s[(DFT_BINS + n) R ..].
// cp.async of 16 bytes; the caller commits and waits.
template <int P>
__device__ __forceinline__ void dft_load_basis(const float* table, int W,
                                               int b0, float* basis_s,
                                               int t) {
  const int K = W / 2 + 1, D = dft_depth(W), R = dft_row(W);
  const int q = D / 4;                       // 16-byte pieces of a row
  for (int i = t; i < 2 * DFT_BINS * q; i += P) {
    const int row = i / q, j = 4 * (i - row * q);
    const int n = row >> 1, c = row & 1;     // bin n of the tile, cos / sin
    const bool in = b0 + n < K;
    const float* src = table + (2LL * (in ? b0 + n : 0) + c) * D + j;
    const unsigned dst = static_cast<unsigned>(
        __cvta_generic_to_shared(basis_s + (c * DFT_BINS + n) * R + j));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
                 "l"(src), "r"(in ? 16 : 0)
                 : "memory");
  }
}

// The fold's coefficients in shared memory, by P threads (thread t), from
// the window in the table: coef[n] = w[n] for n <= W/2, coef[D + n] =
// w[W - n] for 0 < n < W/2, zero elsewhere.
template <int P>
__device__ __forceinline__ void dft_load_coef(const float* table, int W,
                                              float* coef, int t) {
  const int hop = W / 2, D = dft_depth(W);
  const float* win = table + dft_window_offset(W);
  for (int n = t; n < D; n += P) {
    coef[n] = n <= hop ? win[n] : 0.f;
    coef[D + n] = n > 0 && n < hop ? win[W - n] : 0.f;
  }
}

// Starts copying n_seg segments of hop + 1 row samples, segment j from
// s0 + j hop on, to seg (its sample i at seg[j * dft_seg(W) + i]), zeros
// outside [0, S), by P threads (thread t): one warp a segment, cp.async of
// 4 bytes (the hop may be odd: 191 floats at W = 382), without a test a
// sample where the whole run lies in the row. One commit group.
template <int P>
__device__ __forceinline__ void dft_copy_segments(const float* row,
                                                  long long S, long long s0,
                                                  int n_seg, int W,
                                                  float* seg, int t) {
  const int hop = W / 2, SP = dft_seg(W);
  const bool inside = s0 >= 0 && s0 + static_cast<long long>(n_seg) * hop < S;
  for (int j = t >> 5; j < n_seg; j += P / 32) {
    const long long q0 = s0 + static_cast<long long>(j) * hop;
    const unsigned d0 = static_cast<unsigned>(
        __cvta_generic_to_shared(seg + j * SP));
    if (inside) {
#pragma unroll 4
      for (int i = t & 31; i <= hop; i += 32)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                         d0 + 4 * i), "l"(row + q0 + i)
                     : "memory");
      continue;
    }
    for (int i = t & 31; i <= hop; i += 32) {
      const long long q = q0 + i;
      const bool in_row = q >= 0 && q < S;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                       d0 + 4 * i), "l"(in_row ? row + q : row),
                   "r"(in_row ? 4 : 0)
                   : "memory");
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// A warp's frames (16 MT from m0; frame f is segments f and f + 1 of seg)
// x bins (8 NT from n0 of the basis planes cos_s and msin_s), over the
// depth D, folded with coef (dft_load_coef) as the A
// fragments are loaded: v[n] = x[n] is segment f's sample n (n <= hop),
// v[W - n] segment f + 1's sample hop - n, both affine in n; where a
// coefficient is 0 the sample read is a finite one of the buffer. The
// next step's values are loaded before this step's products, and the
// k-loop is unrolled UNROLL times. Calls
// store(frame, bin, re, im) for each (frame, bin) this lane holds: frames
// m0 + 16i + g and m0 + 16i + g + 8, bins n0 + 8j + 2t and n0 + 8j + 2t + 1
// (lane = 4g + t).
template <int MT, int NT, int UNROLL, typename Store>
__device__ __forceinline__ void dft_warp_tile(const float* seg,
                                              const float* coef,
                                              const float* cos_s,
                                              const float* msin_s, int W,
                                              int m0, int n0, int lane,
                                              Store store) {
  const int hop = W / 2, D = dft_depth(W), R = dft_row(W), SP = dft_seg(W);
  const int g = lane >> 2, t = lane & 3;
  // A (row = frame, col = n): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
  // a3 (g + 8, t + 4); B (row = n, col = bin): b0 (t, g), b1 (t + 4, g)
  const float* xf = seg + (m0 + g) * SP + t;             // v[n]: xf[n - t]
  const float* xr = seg + (m0 + g + 1) * SP + hop - t;   // v[W - n]: xr[t - n]
  const float* cb = cos_s + (n0 + g) * R + t;
  const float* sb = msin_s + (n0 + g) * R + t;
  struct Step {       // one k-step's values, loaded a step ahead
    float a1[2], a2[2], f[MT][4], r[MT][4];
    float c[NT][2], s[NT][2];
  };
  const auto load = [&](int k0, Step& q) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      q.a1[h] = coef[k0 + t + 4 * h];
      q.a2[h] = coef[D + k0 + t + 4 * h];
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = (16 * i + (r & 1) * 8) * SP, k = k0 + (r >> 1) * 4;
        q.f[i][r] = xf[row + k];
        q.r[i][r] = xr[row - k];
      }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        q.c[j][r] = cb[8 * j * R + k0 + 4 * r];
        q.s[j][r] = sb[8 * j * R + k0 + 4 * r];
      }
  };
  float re[MT][NT][4] = {}, im[MT][NT][4] = {};
  Step cur, next;
  load(0, cur);
#pragma unroll UNROLL
  for (int k0 = 0; k0 < D; k0 += 8) {
    load(min(k0 + 8, D - 8), next);
    uint32_t eh[MT][4], el[MT][4], oh[MT][4], ol[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int h = r >> 1;
        const float v1 = __fmul_rn(cur.a1[h], cur.f[i][r]);
        const float v2 = __fmul_rn(cur.a2[h], cur.r[i][r]);
        tf32_split(v1 + v2, eh[i][r], el[i][r]);
        tf32_split(v1 - v2, oh[i][r], ol[i][r]);
      }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t ch[2], cl[2], sh[2], sl[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        tf32_split(cur.c[j][r], ch[r], cl[r]);
        tf32_split(cur.s[j][r], sh[r], sl[r]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        mma_tf32(re[i][j], el[i], ch);
        mma_tf32(re[i][j], eh[i], cl);
        mma_tf32(re[i][j], eh[i], ch);
        mma_tf32(im[i][j], ol[i], sh);
        mma_tf32(im[i][j], oh[i], sl);
        mma_tf32(im[i][j], oh[i], sh);
      }
    }
    cur = next;
  }
  // C (row = frame, col = bin): c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
  // c3 (g + 8, 2t + 1)
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        store(m0 + 16 * i + g + (r >> 1) * 8, n0 + 8 * j + 2 * t + (r & 1),
              re[i][j][r], im[i][j][r]);
}
