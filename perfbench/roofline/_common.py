"""Operation counts the kernels' counters share (the least work of each
function, as `chip_smoke.py` counts it for PERF.md's kernel table)."""
from __future__ import annotations

import math

MMSE_OPS_PER_STEP = 64      # f32 operations of one MMSE-STSA step (exp,
#                             sqrt and divide counted as one each)


def rfft_flops(n):
    """Operations of one n-point real FFT (the usual 2.5 n log2 n)."""
    return 2.5 * n * math.log2(n)


def fir_flops(n_in, n_out, T):
    """Least operations of a T-tap FIR over n_in samples giving n_out
    outputs: the direct form (2T an output) or overlap-save with real FFTs
    of the power of two N >= 8T, whichever is less."""
    N = 1 << math.ceil(math.log2(8 * T))
    blocks = math.ceil(n_in / (N - T + 1))
    return min(2 * T * n_out,
               blocks * (2 * rfft_flops(N) + 6 * (N // 2 + 1)))


def stft_flops(frames, W):
    """Least operations of a windowed real STFT: the window product and
    one real FFT a frame."""
    return frames * (W + rfft_flops(W))


def frames(S, W, H):
    return (S - W) // H + 1
