"""Host-side tables and geometry of the transforms that the STFT and
fused-tail kernels run: the shared-memory real FFT (`csrc/fft.cuh`) at a
window of 128, 256 or 512 samples, and the direct windowed DFT
(`csrc/dft.cuh`) at every other even window up to 510.

The tables are built in float64 by numpy and cast to f32 once, so the
kernels spend no `sincosf` (and its error) on them: `tables(W)` is
`[re tw[0], im tw[0], ..., re tw[W-1], im tw[W-1], w[0], ..., w[W-1]]`
with `tw[t] = exp(-2 pi i t / W)` and `w` the reference's Hamming window.
The DFT reads the same table: bin k of a frame is
`sum_n w[n] x[n] tw[(n k) mod W]`.
"""
from __future__ import annotations

import numpy as np

from repro_torch.kernels.stft_dft.ref import hamming

FFT_WINDOWS = (128, 256, 512)  # fft.cuh's template instances
MAX_WINDOW = 512


def uses_fft(window):
    """True where the kernels run the FFT of fft.cuh, False where they run
    the direct DFT of dft.cuh."""
    return window in FFT_WINDOWS


def check_geometry(window, hop):
    """Raise `ValueError` unless the kernels take this framing: an even
    window of 4 to 512 samples and hop = window / 2 (the reference's
    kernel asserts the same 50% overlap)."""
    if window % 2 or not 4 <= window <= MAX_WINDOW or hop * 2 != window:
        raise ValueError(f"the STFT kernels take an even window of 4 to "
                         f"{MAX_WINDOW} samples and hop = window/2, got "
                         f"window={window}, hop={hop}")


def twiddles(window):
    """exp(-2 pi i t / window), t = 0 .. window-1, complex128."""
    return np.exp(-2j * np.pi * np.arange(window) / window)


def tables(window):
    """The kernels' f32 table (3 * window,): interleaved twiddles, then the
    window."""
    tw = twiddles(window)
    out = np.empty(3 * window, np.float64)
    out[0:2 * window:2] = tw.real
    out[1:2 * window:2] = tw.imag
    out[2 * window:] = hamming(window)
    return out.astype(np.float32)
