"""Host-side tables and geometry of the transforms that the STFT and
fused-tail kernels run: the shared-memory real FFT (`csrc/fft.cuh`) at a
window of 128, 256 or 512 samples, and the direct windowed DFT
(`csrc/dft.cuh`) at every other even window up to 510.

The tables are built in float64 by numpy and cast to f32 once, so the
kernels spend no `sincosf` (and its error) on them: `tables(W)` is
`[re tw[0], im tw[0], ..., re tw[W-1], im tw[W-1], w[0], ..., w[W-1]]`
with `tw[t] = exp(-2 pi i t / W)` and `w` the reference's Hamming window.

The DFT folds each windowed frame v = w x around its middle,
`e[n] = v[n] + v[W-n]` and `o[n] = v[n] - v[W-n]` (0 < n < W/2; e[0] =
v[0], e[W/2] = v[W/2], o[0] = o[W/2] = 0), so that

    Re X[k] = sum_n e[n] cos(2 pi n k / W),  Im X[k] = -sum_n o[n] sin(...)

over n = 0 .. W/2: two products of depth W/2 + 1 instead of one of depth
W. `dft_basis(W)` holds their right-hand sides, and `kernel_tables(W)` is
what the kernels read at each window.
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


def dft_depth(window):
    """The folded depth, n = 0 .. window/2, padded with zeros to a multiple
    of 8 (the k of one `mma.sync` m16n8k8 step)."""
    return (window // 2 + 1 + 7) // 8 * 8


def dft_basis(window):
    """f32 (K, 2, D), K = window/2 + 1 bins, D = `dft_depth(window)`: for
    bin k, [k, 0, n] = cos(2 pi n k / window) for n = 0 .. window/2 and
    [k, 1, n] = -sin(2 pi n k / window) for n = 1 .. window/2 - 1, zero
    elsewhere. A bin's two rows are contiguous, so a block's tile of bins
    is one contiguous run; the kernels split each value into two TF32
    parts themselves."""
    K, D = window // 2 + 1, dft_depth(window)
    n = np.arange(window // 2 + 1)
    ang = 2 * np.pi * np.outer(np.arange(K), n) / window
    out = np.zeros((K, 2, D), np.float64)
    out[:, 0, :n.size] = np.cos(ang)
    out[:, 1, 1:n.size - 1] = -np.sin(ang[:, 1:-1])
    return out.astype(np.float32)


def kernel_tables(window):
    """The f32 table the kernels take at `window`: `tables(window)` for the
    FFT, and for the DFT `dft_basis(window)` flattened, then the window."""
    if uses_fft(window):
        return tables(window)
    return np.concatenate([dft_basis(window).ravel(),
                           hamming(window).astype(np.float32)])


def tables(window):
    """The kernels' f32 table (3 * window,): interleaved twiddles, then the
    window."""
    tw = twiddles(window)
    out = np.empty(3 * window, np.float64)
    out[0:2 * window:2] = tw.real
    out[1:2 * window:2] = tw.imag
    out[2 * window:] = hamming(window)
    return out.astype(np.float32)
