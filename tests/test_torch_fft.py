"""The shared-memory real FFT of the STFT and fused-tail kernels
(`csrc/fft.cuh`), emulated on the CPU: the same host tables, pass order,
butterfly index maps and even/odd split, in f32, against `torch.fft.rfft`
of the windowed frames. A CUDA kernel has no CPU mode, so this is how an
index fault shows before the kernel meets the card; the kernel itself is
held against its plain version on the card (tests/test_torch_cuda.py)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.stft_dft import fft_tables as FT
from repro_torch.kernels.stft_dft import ref as SR


def _passes(N):
    """(radix, Ns) of every pass after the first, as `fft_frames` runs
    them."""
    out, Ns = [], 4
    while Ns < N:
        out.append((4 if Ns * 4 <= N else 2, Ns))
        Ns *= 4
    return out


def emulate_rfft(frames, window):
    """frames: (F, window) f32 -> (F, window/2 + 1) complex, computed as the
    kernel computes it."""
    N = window // 2
    tab = torch.from_numpy(FT.tables(window))
    tw = torch.complex(tab[0:2 * window:2], tab[1:2 * window:2])
    win = tab[2 * window:]
    xw = frames * win
    z = torch.complex(xw[:, 0::2], xw[:, 1::2])           # (F, N)

    def dft4(v0, v1, v2, v3):
        a0, a1, a2, d = v0 + v2, v0 - v2, v1 + v3, v1 - v3
        a3 = torch.complex(d.imag, -d.real)
        return a0 + a2, a1 + a3, a0 - a2, a1 - a3

    # first pass: Ns = 1, butterfly j writes 4j + r
    Q = N // 4
    j = torch.arange(Q)
    ys = dft4(*(z[:, j + r * Q] for r in range(4)))
    buf = torch.empty_like(z)
    for r in range(4):
        buf[:, 4 * j + r] = ys[r]
    for R, Ns in _passes(N):
        Q = N // R
        j = torch.arange(Q)
        m = j % Ns
        step = m * (2 * N // (R * Ns))
        v = [buf[:, j + r * Q] * (tw[r * step] if r else 1)
             for r in range(R)]
        ys = dft4(*v) if R == 4 else (v[0] + v[1], v[0] - v[1])
        out = torch.empty_like(buf)
        for r in range(R):
            out[:, (j - m) * R + m + r * Ns] = ys[r]
        buf = out
    k = torch.arange(N + 1)
    a, b = buf[:, k % N], buf[:, (N - k) % N]
    e = torch.complex(0.5 * (a.real + b.real), 0.5 * (a.imag - b.imag))
    o = torch.complex(0.5 * (a.imag + b.imag), -0.5 * (a.real - b.real))
    return e + tw[k] * o


@pytest.mark.parametrize("window", [128, 256, 512])
def test_emulated_kernel_fft_matches_rfft(window):
    rng = np.random.RandomState(window)
    x = torch.from_numpy((rng.randn(3, 40 * window) * 0.3)
                         .astype(np.float32))
    frames = SR.frame(x, window, window // 2).reshape(-1, window)
    got = emulate_rfft(frames, window)
    want = torch.fft.rfft(frames.double() * torch.from_numpy(
        SR.hamming(window)), dim=-1)
    torch.testing.assert_close(torch.view_as_real(got).double(),
                               torch.view_as_real(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("window", [128, 256, 512])
def test_tables_layout(window):
    tab = FT.tables(window)
    assert tab.dtype == np.float32 and tab.shape == (3 * window,)
    t = np.arange(window)
    np.testing.assert_allclose(tab[0:2 * window:2],
                               np.cos(2 * np.pi * t / window), atol=1e-7)
    np.testing.assert_allclose(tab[1:2 * window:2],
                               -np.sin(2 * np.pi * t / window), atol=1e-7)
    np.testing.assert_array_equal(tab[2 * window:],
                                  SR.hamming(window).astype(np.float32))


@pytest.mark.parametrize("window,hop", [(256, 64), (256, 256), (200, 100),
                                        (1024, 512), (64, 32)])
def test_geometry_the_kernels_refuse(window, hop):
    with pytest.raises(ValueError):
        FT.check_geometry(window, hop)
