"""The shared-memory real FFT of the STFT and fused-tail kernels
(`csrc/fft.cuh`), emulated on the CPU: the same host tables, pass order,
butterfly index maps and even/odd split, in f32, against `torch.fft.rfft`
of the windowed frames; and the direct DFT of the other windows
(`csrc/dft.cuh`): its frame staging and `(n k) mod W` table walk. A CUDA
kernel has no CPU mode, so this is how an index fault shows before the
kernel meets the card; the kernels themselves are held against their
plain versions on the card (tests/test_torch_cuda.py)."""
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


@pytest.mark.parametrize("window,hop", [(256, 64), (256, 256), (514, 257),
                                        (1024, 512), (255, 127)])
def test_geometry_the_kernels_refuse(window, hop):
    with pytest.raises(ValueError):
        FT.check_geometry(window, hop)


@pytest.mark.parametrize("window,hop", [(64, 32), (200, 100), (382, 191),
                                        (384, 192)])
def test_geometry_the_kernels_take(window, hop):
    FT.check_geometry(window, hop)
    assert not FT.uses_fft(window)


def emulate_dft(x, window, n_frames):
    """Frames 0 .. n_frames-1 of the row x (numpy f32) -> (n_frames,
    window/2 + 1) complex128, computed as `dft_stage_frames` and `dft_bin`
    compute them: windowed frames at a stride of window + 1 floats, then
    for each bin a walk of the twiddle index t = (n k) mod window, adding k
    and wrapping once, with f32 sums in the order of n."""
    W, hop, K = window, window // 2, window // 2 + 1
    tab = FT.tables(W)
    tw_re, tw_im, win = tab[0:2 * W:2], tab[1:2 * W:2], tab[2 * W:]
    xw = np.zeros(n_frames * (W + 1), np.float32)
    for i in range(n_frames * W):
        f, n = divmod(i, W)
        xw[f * (W + 1) + n] = win[n] * x[f * hop + n]
    out = np.empty((n_frames, K), np.complex128)
    n = np.arange(W)
    for k in range(K):
        t = np.empty(W, np.int64)
        acc = 0
        for j in range(W):                 # the kernel's walk, step by step
            t[j] = acc
            acc += k
            if acc >= W:
                acc -= W
        assert (t == n * k % W).all() and (t < W).all()
        for f in range(n_frames):
            v = xw[f * (W + 1):f * (W + 1) + W]
            re = np.float32(0)
            im = np.float32(0)
            for j in range(W):
                re = np.float32(re + v[j] * tw_re[t[j]])
                im = np.float32(im + v[j] * tw_im[t[j]])
            out[f, k] = complex(re, im)
    return out


@pytest.mark.parametrize("window", [64, 200, 382])
def test_emulated_dft_matches_rfft(window):
    rng = np.random.RandomState(window)
    n_frames = 3
    x = (rng.randn((n_frames + 1) * window // 2) * 0.3).astype(np.float32)
    got = emulate_dft(x, window, n_frames)
    frames = SR.frame(torch.from_numpy(x).double(), window, window // 2)
    want = torch.fft.rfft(frames * torch.from_numpy(SR.hamming(window)),
                          dim=-1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)
