"""The shared-memory real FFT of the STFT and fused-tail kernels
(`csrc/fft.cuh`), emulated on the CPU: the same host tables, pass order,
butterfly index maps and even/odd split, in f32, against `torch.fft.rfft`
of the windowed frames; and the tile of the direct DFT that the other
windows take (`csrc/dft.cuh`): the samples in segments, the fold, the
`dft_basis` layout, TF32 rounding (`cvt.rna`), three products per step
and f32 sums per step of 8, through the `mma.sync` m16n8k8 fragment
maps. A CUDA kernel has no CPU mode, so this is how an index fault shows
before the kernel meets the card; the kernels themselves are held against their plain versions on the
card (tests/test_torch_cuda.py)."""
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


# The fragments of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 (PTX
# ISA), lane = 4 g + t: register r of a lane holds A[A_ROW, A_COL] (16 x 8,
# frames x depth), B[B_ROW, B_COL] (8 x 8, depth x bins) and C[C_ROW,
# C_COL] (16 x 8, frames x bins). dft.cuh indexes its loads and stores so.
_G, _T = np.arange(32) // 4, np.arange(32) % 4
A_ROW = np.stack([_G, _G + 8, _G, _G + 8], 1)
A_COL = np.stack([_T, _T, _T + 4, _T + 4], 1)
B_ROW = np.stack([_T, _T + 4], 1)
B_COL = np.stack([_G, _G], 1)
C_ROW = np.stack([_G, _G, _G + 8, _G + 8], 1)
C_COL = np.stack([2 * _T, 2 * _T + 1, 2 * _T, 2 * _T + 1], 1)


def rna(x):
    """cvt.rna.tf32.f32: f32 rounded to 10 mantissa bits, ties away from
    zero, as an f32 with the low 13 bits clear."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split(x):
    """hi + lo, both TF32: hi = rna(x), lo = rna(x - hi)."""
    hi = rna(x)
    return hi, rna((x - hi).astype(np.float32))


def mma(c, a, b):
    """One m16n8k8 product per tile from the lanes' registers: c (..., 32,
    4), a (..., 32, 4), b (..., 32, 2) -> d (..., 32, 4). The 8 products of
    an output are exact and summed exactly (float64), then added to c with
    one f32 rounding: f32 accumulation per step of 8."""
    A = np.zeros(a.shape[:-2] + (16, 8))
    A[..., A_ROW, A_COL] = a
    B = np.zeros(b.shape[:-2] + (8, 8))
    B[..., B_ROW, B_COL] = b
    return ((A @ B)[..., C_ROW, C_COL] + c).astype(np.float32)


def emulate_tile(x, window, n_frames, products=3, b0=0, n_bins=None):
    """Frames 0 .. n_frames-1 of the row x (numpy f32, hop window/2) at bins
    b0 .. b0 + n_bins - 1 (default: all window/2 + 1) -> (n_frames, n_bins)
    complex128, computed as dft.cuh computes a tile: the samples staged as
    segments of hop + 1 samples, `dft_seg` floats apart (zero pads), the
    basis rows of the tile's bins staged (zeros past the last bin), then
    per step of 8 along the depth each lane's A fragments folded from two
    samples of its frame (e = v1 + v2, o = v1 - v2, v1 = coef[n] x[n] from
    segment f at n, v2 = coef[D + n] x[W - n] from segment f + 1 at
    hop - n, f32), and the e and o fragments against the cos
    and -sin fragments with three products (lo hi, hi lo, hi hi) or, with
    products=1, one (rna(a) rna(b)); a lane holds Re and Im of the same
    (frame, bin)."""
    W, hop, K = window, window // 2, window // 2 + 1
    D, SP = FT.dft_depth(W), hop + 1 + (3 - hop % 8) % 8
    tab = FT.kernel_tables(W)
    basis = tab[:K * 2 * D].reshape(K, 2, D)
    win = tab[K * 2 * D:]
    n_bins = K if n_bins is None else n_bins
    n_m, n_n = (n_frames + 15) // 16, (n_bins + 7) // 8
    seg = np.zeros((16 * n_m + 1) * SP, np.float32)
    for j in range(n_frames + 1):
        part = x[j * hop:(j + 1) * hop + 1]
        seg[j * SP:j * SP + part.size] = part
    n = np.arange(D)
    coef1 = np.where(n <= hop, win[np.minimum(n, W - 1)], 0).astype(
        np.float32)
    inner = (n > 0) & (n < hop)
    coef2 = np.where(inner, win[np.where(inner, W - n, 0)], 0).astype(
        np.float32)
    b = np.zeros((8 * n_n, 2, D), np.float32)
    staged = basis[b0:b0 + n_bins]
    b[:len(staged)] = staged
    mt, nt = np.arange(n_m)[:, None, None], np.arange(n_n)[:, None, None]
    acc = np.zeros((2, n_m, n_n, 32, 4), np.float32)
    for ks in range(D // 8):
        frame, col = 16 * mt + A_ROW, 8 * ks + A_COL
        v1 = (coef1[col] * seg[frame * SP + col]).astype(np.float32)
        v2 = (coef2[col] * seg[(frame + 1) * SP + hop - col]).astype(
            np.float32)
        for part, a in ((0, v1 + v2), (1, v1 - v2)):
            a = a.astype(np.float32)[:, None]
            bb = b[8 * nt + B_COL, part, 8 * ks + B_ROW][None]
            if products == 1:
                acc[part] = mma(acc[part], rna(a), rna(bb))
                continue
            a_hi, a_lo = split(a)
            b_hi, b_lo = split(bb)
            acc[part] = mma(acc[part], a_lo, b_hi)
            acc[part] = mma(acc[part], a_hi, b_lo)
            acc[part] = mma(acc[part], a_hi, b_hi)
    out = np.zeros((16 * n_m, 8 * n_n), np.complex128)
    mt, nt = np.arange(n_m)[:, None, None, None], np.arange(n_n)[None, :,
                                                                   None, None]
    out[16 * mt + C_ROW, 8 * nt + C_COL] = acc[0] + 1j * acc[1]
    return out[:n_frames, :n_bins]


def _tile_case(window, n_frames=40):
    rng = np.random.RandomState(window)
    x = (rng.randn((n_frames + 1) * window // 2) * 0.3).astype(np.float32)
    frames = SR.frame(torch.from_numpy(x).double(), window, window // 2)
    want = torch.fft.rfft(frames * torch.from_numpy(SR.hamming(window)),
                          dim=-1).numpy()
    return x, want


def test_fragment_maps_cover_each_element_once():
    for rows, cols, shape in ((A_ROW, A_COL, (16, 8)), (B_ROW, B_COL, (8, 8)),
                              (C_ROW, C_COL, (16, 8))):
        hit = np.zeros(shape, int)
        np.add.at(hit, (rows, cols), 1)
        assert (hit == 1).all()


@pytest.mark.parametrize("window", [4, 64, 200, 382, 510])
def test_emulated_tile_matches_rfft(window):
    x, want = _tile_case(window)
    got = emulate_tile(x, window, want.shape[0])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)


def test_one_tf32_product_misses_the_kernels_tolerance():
    """Why the tile pays for three products: with one, TF32's 10-bit
    mantissa leaves errors far beyond the kernels' rtol = atol = 2e-4."""
    x, want = _tile_case(382)
    got = emulate_tile(x, 382, want.shape[0], products=1)
    err = np.abs(got - want)
    assert err.max() > 1e-3
    assert not np.allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("window", [4, 6, 200, 382, 510])
def test_dft_basis_layout(window):
    K, D, h = window // 2 + 1, FT.dft_depth(window), window // 2
    assert D % 8 == 0 and h + 1 <= D < h + 9
    basis = FT.dft_basis(window)
    assert basis.dtype == np.float32 and basis.shape == (K, 2, D)
    ang = 2 * np.pi * np.outer(np.arange(K), np.arange(h + 1)) / window
    np.testing.assert_allclose(basis[:, 0, :h + 1], np.cos(ang), atol=1e-7)
    np.testing.assert_allclose(basis[:, 1, 1:h], -np.sin(ang[:, 1:h]),
                               atol=1e-7)
    assert not basis[:, 0, h + 1:].any() and not basis[:, 1, h:].any()
    assert not basis[:, 1, 0].any()
    tab = FT.kernel_tables(window)
    np.testing.assert_array_equal(tab[:K * 2 * D], basis.ravel())
    np.testing.assert_array_equal(tab[K * 2 * D:],
                                  SR.hamming(window).astype(np.float32))
    assert tab.size == K * 2 * D + window
