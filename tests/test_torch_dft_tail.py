"""The schedule of the fused tail's direct-DFT kernel (`csrc/fused_tail.cu`,
fused_tail_dft_kernel), emulated on the CPU: the grid of (bin tile,
survivor row), pad rows that write exact zeros, the row walked in chunks
of 32 frames with the chunk's span (and, with the high-pass, its Tp - 1
sample halo, more than a hop at W = 200) staged from the row, the FIR in
tap order, the tile of dft.cuh (emulated in tests/test_torch_fft.py) for
the block's 32 bins only, and the consumer lanes' noise sums, with
prologue chunks when noise_est_frames exceeds a chunk, and recurrence
carried from chunk to chunk. Held against the port's plain
`fused_tail_spectrum_ref` at the fused tail's tolerance (2e-4); the kernel
itself meets its plain version on the card (tests/test_torch_cuda.py)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import SERF_AUDIO
from repro_torch.kernels.fir_hpf import ref as FR
from repro_torch.kernels.fused_tail import ref as TR
from repro_torch.kernels.mmse_stsa import ref as MR
from test_torch_fft import emulate_tile

FRAMES = 32         # TAIL_DFT_FRAMES: frames a chunk
BINS = 32           # DFT_BINS: bins a block
TAPS_STEP = 8       # FIR_TAPS: the taps are zero-padded to a multiple


def mmse_frame(a2, p, lam, alpha):
    """One frame of the recurrence, as `mmse_stsa_gain_ref` steps it: bins
    p (n,) with noise lam (n,) and carry a2 -> (gain, next a2)."""
    gamma = torch.clamp(p / lam, 1e-8, MR.GAMMA_MAX)
    xi = alpha * a2 + (1.0 - alpha) * torch.clamp_min(gamma - 1.0, 0.0)
    xi = torch.clamp_min(xi, MR.XI_MIN)
    g = MR.gain_fn(xi * gamma / (1.0 + xi), gamma)
    return g, (g * g) * gamma


def emulate_tail(wave, idx, cfg, hpf):
    """wave (B, S) f32 numpy, idx the padded survivor indices -> (R, Fv, K)
    complex128, computed block by block as the kernel's schedule computes
    it; every (row, frame, bin) written once."""
    B, S = wave.shape
    W, hop = cfg.stft_window, cfg.stft_hop
    K, Fv = W // 2 + 1, (S - W) // hop + 1
    taps = (FR.highpass_taps(cfg.hpf_cutoff_hz, cfg.target_rate_hz,
                             cfg.hpf_taps) if hpf else np.zeros(0, np.float32))
    T = taps.size
    Tp = -(-T // TAPS_STEP) * TAPS_STEP
    taps_p = np.zeros(Tp, np.float32)
    taps_p[:T] = taps
    halo = Tp - 1 if T else 0
    nf = min(cfg.noise_est_frames, Fv)
    n_pre = -(-nf // FRAMES) if nf > FRAMES else 0
    n_chunks = n_pre + -(-Fv // FRAMES)
    out = np.zeros((len(idx), Fv, K), np.complex128)
    written = np.zeros((len(idx), Fv, K), int)
    for r, src in enumerate(idx):
        for b0 in range(0, K, BINS):                     # the grid's x
            if not 0 <= src < B:                         # pad slot
                written[r, :, b0:b0 + BINS] += 1
                continue
            owns = np.arange(b0, b0 + BINS) < K
            total = np.zeros(BINS, np.float32)
            lam = a2 = None
            for c in range(n_chunks):
                f0 = (c if c < n_pre else c - n_pre) * FRAMES
                n_f = min(FRAMES, Fv - f0)
                length = (n_f - 1) * hop + W
                q = f0 * hop - halo + np.arange(length + halo)
                stage = np.where((q >= 0) & (q < S),
                                 wave[src, np.clip(q, 0, S - 1)], 0)
                frames = stage.astype(np.float32)
                if T:
                    acc = np.zeros(length, np.float32)
                    for k in range(Tp):
                        acc = (acc + taps_p[k] * frames[Tp - 1 - k:
                                                        Tp - 1 - k + length]
                               ).astype(np.float32)
                    frames = np.where(f0 * hop + np.arange(length) < S, acc,
                                      0).astype(np.float32)
                z = emulate_tile(frames, W, n_f, b0=b0, n_bins=BINS)
                p = (z.real.astype(np.float32) ** 2
                     + z.imag.astype(np.float32) ** 2).astype(np.float32)
                if c < n_pre or (n_pre == 0 and c == 0):     # noise frames
                    total += p[:min(n_f, nf - f0)].sum(0, dtype=np.float32)
                    if c == max(n_pre - 1, 0):
                        lam = torch.clamp_min(torch.from_numpy(total / nf),
                                              1e-10)
                        a2 = torch.ones(BINS)
                if c < n_pre:
                    continue
                for f in range(n_f):
                    g, a2 = mmse_frame(a2, torch.from_numpy(p[f]), lam,
                                       cfg.mmse_alpha)
                    g = torch.clamp_min(g, cfg.mmse_gain_floor).numpy()
                    k = np.arange(b0, b0 + BINS)[owns]
                    out[r, f0 + f, k] = (z[f] * g)[owns]
                    written[r, f0 + f, k] += 1
    assert (written == 1).all()
    return out


@pytest.mark.parametrize("window,n_frames", [(200, 150), (382, 120)])
@pytest.mark.parametrize("hpf", [False, True])
@pytest.mark.parametrize("noise_frames", [16, 100])
def test_emulated_bin_tiled_tail_matches_plain(window, n_frames, hpf,
                                               noise_frames):
    cfg = dataclasses.replace(SERF_AUDIO, stft_window=window,
                              stft_hop=window // 2,
                              noise_est_frames=noise_frames)
    S = (n_frames - 1) * (window // 2) + window + 37   # a part frame left
    rng = np.random.RandomState(window + noise_frames + hpf)
    wave = (rng.randn(4, S) * 0.3).astype(np.float32)
    idx = [2, 4, 0, -1]                                # two pad slots
    got = emulate_tail(wave, idx, cfg, hpf)
    want = TR.fused_tail_spectrum_ref(
        torch.from_numpy(wave), torch.tensor(idx, dtype=torch.int32), cfg,
        hpf).numpy()
    assert got.shape == want.shape == (4, n_frames, window // 2 + 1)
    assert not got[1].any() and not got[3].any()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
