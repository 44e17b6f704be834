"""Synthetic SERF-like labelled audio, made on the device in a few large
calls: the benchmark's own generator.

It draws from the distributions of the port's `data/synthetic.py::
generate_labelled` (the paper's noise taxonomy; SERF recordings are not
redistributable), as a vectorised program: the per-segment choices (labels,
counts, frequencies, offsets) on the host from a numpy generator, the
samples on the device from a `torch.Generator`, in batches over all the
segments of a label at once. The arrays are not the port's bit for bit;
their statistics are (a CPU test holds the two side by side).

  bird     sparse FM chirps (2-8 kHz, 0.05-0.4 s, Hann envelope) over quiet
           background, Poisson(3 a second) calls, at least one
  rain     0.35 x noise band-limited to 300 Hz-16 kHz, plus Poisson(30 a
           second) 4 ms Hann drops
  cicada   0.5 x noise in f0 +- 250 Hz (f0 3.8-6.5 kHz) under 30% AM at
           8-15 Hz; a third of the time faint birds (density 1) under it
  silence  nothing
  every segment: + 0.012 x white background; stereo: the second channel
  adds 0.003 x white noise. Labels follow a sticky chain (`persistence`
  is the probability of keeping the label), at 5 s resolution.
"""
from __future__ import annotations

import math

import numpy as np
import torch

LABELS = ("bird", "rain", "cicada", "silence")
CHIRP_BLOCK = 512         # chirps made in one call
BACKGROUND = 0.012
STEREO_NOISE = 0.003


def label_chain(rng, n, probs, persistence):
    """(n,) label indices of the sticky chain."""
    out = np.empty(n, np.int64)
    li = rng.choice(len(LABELS), p=probs)
    for i in range(n):
        if rng.random() > persistence:
            li = rng.choice(len(LABELS), p=probs)
        out[i] = li
    return out


def _bandnoise(gen, rows, n, rate, lo, hi, device):
    """(rows, n) white noise kept to [lo, hi] Hz by an FFT mask (lo, hi:
    (rows,) arrays or scalars)."""
    w = torch.randn((rows, n), generator=gen, device=device)
    f = torch.fft.rfftfreq(n, 1.0 / rate, device=device, dtype=torch.float64)
    lo = torch.as_tensor(lo, dtype=torch.float64, device=device).reshape(-1, 1)
    hi = torch.as_tensor(hi, dtype=torch.float64, device=device).reshape(-1, 1)
    mask = ((f >= lo) & (f <= hi)).to(torch.complex64)
    return torch.fft.irfft(torch.fft.rfft(w) * mask, n)


def _hann(length, t):
    """np.hanning(length) at integer positions t (float64 tensors)."""
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * t / (length - 1))


def _add_chirps(rng, gen, out, rows, density, gain, rate, device):
    """Add FM chirps to rows `rows` of `out` (n samples each): a
    Poisson(density x seconds) count a row, at least one."""
    n = out.shape[1]
    counts = np.maximum(1, rng.poisson(density * n / rate, size=len(rows)))
    m = int(counts.sum())
    row = np.repeat(np.asarray(rows), counts)
    dur = (rate * rng.uniform(0.05, 0.4, m)).astype(np.int64)
    f0 = rng.uniform(2000, 6000, m)
    f1 = np.minimum(f0 * rng.uniform(0.7, 1.6, m), 10_000)
    amp = rng.uniform(0.15, 0.6, m) * gain
    start = rng.integers(0, np.maximum(1, n - dur))
    for i in range(0, m, CHIRP_BLOCK):
        sl = slice(i, i + CHIRP_BLOCK)
        _chirp_block(out, row[sl], dur[sl], f0[sl], f1[sl], amp[sl],
                     start[sl], rate, device)


def _chirp_block(out, row, dur, f0, f1, amp, start, rate, device):
    n = out.shape[1]
    dmax = int(dur.max())
    t = torch.arange(dmax, dtype=torch.float64, device=device)[None, :]
    d = torch.as_tensor(dur, dtype=torch.float64, device=device)[:, None]
    a = torch.as_tensor(f0, dtype=torch.float64, device=device)[:, None]
    b = torch.as_tensor(f1, dtype=torch.float64, device=device)[:, None]
    # phase = 2 pi / rate x the running sum of a linear sweep a -> b
    run = a * (t + 1) + (b - a) / (d - 1) * t * (t + 1) / 2
    vals = torch.sin(2 * math.pi * run / rate) * _hann(d, t)
    vals = vals * torch.as_tensor(amp, device=device)[:, None]
    valid = t < d
    pos = (torch.as_tensor(row * n + start, device=device)[:, None]
           + t.long())
    out.view(-1).index_add_(0, pos[valid], vals[valid].float())


def segments(seed, n_seg, label_probs, persistence, segment_s=5.0,
             rate=44_100, device="cpu"):
    """(n_seg, 2, segment_s x rate) f32 stereo segments on `device`, and
    their labels."""
    rng = np.random.default_rng([int(seed) % 2**63, 7])
    gen = torch.Generator(device).manual_seed(
        int(rng.integers(0, 2**62)))
    n = int(segment_s * rate)
    labels = label_chain(rng, n_seg, np.asarray(label_probs, float),
                         persistence)
    x = torch.zeros((n_seg, n), dtype=torch.float32, device=device)
    idx = {k: np.flatnonzero(labels == i) for i, k in enumerate(LABELS)}
    if len(idx["bird"]):
        _add_chirps(rng, gen, x, idx["bird"], 3.0, 1.0, rate, device)
    r = idx["rain"]
    if len(r):
        x[r] = 0.35 * _bandnoise(gen, len(r), n, rate, 300, 16_000, device)
        d = int(rate * 0.004)
        drops = torch.zeros((len(r), n), device=device)
        counts = rng.poisson(30 * n / rate, size=len(r))
        rows = np.repeat(np.arange(len(r)), counts)
        starts = rng.integers(0, n - d, size=len(rows))
        drops.view(-1).index_add_(
            0, torch.as_tensor(rows * n + starts, device=device),
            torch.as_tensor(rng.uniform(0.2, 0.6, len(rows)),
                            dtype=torch.float32, device=device))
        hann = torch.as_tensor(np.hanning(d), dtype=torch.float32,
                               device=device)
        x[r] += torch.nn.functional.conv1d(
            torch.nn.functional.pad(drops[:, None], (d - 1, 0)),
            hann.flip(0)[None, None])[:, 0]
    c = idx["cicada"]
    if len(c):
        f0 = rng.uniform(3800, 6500, len(c))
        fm = rng.uniform(8, 15, len(c))
        band = _bandnoise(gen, len(c), n, rate, f0 - 250, f0 + 250, device)
        tt = torch.arange(n, dtype=torch.float64, device=device)[None]
        am = 1.0 + 0.3 * torch.sin(2 * math.pi * torch.as_tensor(
            fm, device=device)[:, None] * tt / rate)
        x[c] = (0.5 * band * am).float()
        faint = c[rng.random(len(c)) < 0.3]
        if len(faint):
            _add_chirps(rng, gen, x, faint, 1.0, 0.3, rate, device)
    x += BACKGROUND * torch.randn((n_seg, n), generator=gen, device=device)
    x2 = x + STEREO_NOISE * torch.randn((n_seg, n), generator=gen,
                                        device=device)
    return torch.stack([x, x2], dim=1), labels


def long_chunks(seed, n_long, label_probs, persistence, segment_s=5.0,
                rate=44_100, long_s=60.0, device="cpu"):
    """(n_long, 2, long_s x rate) f32 host array: `n_long` stereo long
    chunks of consecutive labelled segments, in the layout of the port's
    `audio_batch_maker` (segments of a chunk end to end, per channel)."""
    per_long = int(round(long_s / segment_s))
    seg, _ = segments(seed, n_long * per_long, label_probs, persistence,
                      segment_s, rate, device)
    n = seg.shape[-1]
    out = seg.reshape(n_long, per_long, 2, n).transpose(1, 2).reshape(
        n_long, 2, per_long * n)
    return out.cpu().numpy()
