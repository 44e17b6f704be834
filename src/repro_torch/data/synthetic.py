"""Synthetic SERF-like labelled audio (the port's own copy of
`repro/data/synthetic.py`; for a seed it must give bit-identical arrays).

SERF recordings are not redistributable, so benchmarks and detector
calibration use a seeded generator that reproduces the paper's noise
taxonomy: bird chirps (FM sweeps 2-8 kHz, transient), heavy rain (loud
broadband noise), cicada chorus (sustained narrowband noise 3.5-7 kHz, AM),
silence (low-level background), over stereo 44.1 kHz audio with ground-truth
labels at 5 s resolution (the paper's labelling resolution).
"""
from __future__ import annotations

import numpy as np

LABELS = ("bird", "rain", "cicada", "silence")


def _chirp(rng, n, rate):
    """One FM bird chirp."""
    dur = int(rate * rng.uniform(0.05, 0.4))
    f0 = rng.uniform(2000, 6000)
    f1 = f0 * rng.uniform(0.7, 1.6)
    freq = np.linspace(f0, min(f1, 10_000), dur)
    phase = 2 * np.pi * np.cumsum(freq) / rate
    env = np.hanning(dur)
    return (np.sin(phase) * env).astype(np.float32)


def _bird_segment(rng, n, rate, density=3.0):
    """Sparse chirps over quiet background."""
    x = np.zeros(n, np.float32)
    n_calls = max(1, rng.poisson(density * n / rate))
    for _ in range(n_calls):
        c = _chirp(rng, n, rate)
        start = rng.randint(0, max(1, n - len(c)))
        amp = rng.uniform(0.15, 0.6)
        x[start:start + len(c)] += amp * c
    return x


def _bandnoise(rng, n, rate, lo, hi):
    """Band-limited noise via FFT masking (generator side only)."""
    w = rng.randn(n).astype(np.float32)
    spec = np.fft.rfft(w)
    f = np.fft.rfftfreq(n, 1.0 / rate)
    mask = ((f >= lo) & (f <= hi)).astype(np.float32)
    return np.fft.irfft(spec * mask, n).astype(np.float32)


def _rain_segment(rng, n, rate):
    """Heavy rain: loud broadband noise + audible drop transients."""
    x = 0.35 * _bandnoise(rng, n, rate, 300, 16_000)
    n_drops = rng.poisson(30 * n / rate)
    for _ in range(n_drops):
        d = int(rate * 0.004)
        start = rng.randint(0, n - d)
        x[start:start + d] += rng.uniform(0.2, 0.6) * np.hanning(d).astype(
            np.float32)
    return x.astype(np.float32)


def _cicada_segment(rng, n, rate):
    """Cicada chorus: strong sustained narrowband noise with slow AM."""
    f0 = rng.uniform(3800, 6500)
    x = 0.5 * _bandnoise(rng, n, rate, f0 - 250, f0 + 250)
    am = 1.0 + 0.3 * np.sin(2 * np.pi * rng.uniform(8, 15)
                            * np.arange(n) / rate)
    x = x * am.astype(np.float32)
    # faint bird activity can coexist under the chorus
    if rng.rand() < 0.3:
        x += 0.3 * _bird_segment(rng, n, rate, density=1.0)
    return x.astype(np.float32)


def _silence_segment(rng, n, rate):
    return np.zeros(n, np.float32)


_GEN = {"bird": _bird_segment, "rain": _rain_segment,
        "cicada": _cicada_segment, "silence": _silence_segment}


def generate_labelled(seed, n_segments, segment_s=5.0, rate=44_100,
                      stereo=True, label_probs=(0.45, 0.2, 0.15, 0.2),
                      background_level=0.012, persistence=0.85):
    """Returns (audio (n, [2,] S) f32, labels (n,) int in LABELS order).

    Labels follow a sticky Markov chain (persistence = P[keep previous
    label]). Every segment gets low-level stationary background noise (the
    component MMSE-STSA removes)."""
    rng = np.random.RandomState(seed)
    n = int(segment_s * rate)
    audio, labels = [], []
    li = rng.choice(len(LABELS), p=label_probs)
    for _ in range(n_segments):
        if rng.rand() > persistence:
            li = rng.choice(len(LABELS), p=label_probs)
        x = _GEN[LABELS[li]](rng, n, rate)
        x = x + background_level * rng.randn(n).astype(np.float32)
        if stereo:
            x2 = x + 0.003 * rng.randn(n).astype(np.float32)
            x = np.stack([x, x2])
        audio.append(x)
        labels.append(li)
    return np.stack(audio), np.asarray(labels, np.int32)
