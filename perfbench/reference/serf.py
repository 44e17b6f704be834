"""A plain SERF preprocessing pipeline: the benchmark's reference.

Written from the paper's description (arXiv:1802.00535) and the stage
semantics the configuration file states, in plain PyTorch with float32
arithmetic and TF32 off. It imports nothing of the program: no kernel, no
plain version of one, no table. It takes the source audio the benchmark
hands the program and works out every stage again:

  to_mono          mean of the channels
  compress         one band-pass FIR (windowed sinc, Hamming) from the
                   high-pass cutoff to the target Nyquist, at the source
                   rate, keeping every second output (44.1 -> 22.05 kHz)
  split_detect     60 s -> 15 s chunks
  stft             Hamming window, 50% overlap, the frames inside the chunk
  detect_rain      psd > rain_psd_min & flatness > rain_flatness_min &
                   snr < rain_snr_max
  cicada_bandstop  peakiness > cicada_peakiness_min & band ratio >
                   cicada_band_ratio_min & persistence >
                   cicada_persistence_min, gated on ~rain; the bins within
                   half the stop width of the band's peak bin are zeroed
  istft            irfft, window, overlap-add over the window's squares
  split_final      15 s -> 5 s chunks; the 15 s power regrouped
  detect_silence   snr of the regrouped power < silence_snr_threshold,
                   gated on ~rain; keep = ~rain & ~silence
  mmse             per kept chunk: STFT, noise PSD from the first frames,
                   the Ephraim-Malah MMSE-STSA gain with decision-directed
                   a-priori SNR, iSTFT

Beside each mask it says whether the mask is decided: a rule whose every
deciding index lies further than `MARGIN` (relative) from its threshold.
The program's float32 sums run in another order than these, so a chunk
that sits on a threshold may fall either way in a sound run.

`precision="tf32"` is the control: the operands of every product-sum (the
FIR, the forward and the inverse DFT) rounded to TF32's 10-bit mantissa
first, the step below float32 that a later change might take.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-10
MARGIN = 1e-3               # relative distance from a threshold: decided
XI_MIN = 10.0 ** (-25.0 / 10.0)     # a-priori SNR floor, -25 dB
GAMMA_MAX = 10.0 ** (40.0 / 10.0)   # a-posteriori SNR ceiling, 40 dB
GAIN_MAX = 10.0


# ------------------------------------------------------------ precision

def tf32(t):
    """Round a float32 tensor to TF32 (10 mantissa bits, to nearest)."""
    i = t.contiguous().view(torch.int32)
    i = (i + 0x1000) & ~0x1FFF
    return i.view(torch.float32)


class _Precision:
    def __init__(self, precision):
        if precision not in ("f32", "tf32"):
            raise ValueError(f"precision {precision!r}: f32 or tf32")
        self.round = tf32 if precision == "tf32" else (lambda t: t)


# ------------------------------------------------------------- filters

def _sinc_lowpass(cutoff_norm, n_taps):
    m = np.arange(n_taps) - (n_taps - 1) / 2.0
    h = 2.0 * cutoff_norm * np.sinc(2.0 * cutoff_norm * m)
    h *= np.hamming(n_taps)
    return h / h.sum()


def bandpass_taps(p):
    """The compress stage's taps: lowpass at the target Nyquist minus
    lowpass at the high-pass cutoff, designed in float64."""
    rate = p["source_rate_hz"]
    h = (_sinc_lowpass(p["target_rate_hz"] / 2.0 / rate, p["hpf_taps"])
         - _sinc_lowpass(p["hpf_cutoff_hz"] / rate, p["hpf_taps"]))
    return np.asarray(h, np.float32)


def fir(x, taps, stride, pr):
    """y[n] = sum_k h[k] x[n*stride - k], x zero before its start."""
    h = torch.as_tensor(taps, device=x.device)
    T = h.shape[0]
    xp = F.pad(pr.round(x)[:, None, :], (T - 1, 0))
    y = F.conv1d(xp, pr.round(h).flip(0)[None, None, :], stride=stride)
    return y[:, 0, :x.shape[1] // stride]


def hamming(n, device):
    w = 0.54 - 0.46 * np.cos(2.0 * np.pi * np.arange(n) / (n - 1))
    return torch.as_tensor(w, dtype=torch.float32, device=device)


def stft(x, window, hop, pr):
    """(B, S) -> complex (B, F, window // 2 + 1) over the frames inside."""
    frames = x.unfold(-1, window, hop) * hamming(window, x.device)
    return torch.fft.rfft(pr.round(frames), dim=-1)


def istft(spec, n_samples, window, hop, pr):
    """Windowed overlap-add of the irfft frames, divided by the summed
    squares of the window (floored at 1e-8); samples no frame covers are
    0."""
    B, nf, _ = spec.shape
    w = hamming(window, spec.device)
    frames = torch.fft.irfft(torch.complex(pr.round(spec.real),
                                           pr.round(spec.imag)),
                             n=window, dim=-1) * w
    L = (nf - 1) * hop + window
    out = torch.zeros((B, L), dtype=torch.float32, device=spec.device)
    norm = torch.zeros((L,), dtype=torch.float32, device=spec.device)
    for f in range(0, window // hop):
        sel = frames[:, f::window // hop]
        n = sel.shape[1]
        if n == 0:
            continue
        start = f * hop
        out[:, start:start + n * window] += sel.reshape(B, -1)
        norm[start:start + n * window] += (w * w).repeat(n)
    out = out / torch.clamp_min(norm, 1e-8)
    if L >= n_samples:
        return out[:, :n_samples]
    return F.pad(out, (0, n_samples - L))


# ------------------------------------------------------------- indices

def _band(p, lo, hi, device):
    f = np.arange(p["stft_window"] // 2 + 1) * p["target_rate_hz"] \
        / p["stft_window"]
    return torch.as_tensor((f >= lo) & (f <= hi), device=device)


def snr(power):
    env = power.sum(dim=-1)
    return torch.clamp(1.0 - env.mean(dim=1) / (env.amax(dim=1) + EPS),
                       0.0, 1.0)


def indices(power, p):
    """The rule indices of (B, F, K) power spectra."""
    band_r = _band(p, *p["rain_low_band_hz"], power.device)
    band_c = _band(p, *p["cicada_band_hz"], power.device)
    total = power.sum(dim=(1, 2)) + EPS
    psd_bins = power.mean(dim=1)                                # (B, K)
    lo = int(torch.nonzero(band_c)[0])
    n_c = int(band_c.sum())
    in_band = psd_bins[:, lo:lo + n_c]
    top2 = torch.topk(in_band, 2, dim=1).values
    K = psd_bins.shape[1]
    srt = torch.sort(psd_bins, dim=1).values
    med = (srt[:, (K - 1) // 2] + srt[:, K // 2]) * 0.5 + EPS
    pe = power + EPS
    frame_band = (power * band_c.to(power.dtype)).sum(dim=-1)
    return {
        "psd": torch.log1p(power.mean(dim=(1, 2))),
        "snr": snr(power),
        "flatness": (torch.exp(torch.log(pe).mean(dim=-1))
                     / pe.mean(dim=-1)).mean(dim=1),
        "rain_band": (power * band_r.to(power.dtype)).sum(dim=(1, 2))
        / total,
        "cicada_band": (power * band_c.to(power.dtype)).sum(dim=(1, 2))
        / total,
        "cicada_peakiness": top2[:, 0] / med,
        "cicada_peak_bin": torch.argmax(in_band, dim=1) + lo,
        "peak_gap": (top2[:, 0] - top2[:, 1]) / top2[:, 0].clamp_min(EPS),
        "cicada_persistence": ((frame_band / (power.sum(dim=-1) + EPS))
                               > 0.5).float().mean(dim=1),
    }


# ------------------------------------------------- three-valued masks

def _cmp(value, thr, greater):
    """(mask, decided) of value > thr (or < thr)."""
    mask = value > thr if greater else value < thr
    decided = (value - thr).abs() > MARGIN * max(abs(thr), EPS)
    return mask, decided


def _and(*terms):
    """Conjunction of (mask, decided) pairs: decided where every term is
    decided, or where a decided term is false."""
    mask = terms[0][0]
    for m, _ in terms[1:]:
        mask = mask & m
    all_dec = terms[0][1]
    any_false = terms[0][1] & ~terms[0][0]
    for m, d in terms[1:]:
        all_dec = all_dec & d
        any_false = any_false | (d & ~m)
    return mask, all_dec | any_false


def _not(term):
    return ~term[0], term[1]


# ------------------------------------------------------------ pipeline

def detect(audio, p, pr):
    """Detection of one batch (B, C, S) f32: masks and their decisions per
    5 s chunk, cicada per 15 s chunk, the pre-denoise 5 s waves."""
    x = audio.float().mean(dim=1)
    factor = p["source_rate_hz"] // p["target_rate_hz"]
    x = fir(x, bandpass_taps(p), factor, pr)
    n15 = int(round(p["long_split_s"] / p["detect_split_s"]))
    x = x.reshape(x.shape[0] * n15, -1)
    S15 = x.shape[1]
    W, H = p["stft_window"], p["stft_hop"]
    spec = stft(x, W, H, pr)
    power = spec.real ** 2 + spec.imag ** 2
    idx = indices(power, p)
    rain = _and(_cmp(idx["psd"], p["rain_psd_min"], True),
                _cmp(idx["flatness"], p["rain_flatness_min"], True),
                _cmp(idx["snr"], p["rain_snr_max"], False))
    cic = _and(_cmp(idx["cicada_peakiness"], p["cicada_peakiness_min"],
                    True),
               _cmp(idx["cicada_band"], p["cicada_band_ratio_min"], True),
               _cmp(idx["cicada_persistence"], p["cicada_persistence_min"],
                    True),
               _not(rain))
    width = int(round(p["cicada_stop_width_hz"]
                      / (p["target_rate_hz"] / W)))
    k = torch.arange(spec.shape[-1], device=spec.device)[None, :]
    stop = ((k - idx["cicada_peak_bin"][:, None]).abs() <= width // 2) \
        & cic[0][:, None]
    spec = torch.where(stop[:, None, :], torch.zeros((), dtype=spec.dtype,
                                                     device=spec.device),
                       spec)
    # a chunk whose band-stop may differ: its cicada decision is open, or
    # it is filtered and its peak bin is nearly tied with the next bin
    bandstop_open = ~cic[1] | (cic[0] & (idx["peak_gap"] <= MARGIN))
    x = istft(spec, S15, W, H, pr)
    n5 = int(round(p["detect_split_s"] / p["final_split_s"]))
    wave5 = x.reshape(x.shape[0] * n5, -1)
    # the 15 s power (before the band-stop) regrouped into 5 s groups
    nf = power.shape[1]
    sub = S15 // n5
    Fg = (sub - W) // H + 1
    starts = [min(int(round(i * sub / H)), nf - Fg) for i in range(n5)]
    groups = torch.stack([power[:, s:s + Fg] for s in starts], dim=1)
    groups = groups.reshape(-1, Fg, power.shape[-1])
    rain5 = (rain[0].repeat_interleave(n5), rain[1].repeat_interleave(n5))
    silence = _and(_cmp(snr(groups), p["silence_snr_threshold"], False),
                   _not(rain5))
    keep = _and(_not(rain5), _not(silence))
    return {"wave5": wave5,
            "keep": keep[0], "keep_decided": keep[1],
            "rain": rain5[0], "rain_decided": rain5[1],
            "silence": silence[0], "silence_decided": silence[1],
            "cicada15": cic[0], "cicada15_decided": cic[1],
            "bandstop_open5": bandstop_open.repeat_interleave(n5)}


def mmse_gain(power, noise, alpha, floor):
    """Ephraim-Malah MMSE-STSA gains of (R, F, K) power against (R, K)
    noise, frame by frame with the decision-directed a-priori SNR
    (A^2 / lambda of the previous frame starts at 1)."""
    lam = torch.clamp_min(noise, 1e-10)[:, None, :]
    gamma = torch.clamp(power / lam, 1e-8, GAMMA_MAX)
    prev = torch.ones_like(gamma[:, 0])
    out = torch.empty_like(gamma)
    c = math.sqrt(math.pi) / 2.0
    for t in range(gamma.shape[1]):
        g_t = gamma[:, t]
        xi = alpha * prev + (1.0 - alpha) * torch.clamp_min(g_t - 1.0, 0.0)
        xi = torch.clamp_min(xi, XI_MIN)
        v = torch.clamp_min(xi * g_t / (1.0 + xi), 1e-8)
        g = c * torch.sqrt(v) / g_t * (
            (1.0 + v) * torch.special.i0e(v / 2.0)
            + v * torch.special.i1e(v / 2.0))
        g = torch.clamp(g, 0.0, GAIN_MAX)
        prev = g * g * g_t
        out[:, t] = torch.clamp_min(g, floor)
    return out


def denoise(rows, p, pr):
    """MMSE-STSA of (R, S5) rows -> cleaned (R, S5)."""
    W, H = p["stft_window"], p["stft_hop"]
    spec = stft(rows, W, H, pr)
    power = spec.real ** 2 + spec.imag ** 2
    noise = power[:, :p["noise_est_frames"]].mean(dim=1)
    gain = mmse_gain(power, noise, p["mmse_alpha"], p["mmse_gain_floor"])
    return istft(spec * gain, rows.shape[1], W, H, pr)


def run(audio, p, precision="f32", device=None, block_rows=16):
    """The whole pipeline on one batch (B, C, S): a dict of host numpy
    arrays, per 5 s chunk `keep`, `rain`, `silence` and their `*_decided`,
    `bandstop_open5`, per 15 s chunk `cicada15` and its decision,
    `wave5` (n5, S5) the 5 s chunks before denoising, and `cleaned`
    (n_kept, S5) for the kept chunks in order. TF32 is off
    throughout, whatever the caller had set."""
    pr = _Precision(precision)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            x = torch.as_tensor(audio, dtype=torch.float32, device=device)
            det = detect(x, p, pr)
            kept = torch.nonzero(det["keep"]).flatten()
            wave5 = det.pop("wave5")
            cleaned = [denoise(wave5[kept[i:i + block_rows]], p, pr).cpu()
                       for i in range(0, len(kept), block_rows)]
            out = {k: v.cpu().numpy() for k, v in det.items()}
            out["wave5"] = wave5.cpu().numpy()
            out["cleaned"] = (torch.cat(cleaned).numpy() if cleaned else
                              np.zeros((0, wave5.shape[1]), np.float32))
            return out
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
