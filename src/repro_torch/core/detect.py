"""Rule classifiers for rain / cicada / silence (fixed conjunctions of index
thresholds, constants fit on the synthetic labelled set; the decision order
and early-exit semantics follow the paper)."""
from __future__ import annotations

from repro_torch.core import indices as I


def detect_rain(idx, cfg):
    """Heavy rain: high broadband power, flat spectrum, flat envelope."""
    return ((idx["psd"] > cfg.rain_psd_min)
            & (idx["flatness"] > cfg.rain_flatness_min)
            & (idx["snr"] < cfg.rain_snr_max))


def detect_cicada(idx, cfg):
    """Cicada chorus: sustained narrowband peak in the cicada band."""
    return ((idx["cicada_peakiness"] > cfg.cicada_peakiness_min)
            & (idx["cicada_band"] > cfg.cicada_band_ratio_min)
            & (idx["cicada_persistence"] > cfg.cicada_persistence_min))


def detect_silence(idx, cfg, threshold=None):
    """Silence: envelope SNR below threshold (the paper's lower one)."""
    thr = cfg.silence_snr_threshold if threshold is None else threshold
    return idx["snr"] < thr


def detect_no_activity(idx, cfg, threshold=None):
    """Spectral-flux energy detection: peak rectified flux below threshold
    means no transient vocalisation."""
    thr = cfg.flux_threshold if threshold is None else threshold
    return idx["flux"] < thr


def classify_chunks(power, cfg):
    """Full detector pass over chunk power spectra: (B, F, K) -> dict of
    (B,) masks + the index vector."""
    idx = I.all_indices(power, cfg)
    rain = detect_rain(idx, cfg)
    cicada = detect_cicada(idx, cfg) & ~rain
    silence = detect_silence(idx, cfg) & ~rain
    return {"rain": rain, "cicada": cicada, "silence": silence,
            "indices": idx}
