"""The SERF bird-acoustic preprocessing config (the port's own copy of
`repro/configs/serf_audio.py`; the two must stay field-for-field equal,
which `from_reference_config` and the tests check).

All constants trace to the paper:
  - downsample to 22.05 kHz (Nyquist 11.025 kHz covers bird sound)
  - mono mix
  - 1 kHz high-pass (birds rarely vocalise below 1 kHz)
  - STFT: 256-sample windows, Hamming, 50% overlap
  - rain / cicada detection via rules over acoustic indices (C4.5-derived)
  - re-split to 5 s chunks; silence detection via SNR threshold
  - MMSE-STSA last (dominant cost; skipped for removed audio)
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class AudioPipelineConfig:
    name: str = "serf_audio"
    source_rate_hz: int = 44_100
    target_rate_hz: int = 22_050
    # chunking: 60 s long chunks for the band-pass FIR, 15 s for rain /
    # cicada detection, 5 s for silence detection and MMSE
    long_split_s: float = 60.0
    detect_split_s: float = 15.0
    final_split_s: float = 5.0
    # high-pass filter
    hpf_cutoff_hz: float = 1_000.0
    hpf_taps: int = 129
    # STFT
    stft_window: int = 256
    stft_hop: int = 128               # 50% overlap
    # MMSE-STSA (Ephraim-Malah)
    mmse_alpha: float = 0.98          # decision-directed smoothing
    mmse_gain_floor: float = 0.1      # min gain (noise floor retention)
    noise_est_frames: int = 16        # initial frames used for noise PSD
    # silence detection (estimated-SNR threshold, the paper's lower one)
    silence_snr_threshold: float = 0.45
    silence_snr_threshold_hi: float = 0.60
    # spectral-flux energy detection ('detect_flux' stage)
    flux_threshold: float = 1.5
    # rain detection rule constants
    rain_psd_min: float = 1.5
    rain_snr_max: float = 0.6
    rain_flatness_min: float = 0.25
    rain_low_band_hz: tuple = (1_000.0, 6_000.0)
    # cicada detection: strong sustained narrowband chorus energy
    cicada_band_hz: tuple = (2_500.0, 8_000.0)
    cicada_band_ratio_min: float = 0.9
    cicada_peakiness_min: float = 1000.0
    cicada_persistence_min: float = 0.95
    cicada_stop_width_hz: float = 800.0
    # distribution parameters (paper Table 7)
    slave_queue_size: int = 5
    send_interval_s: float = 2.0
    # the pipeline stage order as data (names from core.graph.STAGES);
    # "removal_point" marks where the two-phase plan cuts
    stages: tuple = (
        "to_mono",
        "compress",
        "split_detect",
        "stft",
        "detect_rain",
        "cicada_bandstop",
        "istft",
        "split_final",
        "detect_silence",
        "removal_point",
        "mmse",
    )

    @property
    def long_split_samples(self) -> int:
        return int(self.long_split_s * self.source_rate_hz)

    @property
    def detect_split_samples(self) -> int:
        return int(self.detect_split_s * self.target_rate_hz)

    @property
    def final_split_samples(self) -> int:
        return int(self.final_split_s * self.target_rate_hz)

    @property
    def n_bins(self) -> int:
        return self.stft_window // 2 + 1


SERF_AUDIO = AudioPipelineConfig()


def from_reference_config(d: dict) -> AudioPipelineConfig:
    """The port's config from the reference's `AudioPipelineConfig` given
    as a plain dict (`dataclasses.asdict`). Every field must be known and
    every field must be given; lists (as a JSON round trip leaves them)
    become tuples."""
    names = {f.name for f in dataclasses.fields(AudioPipelineConfig)}
    unknown = sorted(set(d) - names)
    missing = sorted(names - set(d))
    if unknown or missing:
        raise ValueError(f"config fields do not match: unknown {unknown}, "
                         f"missing {missing}")
    return AudioPipelineConfig(**{
        k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})
