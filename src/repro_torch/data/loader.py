"""The synthetic long-chunk batch stream (the port's copy of
`repro/data/loader.audio_batch_maker`; the leased loaders come later)."""
from __future__ import annotations

from repro_torch.data import synthetic


def audio_batch_maker(seed, batch_long_chunks=4, segment_s=5.0, rate=44_100):
    """work id -> (chunks, labels): one (B, 2, S_long_src) f32 numpy batch
    of the seeded synthetic SERF-like stream, the same arrays the
    reference's maker gives for the same seed and work id."""
    per_long = int(round(60.0 / segment_s))

    def make(wid):
        audio, labels = synthetic.generate_labelled(
            seed * 100_003 + wid, batch_long_chunks * per_long,
            segment_s=segment_s, rate=rate)
        S5 = audio.shape[-1]
        chunks = audio.reshape(batch_long_chunks, per_long, 2, S5)
        chunks = chunks.transpose(0, 2, 1, 3).reshape(
            batch_long_chunks, 2, per_long * S5)
        return chunks, labels

    return make
