"""Persistence: content-addressed preprocessing results and cross-restart
run journals, in the reference's on-disk layout.

`ChunkStore` persists per-batch results keyed by the content hash of (raw
chunk bytes, graph fingerprint, framework tag); `RunJournal` checkpoints
work-queue state through the `ckpt` layout so that a killed stream resumes
where it died. Both are consumed by `repro_torch.core.plans.CachedPlan`.
"""
from repro_torch.store.chunk_store import ChunkStore, StoreStats, content_key
from repro_torch.store.journal import RunJournal

__all__ = ["ChunkStore", "StoreStats", "content_key", "RunJournal"]
