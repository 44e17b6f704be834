"""Host data pipeline: the synthetic long-chunk batch stream and the
leased-queue loaders that feed it (the port's own copy of the reference's
`data/loader.py`, which imports no JAX; the port imports nothing of the
reference package).

  * `AudioChunkLoader` yields (B, 2, S_long_src) long-chunk batches of the
    seeded synthetic SERF-like stream from a background thread; a work id
    completes as it is yielded.
  * `ShardedLoader` is one shard's pull handle on a shared leased
    `WorkQueue` (the paper's slave pull loop). Completion is left to the
    consumer (the execution plan), so a shard that dies after pulling
    leaves its lease to expire and the queue redelivers. Its `lease_items`
    is the paper's Table 7 `max_queue_size` knob: ids leased per
    round-trip.
  * `TokenLoader` yields {"tokens", "targets"} LM batches of a synthetic
    Zipf corpus (the training launcher), numpy arrays bitwise equal to the
    reference's for the same seed and work id.
"""
from __future__ import annotations

import queue as _q
import threading

import numpy as np

from repro_torch.data import synthetic
from repro_torch.data.queue import WorkQueue


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


class _PrefetchLoader:
    def __init__(self, make_item, n_items, prefetch=5, start_at=0):
        self.make_item = make_item
        if start_at:
            self.queue = WorkQueue.from_state(
                {"n_items": n_items, "done": list(range(start_at))})
        else:
            self.queue = WorkQueue(n_items)
        self._buf = _q.Queue(maxsize=prefetch)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._started = False

    def _run(self):
        while True:
            ids = self.queue.lease("loader", max_items=1)
            if not ids:
                self._buf.put(None)
                return
            wid = ids[0]
            item = self.make_item(wid)
            self._buf.put((wid, item))

    def __iter__(self):
        if not self._started:
            self._thread.start()
            self._started = True
        while True:
            got = self._buf.get()
            if got is None:
                return
            wid, item = got
            yield wid, item
            self.queue.complete([wid])

    def cursor(self):
        return self.queue.state()

    def __len__(self):
        """Items still to be yielded — lets stream consumers (ShardedPlan)
        size a work queue without materialising the stream."""
        done, n = self.queue.progress()
        return n - done


class AudioChunkLoader(_PrefetchLoader):
    """Batches of 60 s long chunks, built from 12 x 5 s labelled segments."""

    def __init__(self, seed=0, n_batches=100, batch_long_chunks=4,
                 prefetch=5, start_at=0, segment_s=5.0, rate=44_100):
        self.seed = seed
        self.rate = rate
        self.segment_s = segment_s
        self.batch_long = batch_long_chunks
        self.per_long = int(round(60.0 / segment_s))
        super().__init__(
            audio_batch_maker(seed, batch_long_chunks, segment_s, rate),
            n_batches, prefetch, start_at)


# ------------------------------------------------------------ sharded pool

class ShardedLoader:
    """One shard's pull handle on a shared leased WorkQueue.

    Unlike `_PrefetchLoader` (which completes a work id the moment it is
    yielded), completion belongs to the consumer: the execution plan calls
    `queue.complete` only after the shard's results are materialised, so a
    crash between pull and completion leaves the lease to expire and the
    work to be redelivered to a surviving shard."""

    def __init__(self, make_item, queue, shard, lease_items=1):
        self.make_item = make_item
        self.queue = queue
        self.shard = int(shard)
        self.lease_items = max(1, int(lease_items))

    @property
    def worker(self) -> str:
        """Worker id under which this shard's leases are registered."""
        return f"shard{self.shard}"

    def pull(self):
        """Lease up to lease_items work ids and materialise their batches.
        Returns [(wid, item), ...]; empty when the queue has nothing
        leasable right now (drained, or all remaining work is leased)."""
        ids = self.queue.lease(self.worker, self.lease_items)
        return [(wid, self.make_item(wid)) for wid in ids]

    def complete(self, wid):
        """Retire one work id; returns True if it was newly retired."""
        return bool(self.queue.complete([wid]))

    def cursor(self):
        return self.queue.state()


def make_shard_pool(make_item, n_items, n_shards, queue=None, lease_items=1,
                    **queue_kw):
    """Build n_shards ShardedLoaders over ONE shared WorkQueue (pass
    `queue` to supply a pre-seeded / fake-clock queue; `queue_kw` feeds the
    WorkQueue constructor otherwise)."""
    if queue is None:
        queue = WorkQueue(n_items, **queue_kw)
    return [ShardedLoader(make_item, queue, j, lease_items)
            for j in range(n_shards)]


def audio_shard_pool(seed=0, n_batches=100, batch_long_chunks=4, n_shards=2,
                     segment_s=5.0, rate=44_100, **pool_kw):
    """Shard pool over the same synthetic stream AudioChunkLoader yields
    for this seed — the multi-host path of launch/preprocess."""
    return make_shard_pool(
        audio_batch_maker(seed, batch_long_chunks, segment_s, rate),
        n_batches, n_shards, **pool_kw)


class TokenLoader(_PrefetchLoader):
    """Synthetic-corpus LM batches: Zipf-distributed tokens with structure
    (repeated n-grams) so losses move during the example training runs."""

    def __init__(self, vocab_size, batch, seq_len, n_batches=10_000,
                 seed=0, prefetch=5, start_at=0):
        self.vocab_size = vocab_size

        def make(wid):
            rng = np.random.RandomState(seed * 99_991 + wid)
            a = rng.zipf(1.3, size=(batch, seq_len + 1)) % vocab_size
            # inject copyable structure: second half repeats the first
            half = seq_len // 2
            a[:, half:2 * half] = a[:, :half]
            a = a.astype(np.int32)
            return {"tokens": a[:, :-1], "targets": a[:, 1:]}

        super().__init__(make, n_batches, prefetch, start_at)
