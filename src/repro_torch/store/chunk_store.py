"""Content-addressed store for preprocessing results (the port's own copy
of the reference's `store/chunk_store.py`, in the same on-disk layout, so
that a store directory may be shared by both frameworks).

Long-running bioacoustic surveys re-preprocess the same recordings every
time a run restarts or a re-run touches overlapping data. The store turns
those re-runs into lookups: a result is keyed by the content hash of (raw
chunk bytes, graph fingerprint, framework tag), so a hit is valid if and
only if the identical bytes would flow through the identical computation.
The port's tag is `torch-<device type>` where the reference writes its
kernel backend mode: a shared store never serves a JAX entry to the port,
nor an entry computed on the CPU to a run on the card.

Layout (mirrors ckpt/checkpoint.py):

    <dir>/objects/<key>/
        manifest.json      {key, meta, leaves: {name: {file, shape,
                            dtype, crc32}}}
        <leaf>.npy         raw array bytes
    <dir>/objects/<key>.tmp-*   while writing (atomic rename on completion)

Writes are tmp-then-rename atomic: a killed writer leaves only a tmp
directory that never shadows the key, and concurrent writers race benignly
(first rename wins, the loser discards). Reads verify per-leaf crc32
against the manifest.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import tempfile
import zlib

import numpy as np

from repro_torch.obs import metrics as obs_metrics


def content_key(chunks, graph_fingerprint, framework_tag) -> str:
    """Content hash of one raw chunk batch under one computation identity.

    chunks: the raw (B, C, S) source batch, hashed as float32 bytes;
    graph_fingerprint: `PipelineGraph.fingerprint` (config + stage names +
    source geometry, all frozen and repr-stable); framework_tag: which
    framework and device computed the result (`torch-cuda`, `torch-cpu`;
    the reference puts its kernel backend mode here).
    """
    h = hashlib.sha256()
    h.update(repr(graph_fingerprint).encode())
    h.update(b"\x00" + str(framework_tag).encode() + b"\x00")
    arr = np.ascontiguousarray(np.asarray(chunks, np.float32))
    h.update(str(arr.shape).encode() + b"\x00")
    h.update(memoryview(arr).cast("B"))     # the bytes, without a copy
    return h.hexdigest()


_STORE_FIELDS = (
    "hits", "misses", "writes",
    "dup_writes",       # put() of a key that already existed
    "corrupt",          # entries evicted on crc mismatch
    "bytes_saved",      # source bytes whose preprocessing a hit skipped
    "bytes_written",    # bytes of result payload persisted
    "gc_evicted",       # entries evicted by gc() retention sweeps
    "gc_bytes_freed",   # payload bytes those sweeps reclaimed
)


class StoreStats:
    """Hit/miss/volume accounting for one ChunkStore handle.

    The plain integer attributes are the source of truth, and every
    increment also mirrors its delta into the process's metrics registry
    as `store_<field>_total{store=<label>}`, as in the reference."""

    def __init__(self, label="chunks"):
        object.__setattr__(self, "label", str(label))
        for name in _STORE_FIELDS:
            object.__setattr__(self, name, 0)

    def __setattr__(self, name, value):
        if name in _STORE_FIELDS:
            delta = value - getattr(self, name, 0)
            if delta > 0:
                obs_metrics.counter(
                    "store_" + name + "_total",
                    "ChunkStore ledger (mirrored from StoreStats)",
                    ("store",)).labels(store=self.label).inc(delta)
        object.__setattr__(self, name, value)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def as_dict(self):
        return {"hits": self.hits, "misses": self.misses,
                "hit_rate": self.hit_rate, "writes": self.writes,
                "dup_writes": self.dup_writes, "corrupt": self.corrupt,
                "bytes_saved": self.bytes_saved,
                "bytes_written": self.bytes_written,
                "gc_evicted": self.gc_evicted,
                "gc_bytes_freed": self.gc_bytes_freed}

    def __str__(self):
        return (f"hits={self.hits} misses={self.misses} "
                f"(hit rate {self.hit_rate:.1%}), "
                f"{self.bytes_saved / 2**20:.1f} MB source not reprocessed, "
                f"{self.bytes_written / 2**20:.1f} MB written")


class ChunkStore:
    """Content-addressed result store with atomic writes and verified reads.

    The store is payload-agnostic: `put`/`get` move {name: ndarray} leaf
    dicts plus a JSON-safe meta dict; `CachedPlan` owns the BatchResult
    <-> entry conversion. `verify_crc=False` skips integrity checks on
    read; `evict_corrupt=True` turns a crc mismatch into an eviction + miss
    (self-healing cache) instead of an IOError (archival strictness).
    """

    def __init__(self, directory, verify_crc=True, evict_corrupt=False):
        self.directory = os.fspath(directory)
        self._objects = os.path.join(self.directory, "objects")
        os.makedirs(self._objects, exist_ok=True)
        self.verify_crc = verify_crc
        self.evict_corrupt = evict_corrupt
        self.stats = StoreStats(
            label=os.path.basename(os.path.normpath(self.directory))
            or "chunks")

    def _path(self, key):
        return os.path.join(self._objects, key)

    # -- write ---------------------------------------------------------------
    def put(self, key, arrays, meta=None) -> bool:
        """Persist {name: ndarray} + meta under `key` atomically. Returns
        False (and writes nothing) when the key already exists — entries
        are immutable, first write wins."""
        final = self._path(key)
        if os.path.isfile(os.path.join(final, "manifest.json")):
            self.stats.dup_writes += 1
            return False
        tmp = tempfile.mkdtemp(prefix=key[:16] + ".tmp-", dir=self._objects)
        manifest = {"key": key, "meta": meta or {}, "leaves": {}}
        written = 0
        for name, arr in arrays.items():
            arr = np.ascontiguousarray(np.asarray(arr))
            fname = name + ".npy"
            fpath = os.path.join(tmp, fname)
            np.save(fpath, arr, allow_pickle=False)
            with open(fpath, "rb") as f:
                crc = zlib.crc32(f.read())
            manifest["leaves"][name] = {
                "file": fname, "shape": list(arr.shape),
                "dtype": str(arr.dtype), "crc32": crc,
            }
            written += os.path.getsize(fpath)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        try:
            os.rename(tmp, final)
        except OSError:            # lost the race to a concurrent writer
            shutil.rmtree(tmp, ignore_errors=True)
            self.stats.dup_writes += 1
            return False
        self.stats.writes += 1
        self.stats.bytes_written += written
        return True

    def put_payload(self, key, payload, src_bytes=0) -> bool:
        """Persist one flat payload dict (the `pack_result` /
        `unpack_result` wire shape: ndarray leaves mixed with JSON-safe
        meta) under `key`. The split is by value type — ndarrays become
        leaves, everything else rides the manifest meta — so the dist
        data plane and `CachedPlan` share one entry codec. `src_bytes`
        is recorded in the meta for later `fetch` accounting. Same
        first-write-wins semantics as `put`."""
        arrays = {k: v for k, v in payload.items()
                  if isinstance(v, np.ndarray)}
        meta = {k: v for k, v in payload.items()
                if not isinstance(v, np.ndarray)}
        if src_bytes:
            meta.setdefault("src_bytes", int(src_bytes))
        return self.put(key, arrays, meta)

    # -- read ----------------------------------------------------------------
    def fetch(self, key, src_bytes=0):
        """Fetch-by-key read path: the flat payload dict ({**leaves,
        **meta}) for a hit, None for a miss — the inverse of
        `put_payload` and the shape `unpack_result` consumes. This is
        the data-plane read used by dist workers and the master's
        result resolution; `get` remains the (arrays, meta) pair view."""
        hit = self.get(key, src_bytes=src_bytes)
        if hit is None:
            return None
        arrays, meta = hit
        return {**arrays, **meta}

    def get(self, key, src_bytes=0):
        """({name: ndarray}, meta) for a hit, None for a miss. `src_bytes`
        (the source payload a hit saves reprocessing) feeds bytes_saved.
        crc mismatches raise IOError, or evict + miss under
        evict_corrupt."""
        path = self._path(key)
        mpath = os.path.join(path, "manifest.json")
        if not os.path.isfile(mpath):
            self.stats.misses += 1
            return None
        try:
            with open(mpath) as f:
                manifest = json.load(f)
            out = {}
            for name, ent in manifest["leaves"].items():
                with open(os.path.join(path, ent["file"]), "rb") as f:
                    raw = f.read()
                if self.verify_crc and zlib.crc32(raw) != ent["crc32"]:
                    raise IOError(
                        f"chunk store corruption in {key[:16]}…/{name}: "
                        f"crc mismatch")
                arr = np.load(io.BytesIO(raw), allow_pickle=False)
                out[name] = arr.reshape(ent["shape"])
        except (IOError, ValueError, KeyError):
            if not self.evict_corrupt:
                raise
            self.evict(key)
            self.stats.corrupt += 1
            self.stats.misses += 1
            return None
        self.stats.hits += 1
        self.stats.bytes_saved += int(src_bytes)
        try:                       # recency mark for gc(): last hit wins
            os.utime(mpath)
        except OSError:            # read-only store: gc falls back to
            pass                   # write order, hits still served
        return out, manifest["meta"]

    # -- inventory -----------------------------------------------------------
    def evict(self, key):
        shutil.rmtree(self._path(key), ignore_errors=True)

    def entry_bytes(self, key) -> int:
        """On-disk payload bytes of one entry (0 when absent)."""
        path = self._path(key)
        if not os.path.isdir(path):
            return 0
        return sum(
            os.path.getsize(os.path.join(path, f))
            for f in os.listdir(path)
            if os.path.isfile(os.path.join(path, f)))

    def gc(self, max_bytes) -> dict:
        """Retention sweep: evict least-recently-HIT entries (manifest
        mtime — refreshed on every verified read, so write order is only
        the tie-break for never-hit entries) until the store's payload
        fits in `max_bytes`. The paper-scale archive motivation: a rolling
        survey stream writes results forever, but only the recent window
        keeps re-hitting; everything older is recomputable by definition
        (the store is a cache, not the archive of record).

        Returns a stats dict: entries/bytes before and after, evicted
        count, bytes freed. Also accumulated on `self.stats`."""
        max_bytes = int(max_bytes)
        ages = []
        for key in self.keys():
            mpath = os.path.join(self._path(key), "manifest.json")
            try:
                mtime = os.path.getmtime(mpath)
            except OSError:        # raced a concurrent evict
                continue
            ages.append((mtime, key, self.entry_bytes(key)))
        ages.sort()                # oldest last-hit first
        total = sum(b for _, _, b in ages)
        before = {"entries": len(ages), "bytes": total}
        evicted = freed = 0
        for _, key, nbytes in ages:
            if total <= max_bytes:
                break
            self.evict(key)
            total -= nbytes
            freed += nbytes
            evicted += 1
        self.stats.gc_evicted += evicted
        self.stats.gc_bytes_freed += freed
        return {"entries_before": before["entries"],
                "bytes_before": before["bytes"],
                "evicted": evicted, "bytes_freed": freed,
                "entries_after": before["entries"] - evicted,
                "bytes_after": total}

    def keys(self):
        if not os.path.isdir(self._objects):
            return []
        # a crashed writer leaves <key16>.tmp-* holding a manifest — those
        # are not entries (the rename never happened)
        return sorted(
            d for d in os.listdir(self._objects)
            if ".tmp-" not in d
            and os.path.isfile(os.path.join(self._objects, d,
                                            "manifest.json")))

    def __contains__(self, key):
        return os.path.isfile(os.path.join(self._path(key), "manifest.json"))

    def __len__(self):
        return len(self.keys())
