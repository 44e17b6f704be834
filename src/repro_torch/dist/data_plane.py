"""The off-master data plane: chunk bytes move through a shared store (the
port's copy of the reference's `dist/data_plane.py`, over the port's
`ChunkStore`, in the same on-disk layout).

With the socket data plane every raw chunk batch and every result payload
crosses the master's one control socket (`fetch_many` / `push_result`
carry megabytes). `StoreDataPlane` moves the bytes to a shared
`ChunkStore` directory that both sides reach:

  * master `offer(wid, chunks)` publishes a raw batch under a content key
    (`raw-<content_key>`) and hands the key to the worker inside the lease
    reply (`lease_chunks`): the socket carries about 70 bytes;
  * worker `fetch_chunks(key)` reads the raw batch from the store,
    computes, and `push(raw_key, payload)` writes the result under the
    paired `res-<content_key>` entry (the `pack_result` payload is already
    an entry's shape), returning the small `{"store_key": ...}` ref that
    rides `push_result`;
  * master `take(key)` materialises the payload at acceptance, after the
    exactly-once `complete()` gate decided which incarnation won.

Content addressing makes redelivery free: a worker SIGKILLed after its
store write but before its push leaves an entry that the recomputing
incarnation dedups against (`put` is first-write-wins), and the master
still accepts exactly once. The raw key's framework tag is
`torch-<device type>`, as in `CachedPlan`.
"""
from __future__ import annotations

import os

import numpy as np

from repro_torch.store.chunk_store import ChunkStore, content_key

RAW_PREFIX = "raw-"
RESULT_PREFIX = "res-"


def result_key(raw_key: str) -> str:
    """The result entry paired with one raw entry: same content hash,
    `res-` prefix. The worker computes it from the lease alone."""
    return RESULT_PREFIX + raw_key.split("-", 1)[1]


class StoreDataPlane:
    """Shared-store data plane for the master/worker runtime.

    Wraps one `ChunkStore` (or a directory path) that master and workers
    both open. The master gives it the run's graph fingerprint and
    framework tag, so that raw keys share `CachedPlan`'s value identity;
    workers rebuild it from `spec()`, shipped in the `hello` setup blob
    (they never hash: keys arrive in leases, result keys derive from
    them)."""

    kind = "store"

    def __init__(self, store, graph_fingerprint=None, framework_tag=None):
        if isinstance(store, (str, os.PathLike)):
            store = ChunkStore(store)
        self.store = store
        self._fingerprint = graph_fingerprint
        self._framework_tag = framework_tag

    def spec(self) -> dict:
        """JSON-safe description a worker rebuilds its handle from."""
        return {"kind": self.kind, "dir": self.store.directory}

    # -- master side ---------------------------------------------------------
    def offer(self, wid, chunks) -> str:
        """Publish one raw chunk batch; return its content key. Repeat
        offers of the same content (redelivery, speculation) dedup on the
        store's first-write-wins `put`."""
        arr = np.ascontiguousarray(np.asarray(chunks, np.float32))
        key = RAW_PREFIX + content_key(arr, self._fingerprint,
                                       self._framework_tag)
        if key not in self.store:
            self.store.put(key, {"chunks": arr}, meta={"wid": int(wid)})
        return key

    def take(self, key):
        """Materialise a result payload at acceptance (None on a miss)."""
        return self.store.fetch(key)

    # -- worker side ---------------------------------------------------------
    def fetch_chunks(self, key):
        """Read one raw chunk batch by lease key (None on a miss)."""
        hit = self.store.get(key)
        if hit is None:
            return None
        return np.asarray(hit[0]["chunks"], np.float32)

    def push(self, raw_key, payload) -> dict:
        """Write one result payload under the key paired with its raw
        entry; return the small ref dict that rides `push_result`."""
        key = result_key(raw_key)
        self.store.put_payload(key, payload)
        return {"store_key": key}
