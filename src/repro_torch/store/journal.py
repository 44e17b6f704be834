"""Run journal: queue-state checkpointing for cross-restart stream resume
(the port's own copy of the reference's `store/journal.py`, over the port's
`ckpt` and `WorkQueue`, so either framework resumes from the other's
journal).

The paper's master only tracks in-flight work — kill the process and the
stream starts over. `RunJournal` extends the exactly-once story of the
leased `WorkQueue` (worker crashes) across PROCESS restarts: after
every emission the consuming plan records the queue snapshot (done ids,
still-leased ids, stream size); a relaunch with `--resume` restores the
queue and skips exactly the work ids the dead run already emitted.

Records ride the existing ckpt layout — each snapshot is a `step_<n>`
directory written by `ckpt.save` with an empty leaf set and the queue state
in manifest meta, so journal writes inherit ckpt's atomic tmp-then-rename
and `prune_old` retention. The queue state is tiny (id lists), so a
per-emission record costs one small JSON write.
"""
from __future__ import annotations

import os

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.data.queue import WorkQueue


class RunJournal:
    """Append-style journal of WorkQueue snapshots in a directory.

        journal = RunJournal(dir)
        journal.record(queue)          # after each exactly-once emission
        ...process killed, relaunched...
        queue = RunJournal(dir).resume_queue(n_items=n)   # or None, fresh

    Emission gating defines the contract (ShardedPlan's completion-gated
    convention): a plan records IMMEDIATELY BEFORE handing each result to
    its consumer, so everything recorded was emitted and nothing is ever
    emitted twice — exactly-once at the plan boundary across restarts.
    """

    def __init__(self, directory, keep=3):
        self.directory = os.fspath(directory)
        self.keep = keep
        self._step = ckpt.latest_step(self.directory) or 0

    @property
    def step(self) -> int:
        return self._step

    def record(self, queue, meta=None) -> int:
        """Snapshot `queue` (a WorkQueue, or a ready state dict) plus
        optional extra meta. Returns the record's step number."""
        state = queue.state() if hasattr(queue, "state") else dict(queue)
        self._step += 1
        m = {"queue": state, "emitted": len(state["done"])}
        m.update(meta or {})
        ckpt.save(self.directory, self._step, {}, meta=m)
        ckpt.prune_old(self.directory, keep=self.keep)
        return self._step

    def load(self):
        """The latest record's meta dict ({"queue": ..., "emitted": ...,
        **extra}), or None when the journal is empty."""
        step = ckpt.latest_step(self.directory)
        if step is None:
            return None
        _, meta = ckpt.restore(self.directory, step, like=None)
        return meta

    def resume_queue(self, n_items=None, **queue_kw):
        """WorkQueue restored from the latest record; None when the journal
        is empty (fresh run). `n_items`, when given, guards against
        resuming a journal onto a different stream."""
        meta = self.load()
        if meta is None:
            return None
        state = meta["queue"]
        if n_items is not None and int(n_items) != int(state["n_items"]):
            raise ValueError(
                f"journal records a {state['n_items']}-item stream; the "
                f"resume stream has {n_items} items — refusing to mix runs")
        return WorkQueue.from_state(state, **queue_kw)
