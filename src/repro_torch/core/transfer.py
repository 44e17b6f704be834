"""Host <-> device copies of the asynchronous plans.

There is no module of the reference to port here: JAX's runtime does this
work for it. `jnp.asarray` of a numpy batch stages it to the device, and
`copy_to_host_async` starts a readback that a later `np.asarray` waits for.
In PyTorch a `.to("cuda")` of pageable numpy memory and a `.cpu()` both
block the host until the copy (and, for `.cpu()`, all work queued before
it) is done, so nothing overlaps them. `Staging` stands in for the runtime
on the card:

  * Pinned staging. A ring of `slots` page-locked host buffers, and as many
    device input buffers when the plan donates, allocated at the first
    batch (again only when a larger batch comes). Batch k is copied into
    its pinned slot with `Tensor.copy_` (PyTorch's intra-op threads).
  * Upload on a copy stream. The device copy is enqueued `non_blocking` on
    a stream of its own, and the compute stream waits on its end event
    before detection: the upload of batch k+1 overlaps detection of k.
  * Slot reuse. A pinned slot is written again only after its last copy
    has ended (a host wait on that event, normally long past). A device
    slot is written again only after an event the compute stream recorded
    once the batch's detection was enqueued (`release`): this is what
    buffer donation becomes in the port. Without donation each batch gets
    a fresh device tensor, allocated on the copy stream and marked as used
    by the compute stream (`record_stream`), as the caching allocator
    needs. A tensor the caller passed in is never written.
  * Readbacks. A device tensor is copied `non_blocking` into a fresh
    pinned buffer (PyTorch's caching host allocator: no `cudaHostAlloc`
    once warm) on a readback stream that first waits for the compute
    stream, with an event. `Readback.wait` blocks on that event only. The
    array it returns is a view of that pinned buffer, which no later copy
    writes while the array lives. So a caller that holds many results
    holds their pinned memory, and a readback that then finds no free
    buffer in the cache pays a `cudaHostAlloc` (milliseconds for the
    megabytes of a batch's survivors).

On the CPU, and for the synchronous `two_phase` plan, there is no staging:
a batch enters with `torch.as_tensor` and a `Readback` without an event
copies with `.cpu()` when it is waited on.
"""
from __future__ import annotations

import collections
import time

import torch

LOG_CAP = 4096          # uploads kept in `Staging.log`


class Readback:
    """A device tensor on its way to the host. `wait()` returns it as a
    numpy array: after the copy's event when one was started (`host`,
    `event`), else by a blocking `.cpu()` at that point."""
    __slots__ = ("src", "host", "event")

    def __init__(self, src, host=None, event=None):
        self.src, self.host, self.event = src, host, event

    def wait(self):
        if self.event is None:
            return self.src.cpu().numpy()
        self.event.synchronize()
        return self.host.numpy()


class Staging:
    """Pinned, overlapped host <-> device copies for one CUDA device (see
    the module docstring). `upload` -> (device batch, slot); with donation,
    `release(slot)` once the batch's last reader is enqueued (without it
    the slot is None); `readback(t)` -> Readback.

    `log` keeps, per upload, the host staging seconds (the `copy_` into
    pinned memory) and the DMA's start and end events on the copy stream,
    for `upload_times`."""

    def __init__(self, device, slots, donate):
        self.device = torch.device(device)
        self.slots = max(1, int(slots))
        self.donate = bool(donate)
        self.h2d = torch.cuda.Stream(self.device)
        self.d2h = torch.cuda.Stream(self.device)
        self.pinned = []            # flat f32 page-locked host buffers
        self.dev = []               # flat f32 device buffers (donate only)
        self._copied = []           # per slot: end of its last upload
        self._released = []         # per slot: compute is done reading it
        self._k = 0
        self.log = collections.deque(maxlen=LOG_CAP)

    def _allocate(self, n):
        """Rings of `slots` buffers of n floats; the old ones are dropped
        once every copy and every read of them has ended."""
        for ev in self._copied:
            if ev is not None:
                ev.synchronize()
        torch.cuda.current_stream(self.device).synchronize()
        self.pinned = [torch.empty(n, dtype=torch.float32, pin_memory=True)
                       for _ in range(self.slots)]
        self.dev = [torch.empty(n, dtype=torch.float32, device=self.device)
                    for _ in range(self.slots)] if self.donate else []
        self._copied = [None] * self.slots
        self._released = [None] * self.slots

    def upload(self, batch):
        """Stage a host batch (numpy array or CPU tensor) and copy it to the
        device on the copy stream; the current (compute) stream waits for
        the copy. Returns (f32 device tensor, its slot in the device ring
        or None when the plan does not donate)."""
        src = torch.as_tensor(batch)
        n = src.numel()
        if not self.pinned or self.pinned[0].numel() < n:
            self._allocate(n)
        slot = self._k % self.slots
        self._k += 1
        if self._copied[slot] is not None:
            self._copied[slot].synchronize()
        t0 = time.perf_counter()
        host = self.pinned[slot][:n].view(src.shape)
        host.copy_(src)
        stage_s = time.perf_counter() - t0
        compute = torch.cuda.current_stream(self.device)
        if self.donate:
            x = self.dev[slot][:n].view(src.shape)
            if self._released[slot] is not None:
                self.h2d.wait_event(self._released[slot])
        else:
            with torch.cuda.stream(self.h2d):
                x = torch.empty(src.shape, dtype=torch.float32,
                                device=self.device)
            x.record_stream(compute)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self.h2d):
            start.record()
            x.copy_(host, non_blocking=True)
            end.record()
        compute.wait_event(end)
        self._copied[slot] = end
        self.log.append((stage_s, start, end))
        return x, (slot if self.donate else None)

    def release(self, slot):
        """The work enqueued so far on the compute stream is the last to
        read `slot`'s device buffer: a later upload may write it once that
        work is done."""
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        self._released[slot] = ev

    def readback(self, t) -> Readback:
        """Start copying device tensor `t` to pinned host memory, after the
        work queued so far on the compute stream."""
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        self.d2h.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.d2h):
            host.copy_(t, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
        t.record_stream(self.d2h)
        return Readback(t, host, ev)

    def upload_times(self):
        """[(host staging ms, DMA ms)] of the logged uploads, oldest first
        (waits for the last one's copy)."""
        out = []
        for stage_s, start, end in self.log:
            end.synchronize()
            out.append((stage_s * 1e3, start.elapsed_time(end)))
        return out
