"""Per-device cost analysis by dispatch (the port's counterpart of the
reference's `launch/hlo_analysis.py`).

The reference walks the post-SPMD HLO text XLA compiles, which torch never
produces. This module counts by dispatch instead: it runs the program once
under a `TorchDispatchMode` and counts what one rank dispatches. An op on
DTensors is let through to DTensor (the mode returns `NotImplemented`),
which runs it as this rank's local ops and the collectives its
redistributions need; those local ops and collectives are what is counted,
so every number is per device, as the reference's are. The global-shape
ops DTensor runs on fake tensors to propagate shapes are not counted.

  * matmul-family ops (mm, addmm, bmm, baddbmm, mv, dot: what matmul,
    einsum and linear lower to) -> FLOPs 2 * prod(out dims) * contracted
    size and stream bytes lhs + rhs + out. Convolutions are not counted,
    as the reference's walker counts `dot` only.
  * functional collectives (and DTensor's shard_dim_alltoall) ->
    ring-model wire bytes, with n the group's
    size and R the result's bytes: all-gather R(n-1)/n, all-reduce
    2R(n-1)/n, reduce-scatter R(n-1), all-to-all R(n-1)/n. A group of
    one moves nothing. (The reference's collective-permute has no
    counterpart: DTensor's redistributions do not send point to point.)
  * memory: every storage an op allocates, live until the last tensor
    over it is freed; the peak of their sum.

The reference needs a trip-count walk because XLA counts a scan body once.
A Python loop of L layers dispatches its body L times, so nothing here is
multiplied. The program runs for real: on meta tensors (the dry-run's)
nothing is computed or allocated.
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_aten = torch.ops.aten
_DOTS = {_aten.mm: (0, 1), _aten.addmm: (1, 2), _aten.bmm: (0, 1),
         _aten.baddbmm: (1, 2), _aten.mv: (0, 1), _aten.dot: (0, 1)}


def _collectives():
    """{op overload packet: (reference op name, group-size argument
    index or None, group-name argument index)}."""
    out = {}
    fc = getattr(torch.ops, "_c10d_functional", None)
    if fc is None:
        return out
    table = (("all_gather_into_tensor", "all-gather", 1, 2),
             ("all_reduce", "all-reduce", None, 2),
             ("reduce_scatter_tensor", "reduce-scatter", 2, 3),
             ("all_to_all_single", "all-to-all", None, 3))
    for name, op, size_at, group_at in table:
        if hasattr(fc, name):
            out[getattr(fc, name)] = (op, size_at, group_at)
    # DTensor's all-to-all between two shardings on a mesh that is not
    # the CPU's (a CPU mesh gathers and slices instead)
    dt = getattr(torch.ops, "_dtensor", None)
    if dt is not None and hasattr(dt, "shard_dim_alltoall"):
        out[dt.shard_dim_alltoall] = ("all-to-all", None, 3)
    return out


def _group_size(name):
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def nbytes(t) -> int:
    return t.numel() * t.element_size()


class CostCounter(TorchDispatchMode):
    """Counts one rank's matmul FLOPs and bytes, collective bytes by op
    and the peak of the bytes its ops allocate (`peak_bytes`), while
    active."""

    def __init__(self):
        super().__init__()
        self.dot_flops = 0.0
        self.dot_bytes = 0.0
        self.coll_bytes = 0.0
        self.coll_by_op = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._refs = {}             # storage key -> [tensors over it, bytes]
        self._colls = _collectives()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # DTensor runs it as local ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types) or any(
                isinstance(t, FakeTensor) for t in _tensors(out)):
            # DTensor's sharding propagation building fake tensors of the
            # global shape and running the op on them, for the output's
            # metadata: no work or memory of this rank's
            return out
        packet = func._overloadpacket
        if packet in _DOTS:
            self._dot(packet, args, out)
        elif packet in self._colls:
            self._collective(packet, args, out)
        self._track(out)
        return out

    def _dot(self, packet, args, out):
        i, j = _DOTS[packet]
        lhs, rhs = args[i], args[j]
        contracted = lhs.shape[-1] if lhs.ndim else 1
        self.dot_flops += 2.0 * out.numel() * contracted
        self.dot_bytes += nbytes(lhs) + nbytes(rhs) + nbytes(out)

    def _collective(self, packet, args, out):
        op, size_at, group_at = self._colls[packet]
        n = (int(args[size_at]) if size_at is not None
             else _group_size(args[group_at]))
        if n <= 1:
            return
        r = float(sum(nbytes(t) for t in _tensors(out)))
        if op == "all-gather":
            b = r * (n - 1) / n
        elif op == "all-reduce":
            b = 2.0 * r * (n - 1) / n
        elif op == "reduce-scatter":
            b = r * (n - 1)
        else:
            b = r * (n - 1) / n
        self.coll_bytes += b
        self.coll_by_op[op] = self.coll_by_op.get(op, 0.0) + b

    def _track(self, out):
        for t in _tensors(out):
            try:
                key = t.untyped_storage()._cdata
            except (RuntimeError, NotImplementedError):
                continue
            ref = self._refs.get(key)
            if ref is None:
                size = t.untyped_storage().nbytes()
                ref = self._refs[key] = [0, size]
                self.live_bytes += size
                self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            ref[0] += 1
            weakref.finalize(t, self._release, key)

    def _release(self, key):
        ref = self._refs.get(key)
        if ref is None:
            return
        ref[0] -= 1
        if ref[0] <= 0:
            del self._refs[key]
            self.live_bytes -= ref[1]

    def result(self) -> dict:
        """The reference's `analyze_hlo` keys."""
        return {"dot_flops": self.dot_flops, "dot_bytes": self.dot_bytes,
                "coll_bytes": self.coll_bytes,
                "coll_by_op": dict(self.coll_by_op)}


def analyze(fn, *args, **kwargs):
    """Run `fn(*args, **kwargs)` once under a `CostCounter`: the
    reference's `analyze_hlo` keys (dot_flops, dot_bytes, coll_bytes,
    coll_by_op), per device."""
    with CostCounter() as counter:
        fn(*args, **kwargs)
    return counter.result()
