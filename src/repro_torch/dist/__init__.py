"""The master/worker runtime behind the sharded plan (the port's copy of
the reference's `dist`).

  * `service.QueueService`: the master's RPC surface over one shared
    `data.queue.WorkQueue` (lease / complete / heartbeat / fail_worker /
    state), the data plane (fetch a chunk batch, push a result), the
    worker registry (`hello` assigns identities, honouring spawn-time
    `reserve(pid, shard)` pins) and per-worker accounting; beside it the
    result codec `pack_result` / `unpack_result`, which chunk-store
    entries share.
  * `transport`: how a worker reaches that surface:

      transport        wire                         scope
      ---------        --------------------------   ------------------
      InProcTransport  direct calls, no pickling    tests
      ProcTransport    authenticated localhost      real processes,
                       sockets (authkey env-only)   one box
      TcpTransport     the same protocol, non-      real processes,
                       loopback bind + advertised   many boxes
                       address

  * `data_plane.StoreDataPlane`: chunk batches and result payloads through
    a shared `ChunkStore`, the socket carrying content keys only.
  * `worker`: the worker runtime, which builds its own `TwoPhasePlan` on
    the device its setup blob names, leases in batches, fetches from the
    socket or the store, computes and pushes results back.
"""
from repro_torch.dist.data_plane import StoreDataPlane
from repro_torch.dist.service import (QueueService, WorkerStats, pack_result,
                                      unpack_result)
from repro_torch.dist.transport import (InProcTransport, ProcTransport,
                                        RemoteError, TcpTransport,
                                        WorkerHandle)

__all__ = ["QueueService", "WorkerStats", "pack_result", "unpack_result",
           "InProcTransport", "ProcTransport", "TcpTransport",
           "RemoteError", "WorkerHandle", "StoreDataPlane"]
