"""The serving tier: request traffic -> warm devices (the port's copy of
the reference's `serve` package, audio side).

Three tiers, by traffic shape:

  * In-process pumps (`PreprocessService` without a pool, and the
    language-model `engine.RequestQueue` over an `engine.ServeEngine`):
    requests batched per pump wave and computed in the calling process,
    on its device. Right for offline drains, notebooks and tests.
  * Persistent worker pool (`pool.WorkerPool`): long-lived `dist` workers
    over a standing leased queue, spawned once, each with its CUDA context
    and cuFFT plans warm across waves, SIGKILL-survivable (leases
    redeliver, the completion gate keeps results exactly-once).
  * Continuous batching (`batcher.ContinuousBatcher`): concurrent small
    requests coalesced into pow2-bucketed, zero-padded batches, with
    admission control, per-request deadlines and a linger-bounded pump;
    the front end for the pool (or any plan) under live traffic.

Batch and stream workloads belong to the execution plans
(`core.plans`); this package is for requests that arrive over time and
want their answers back one by one.
"""
from repro_torch.serve.batcher import AdmissionError, ContinuousBatcher
from repro_torch.serve.pool import WorkerPool
from repro_torch.serve.preprocess_service import PreprocessService

__all__ = ["AdmissionError", "ContinuousBatcher", "PreprocessService",
           "WorkerPool"]
