"""Serving driver, on the CUDA card by default (the port's copy of the
reference's `launch/serve.py`), two modes:

Language-model decoding (the model-zoo twin), the default:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
      --batch 4 --prompt-len 128 --gen 32 --requests 8
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu

It builds the arch (`--reduced`: the family-preserving small config) with
parameters drawn from `--seed`, serves `--requests` random prompts through
a `RequestQueue` over a `ServeEngine` in batches of `--batch`, and prints
the tokens served a second and the first request's tokens. All ten archs
serve, the recurrent zamba2-1.2b and xlstm-125m included:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \
      --batch 4 --prompt-len 128 --gen 32 --requests 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m \
      --reduced --device cpu

Audio preprocessing behind the serving tier (`--audio`):
  PYTHONPATH=src python -m repro_torch.launch.serve --audio \
      --pool-workers 2 --pool-transport proc --clients 4 --requests 12 \
      --max-batch 4 --linger-ms 20
  PYTHONPATH=src python -m repro_torch.launch.serve --audio --device cpu \
      --pool-transport inproc

It stands up a `WorkerPool` (long-lived workers, each with its CUDA
context warm across waves), fronts it with a `ContinuousBatcher` (pow2
zero-padded batches, admission control, per-request deadlines), drives it
with concurrent client threads sending single long chunks of the
synthetic stream, and reports the requests served, p50/p99 latency, batch
occupancy and the per-worker ledger. `--trace FILE` writes a Chrome trace
of the run (requests as async spans, the workers' spans parented under
the run span) and `--telemetry DIR` one durable record per accepted
batch; either adds the `metrics:` summary lines (audio mode only).

`--device cpu` runs on the CPU (the plain PyTorch versions); without a
card and without it, either mode fails.
"""
from __future__ import annotations

import argparse
import threading
import time

import numpy as np


def _lm_main(args):
    import torch

    from repro_torch.configs import get_config, reduced as reduce_cfg
    from repro_torch.device import resolve_device
    from repro_torch.models.zoo import build_model
    from repro_torch.serve.engine import RequestQueue, ServeEngine

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    model = build_model(cfg, device=device,
                        generator=torch.Generator(device).manual_seed(
                            args.seed))
    engine = ServeEngine(model, max_seq=args.prompt_len + args.gen + 8,
                         device=device)
    q = RequestQueue(engine, args.batch, args.prompt_len, args.gen)

    rng = np.random.RandomState(args.seed)
    rids = [q.submit(rng.randint(0, cfg.vocab_size, size=args.prompt_len))
            for _ in range(args.requests)]
    t0 = time.time()
    done = []
    while len(done) < len(rids):
        done.extend(q.pump())
    dt = time.time() - t0
    n_tok = len(rids) * args.gen
    print(f"served {len(rids)} requests, {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s) on {device.type}")
    sample = q.result(rids[0])
    print("sample output tokens:", sample[:16].tolist())
    return done


def _audio_main(args):
    from repro_torch.configs import SERF_AUDIO as cfg
    from repro_torch.data.loader import audio_batch_maker
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import telemetry as obs_telemetry
    from repro_torch.obs import tracing as obs_tracing
    from repro_torch.serve import ContinuousBatcher, WorkerPool

    telem = (obs_telemetry.TelemetryWriter(args.telemetry)
             if args.telemetry else None)
    tracer = None
    if args.trace:
        tracer = obs_tracing.Tracer()
        obs_tracing.set_tracer(tracer)
        tracer.start_run("serve_run")
    make = audio_batch_maker(seed=args.seed, batch_long_chunks=1)
    pool = WorkerPool(cfg, workers=args.pool_workers,
                      transport=args.pool_transport,
                      poll_s=args.poll_ms / 1e3,
                      min_workers=args.pool_min_workers,
                      max_workers=args.pool_max_workers,
                      speculate=args.pool_speculate,
                      store=args.pool_store,
                      telemetry=telem, device=args.device).start()
    batcher = ContinuousBatcher(pool=pool, max_batch=args.max_batch,
                                max_queue=args.max_queue,
                                linger_s=args.linger_ms / 1e3)
    lat, lock = [], threading.Lock()

    def client(cid):
        rng = np.random.RandomState(args.seed * 1000 + cid)
        for i in range(args.requests):
            chunk = make(cid * args.requests + i)[0][0]
            t0 = time.monotonic()
            rid = batcher.submit(chunk, timeout_s=args.timeout_s)
            rec = batcher.wait(rid, timeout_s=600.0)
            with lock:
                lat.append((time.monotonic() - t0, rec["ok"]))
            time.sleep(float(rng.exponential(1.0 / args.rate_hz)))

    t0 = time.time()
    with batcher:
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(args.clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    wall = time.time() - t0
    pool.shutdown(drain=True)

    if tracer is not None:
        tracer.finish_run()
        tracer.save(args.trace)
        print(f"trace: {len(tracer.events)} events -> {args.trace}")
    if telem is not None:
        telem.close()
        print(f"telemetry: {telem.records_written} records -> "
              f"{args.telemetry}")
    ok = [t for t, good in lat if good]
    print(f"served {len(ok)}/{len(lat)} requests in {wall:.1f}s "
          f"({len(ok) / wall:.2f} req/s) on {pool.device.type}")
    if ok:
        print(f"latency p50 {np.percentile(ok, 50) * 1e3:.0f} ms, "
              f"p99 {np.percentile(ok, 99) * 1e3:.0f} ms")
    print(f"batcher: {batcher.stats()}")
    print("workers:", [(s.worker, s.pid, s.state, s.chunks_done)
                       for s in pool.worker_stats])
    if args.pool_max_workers is not None:
        print(f"autoscale: {pool.scale_ups} scale-ups, "
              f"{pool.scale_downs} scale-downs, membership epoch "
              f"{pool.service.epoch}")
    if args.trace or args.telemetry:
        for line in obs_metrics.summary_lines():
            print("metrics:", line)
    return lat


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--audio", action="store_true",
                    help="serve audio preprocessing through the worker "
                         "pool and the continuous batcher (default: "
                         "language-model decoding)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; fails without a card) or cpu")
    # language-model mode
    ap.add_argument("--arch", default="gemma-7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--requests", type=int, default=8,
                    help="requests in all (language model) / per client "
                         "(audio)")
    # audio serving mode
    ap.add_argument("--pool-workers", type=int, default=2)
    ap.add_argument("--pool-min-workers", type=int, default=None,
                    help="autoscale floor (default: --pool-workers, a "
                         "fixed fleet)")
    ap.add_argument("--pool-max-workers", type=int, default=None,
                    help="autoscale ceiling: arms scale-up on sustained "
                         "backlog and scale-down by draining idle workers "
                         "(default: off)")
    ap.add_argument("--pool-speculate", action="store_true",
                    help="speculatively duplicate the slowest request in "
                         "flight onto an idle worker (first completion "
                         "wins)")
    ap.add_argument("--pool-transport", default="proc",
                    choices=("proc", "inproc", "tcp"))
    ap.add_argument("--pool-store", default=None, metavar="DIR",
                    help="store data plane: workers fetch chunks from and "
                         "push results into a shared ChunkStore at DIR; "
                         "the pool socket carries only leases and keys")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--rate-hz", type=float, default=1.0,
                    help="per-client mean arrival rate")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-queue", type=int, default=64)
    ap.add_argument("--linger-ms", type=float, default=20.0)
    ap.add_argument("--poll-ms", type=float, default=5.0)
    ap.add_argument("--timeout-s", type=float, default=None,
                    help="per-request deadline (default: none)")
    ap.add_argument("--telemetry", default=None, metavar="DIR",
                    help="durable per-batch JSONL telemetry, written on "
                         "the master at acceptance")
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="Chrome trace-event JSON of the serving run "
                         "(requests appear as async spans)")
    args = ap.parse_args(argv)
    if (args.telemetry or args.trace) and not args.audio:
        ap.error("--telemetry/--trace instrument the audio serving tier")
    return _audio_main(args) if args.audio else _lm_main(args)


if __name__ == "__main__":
    main()
