"""The port's chaos harness and the elastic-fleet controls it drives, on
the CPU: `make_schedule` event for event against the JAX package's (several
seeds, sizes, extra events and stall ranges); `ChaosRunner`'s target picks
against the reference's on a stubbed fleet; `WorkerHandle.stall` / `resume`
on a real child process, read from `/proc/<pid>/stat`; `CrashInjector.revive`
against the reference's; `ShardedPlan`'s elastic and straggler knobs, its
teardown order (every worker continued before any is terminated) and
`worker_poll_s` reaching the spawn; a run whose every worker dies, which
finishes with a joiner when elastic and raises otherwise; one `ChaosRunner`
run over real CPU worker processes against the JAX two_phase in backend
mode "ref"; and the `core.pipeline` re-exports.

Every wait is bounded (a thread `join(timeout)`, a bounded poll loop or the
plan's `stall_timeout_s`); no assertion reads wall time. Worker processes
get one intra-op thread each."""
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.configs import SERF_AUDIO as JCFG  # noqa: E402
from repro.core.plans import Preprocessor as JPreprocessor  # noqa: E402
from repro.ft import chaos as jchaos  # noqa: E402
from repro.ft import failure as jfailure  # noqa: E402
from repro.kernels import backend  # noqa: E402

from repro_torch.configs import SERF_AUDIO as cfg  # noqa: E402
from repro_torch.core import graph as port_graph  # noqa: E402
from repro_torch.core import pipeline as port_pipeline  # noqa: E402
from repro_torch.core.plans import Preprocessor, ShardedPlan  # noqa: E402
from repro_torch.data.loader import (  # noqa: E402
    audio_batch_maker, make_shard_pool)
from repro_torch.dist.transport import WorkerHandle  # noqa: E402
from repro_torch.ft import chaos  # noqa: E402
from repro_torch.ft.failure import CrashInjector  # noqa: E402

PROC_KW = {"stall_timeout_s": 120.0, "device": "cpu"}
_MASKS = ("keep", "rain", "silence", "cicada15")


@pytest.fixture(autouse=True)
def one_thread_workers(monkeypatch):
    """Spawned workers inherit the environment: one intra-op thread each
    (the suite runs beside other test processes)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _fields(events):
    return [(e.after_done, e.action, e.stall_s, e.fired, e.deferred,
             e.target, e.fired_at_done) for e in events]


def _proc_state(pid):
    """The state letter of /proc/<pid>/stat ("T" stopped, "S" sleeping,
    "R" running, ...), or None once the pid is gone."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0]
    except (FileNotFoundError, ProcessLookupError):
        return None


def _wait_state(pid, want, tries=2000):
    """Poll /proc until `want(state)` holds (at most `tries` x 10 ms);
    returns the last state read."""
    for _ in range(tries):
        st = _proc_state(pid)
        if want(st):
            return st
        time.sleep(0.01)
    return _proc_state(pid)


def _assert_bitwise(got, want):
    for m in _MASKS:
        np.testing.assert_array_equal(np.asarray(getattr(got.det, m)),
                                      np.asarray(getattr(want.det, m)), m)
    np.testing.assert_array_equal(got.cleaned, want.cleaned)


# ------------------------------------------------------------ schedules

@pytest.mark.parametrize("seed,n,extra,stall_s", [
    (0, 8, 0, (5.0, 9.0)), (11, 6, 0, (5.0, 9.0)), (23, 6, 0, (5.0, 9.0)),
    (37, 6, 0, (5.0, 9.0)), (99, 8, 0, (5.0, 9.0)), (7, 6, 0, (0.5, 1.0)),
    (11, 24, 3, (5.0, 9.0)), (3, 8, 4, (5.0, 9.0)), (5, 2, 2, (1.0, 2.0)),
    (41, 1, 0, (5.0, 9.0)), (12345, 100, 7, (0.5, 1.0))])
def test_make_schedule_matches_reference(seed, n, extra, stall_s):
    """Draw for draw the reference's schedule: the same events, times,
    stall lengths and order."""
    got = chaos.make_schedule(seed, n, extra_events=extra, stall_s=stall_s)
    want = jchaos.make_schedule(seed, n, extra_events=extra,
                                stall_s=stall_s)
    assert _fields(got) == _fields(want)
    assert len(got) == len(chaos.ACTIONS) + extra
    assert {e.action for e in got} >= set(chaos.ACTIONS)
    assert [e.after_done for e in got] == sorted(e.after_done for e in got)


def test_make_schedule_subset_of_actions_matches_reference():
    acts = ("kill", "stall")
    assert chaos.ACTIONS == jchaos.ACTIONS
    assert _fields(chaos.make_schedule(17, 10, actions=acts,
                                       extra_events=3)) == \
        _fields(jchaos.make_schedule(17, 10, actions=acts, extra_events=3))


# ------------------------------------------- target picks on a stub fleet

class _StubQueue:
    def __init__(self):
        self.held = {}

    def leases_held(self, worker):
        return list(self.held.get(worker, ()))


class _StubService:
    def __init__(self):
        self.queue = _StubQueue()
        self.workers = {}


class _StubHandle:
    def __init__(self, shard):
        self.shard = shard
        self.exited = False

    @property
    def worker(self):
        return f"shard{self.shard}"

    def poll(self):
        return -9 if self.exited else None


class _StubFleet:
    """The surface ChaosRunner reads and drives, with a log of what it
    was told to do."""

    def __init__(self, n):
        self.service = _StubService()
        self.handles = {}
        self.log = []
        for _ in range(n):
            self.spawn(log=False)

    def live(self):
        return {k: h for k, h in self.handles.items() if h.poll() is None}

    def spawn(self, shard=None, log=True):
        h = _StubHandle(len(self.handles))
        self.handles[h.shard] = h
        # every other joiner has said hello by the next tick
        if h.shard % 2 == 0 or not log:
            self.service.workers[h.worker] = types.SimpleNamespace(
                state="active")
        if log:
            self.log.append(("spawn", h.shard))
        return h

    def kill(self, shard):
        self.handles[shard].exited = True
        self.log.append(("kill", shard))

    def stall(self, shard, seconds=None):
        self.log.append(("stall", shard, seconds))

    def drain(self, shard):
        self.service.workers[f"shard{shard}"] = types.SimpleNamespace(
            state="draining")
        self.log.append(("drain", shard))

    def resume_all(self):
        self.log.append(("resume_all",))


def _drive_picks(mod, seed, n_workers, events, hold_every):
    """Fire `events` through `mod.ChaosRunner._fire` on a stub fleet, the
    lease holders changing with each tick by a fixed rule: the same
    state sequence for either framework's runner."""
    fleet = _StubFleet(n_workers)
    runner = mod.ChaosRunner(types.SimpleNamespace(elastic=False), [],
                             events, seed=seed, poll_s=0.5, defer_s=2.0)
    rng = mod.random.Random(seed * 7919 + 13)
    tick = 0
    for ev in events:
        for _ in range(1000):
            tick += 1
            fleet.service.queue.held = {
                h.worker: [tick] for k, h in fleet.handles.items()
                if (k + tick) % hold_every == 0}
            if runner._fire(ev, fleet, rng, ev.after_done):
                break
    return fleet.log, _fields(runner.fired), runner.plan.elastic


@pytest.mark.parametrize("seed,n_workers,extra,hold_every", [
    (11, 2, 0, 1), (23, 2, 3, 3), (37, 3, 6, 5), (7, 1, 4, 2),
    (101, 4, 10, 7)])
def test_chaos_runner_picks_match_reference(seed, n_workers, extra,
                                            hold_every):
    """The same fleet states give the same victims, deferrals, capacity
    joins and fire order as the reference's runner."""
    got = _drive_picks(chaos, seed, n_workers,
                       chaos.make_schedule(seed, 12, extra_events=extra),
                       hold_every)
    want = _drive_picks(jchaos, seed, n_workers,
                        jchaos.make_schedule(seed, 12, extra_events=extra),
                        hold_every)
    assert got == want
    log, fired, elastic = got
    assert elastic is True
    assert len(fired) >= len(chaos.ACTIONS) + extra


def test_chaos_runner_spawns_before_losing_the_last_worker():
    """A kill of the only active worker spawns a replacement first,
    recorded as an extra join at after_done -1."""
    fleet = _StubFleet(1)
    fleet.service.queue.held = {"shard0": [0]}
    runner = chaos.ChaosRunner(types.SimpleNamespace(elastic=False), [],
                               [], seed=1)
    ev = chaos.ChaosEvent(1, "kill")
    assert runner._fire(ev, fleet, chaos.random.Random(0), 3)
    assert fleet.log == [("spawn", 1), ("kill", 0)]
    assert [(e.action, e.after_done, e.target) for e in runner.fired] == \
        [("join", -1, 1), ("kill", 1, 0)]
    assert ev.fired_at_done == 3


# ------------------------------------------------ stall / resume a child

@pytest.fixture
def child():
    proc = subprocess.Popen([sys.executable, "-c",
                             "import time; time.sleep(120)"])
    yield proc
    try:
        proc.kill()
    except ProcessLookupError:
        pass
    proc.wait(30)


def test_worker_handle_stall_and_resume(child):
    h = WorkerHandle(0, child)
    assert _wait_state(child.pid, lambda s: s in ("S", "R")) in ("S", "R")
    h.stall()
    assert _wait_state(child.pid, lambda s: s == "T") == "T"
    h.resume()
    assert _wait_state(child.pid, lambda s: s != "T") in ("S", "R")
    assert h.poll() is None


def test_worker_handle_timed_stall_resumes_itself(child):
    h = WorkerHandle(0, child)
    h.stall(0.3)
    assert _wait_state(child.pid, lambda s: s == "T") == "T"
    # the daemon timer sends SIGCONT: no resume() from here
    assert _wait_state(child.pid, lambda s: s != "T") in ("S", "R")
    assert h.poll() is None


def test_worker_handle_stall_of_an_exited_worker_is_a_no_op(child):
    """stall / resume of a process that exited (and was reaped) signal
    nothing; a timer firing after teardown is harmless; a stopped worker
    dies to SIGKILL."""
    h = WorkerHandle(0, child)
    h.stall(0.05)
    assert _wait_state(child.pid, lambda s: s == "T") == "T"
    h.kill()
    child.wait(30)
    assert h.poll() == -9
    h.stall(0.01)
    h.resume()
    t = threading.Timer(0.0, h.resume)
    t.start()
    t.join(10.0)
    assert not t.is_alive()


# --------------------------------------------------------- CrashInjector

def test_crash_injector_revive_matches_reference(child):
    """The same script on both injectors: a fuse burns, the shard dies;
    revive forgets death, fuse and pid; a revived shard pulls again."""
    def script(inj):
        out = []
        inj.kill(1, after_items=1)
        inj.kill(2, after_items=5)
        out += [inj.on_pull(1), inj.on_pull(1), inj.alive(1), inj.on_pull(1)]
        inj.attach(3, child.pid)
        inj.revive(1)
        inj.revive(2)
        inj.revive(3)
        inj.revive(7)                 # never known: a no-op
        out += [inj.alive(1), inj.on_pull(1), inj.on_pull(2),
                sorted(inj.crashed), dict(inj._fuse), dict(inj._pids),
                sorted(inj._dead)]
        inj.kill(1, after_items=0)
        out += [inj.on_pull(1), inj.alive(1), sorted(inj.crashed)]
        return out

    got, want = script(CrashInjector()), script(jfailure.CrashInjector())
    assert got == want
    assert got[:4] == [True, False, False, False]
    assert got[4:8] == [True, True, True, []]
    assert child.poll() is None       # its pid was detached, never killed


# -------------------------------------------- ShardedPlan's elastic knobs

def test_sharded_plan_elastic_knobs_have_the_reference_defaults():
    import inspect
    from repro.core.plans import ShardedPlan as JShardedPlan
    names = ("worker_poll_s", "straggler_factor", "straggler_min_history",
             "elastic")
    mine = inspect.signature(ShardedPlan.__init__).parameters
    ref = inspect.signature(JShardedPlan.__init__).parameters
    assert {n: mine[n].default for n in names} == \
        {n: ref[n].default for n in names}
    pre = Preprocessor(cfg, plan="sharded", device="cpu", elastic=True,
                       straggler_factor=3.5, straggler_min_history=2,
                       worker_poll_s=0.2)
    p = pre.plan
    assert (p.elastic, p.straggler_factor, p.straggler_min_history,
            p.worker_poll_s) == (True, 3.5, 2, 0.2)


@pytest.mark.parametrize("kind,speculate,factor,history", [
    ("inproc", True, 0.0, 1), ("proc", None, 0.0, 1), ("proc", None, 2.0, 4),
    ("tcp", True, 5.0, 9)])
def test_straggler_knobs_reach_the_detector(kind, speculate, factor,
                                            history):
    plan = Preprocessor(cfg, plan="sharded", device="cpu",
                        speculate=speculate, straggler_factor=factor,
                        straggler_min_history=history).plan
    sd = plan._make_straggler(kind)
    assert (sd.factor, sd.min_history) == (factor, history)
    # factor 0 and a history of 1: any in-flight item is a straggler once
    # one completion is on record
    if (factor, history) == (0.0, 1):
        sd.start("a")
        sd.complete("a")
        sd.start("b")
        assert sd.stragglers() == ["b"]
    assert Preprocessor(cfg, plan="sharded", device="cpu",
                        straggler_factor=factor).plan._make_straggler(
                            "inproc") is None


class _ExitedHandle:
    """A worker whose process has already exited, logging its signals."""

    def __init__(self, shard, log):
        self.shard, self.log = shard, log
        self.pid = 900_000 + shard
        self.proc = types.SimpleNamespace(wait=lambda timeout=None: -9)

    @property
    def worker(self):
        return f"shard{self.shard}"

    def poll(self):
        return -9

    def resume(self):
        self.log.append(("resume", self.shard))

    def shutdown(self, timeout=5.0):
        self.log.append(("shutdown", self.shard))

    def kill(self):
        self.log.append(("kill", self.shard))


class _LoggingTransport:
    name = "proc"

    def __init__(self):
        self.log = []

    def serve(self, service):
        self.log.append(("serve",))

    def spawn_worker(self, shard=None, lease_items=1, poll_s=None,
                     env_extra=None):
        self.log.append(("spawn", shard, poll_s))
        return _ExitedHandle(shard, self.log)

    def close(self):
        self.log.append(("close",))


@pytest.mark.parametrize("elastic,match", [
    (False, "every worker process exited"),
    (True, "no worker progress")])
def test_teardown_resumes_every_worker_before_shutdown(elastic, match):
    """Every worker is continued before any is terminated (a stopped
    process holds its SIGTERM); the spawn passes worker_poll_s; with
    elastic=True an empty fleet is not a verdict, and the stall timeout
    is the backstop; failing a worker that holds no lease redelivers
    nothing."""
    tp = _LoggingTransport()
    pre = Preprocessor(cfg, plan="sharded", shards=3, transport=tp,
                       device="cpu", worker_poll_s=0.125, elastic=elastic,
                       stall_timeout_s=0.3)
    make = audio_batch_maker(seed=5, batch_long_chunks=1)
    pool = make_shard_pool(make, 2, 3, lease_timeout_s=60.0)
    with pytest.raises(RuntimeError, match=match):
        list(pre.run(pool))
    assert tp.log[:4] == [("serve",)] + [("spawn", k, 0.125)
                                         for k in range(3)]
    rest = tp.log[4:]
    assert rest == [("resume", k) for k in range(3)] + \
        [("shutdown", k) for k in range(3)] + [("close",)]
    # each exited worker was failed holding no lease: nothing redelivered
    assert pre.plan.redeliveries == 0


@pytest.mark.parametrize("elastic", [False, True])
def test_every_worker_killed(elastic):
    """The only worker is SIGKILLed holding its first lease. elastic=False:
    the run raises that every worker process exited. elastic=True: the run
    waits, and a joiner spawned through plan.fleet finishes the stream,
    every id once, bitwise equal to two_phase, the lease redelivered
    once."""
    make = audio_batch_maker(seed=5, batch_long_chunks=1)
    pool = make_shard_pool(make, 3, 1, lease_timeout_s=120.0)
    inj = CrashInjector()
    inj.kill(0, after_items=0)
    pre = Preprocessor(cfg, plan="sharded", shards=1, transport="proc",
                       injector=inj, elastic=elastic, **PROC_KW)
    if not elastic:
        with pytest.raises(RuntimeError, match="every worker process exited"):
            list(pre.run(pool))
        assert not inj.alive(0)
        return
    results, err = [], []

    def consume():
        try:
            results.extend(pre.run(pool))
        except BaseException as e:     # noqa: BLE001 (asserted below)
            err.append(e)

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    plan = pre.plan
    for _ in range(6000):          # the master reclaims the dead lease
        if plan.fleet is not None and \
                plan.fleet.service.workers.get("shard0") is not None and \
                plan.fleet.service.workers["shard0"].state == "dead":
            break
        t.join(0.01)
    assert plan.fleet.service.workers["shard0"].state == "dead"
    t.join(0.5)                    # the non-elastic master raises at once
    assert t.is_alive() and not err
    assert plan.fleet.live() == {}
    assert plan.fleet.spawn().worker == "shard1"
    t.join(150.0)
    assert not t.is_alive() and not err, err
    assert [r.wid for r in results] == [0, 1, 2]
    ref = Preprocessor(cfg, device="cpu")
    for r in results:
        _assert_bitwise(r, ref(make(r.wid)[0]))
    st = {s.worker: s for s in plan.worker_stats}
    assert st["shard0"].state == "dead" and st["shard1"].state == "departed"
    assert st["shard1"].chunks_done == 3 and plan.redeliveries == 1


# ----------------------------------- a chaos run over real CPU processes

def test_chaos_runner_over_cpu_worker_processes():
    """Seed 11's schedule (a join and a drain at 2 chunks accepted, a kill
    and a 0.8 s SIGSTOP at 4) over 2 CPU worker processes and 6 batches:
    every wid exactly once, every event fired, each action at least once,
    masks equal and cleaned within rtol = atol = 2e-4 of the JAX
    two_phase in backend mode "ref" on the same numpy batches; no worker
    left running or stopped."""
    seed, n = 11, 6
    make = audio_batch_maker(seed=seed, batch_long_chunks=1)
    pool = make_shard_pool(make, n, 2, lease_timeout_s=120.0)
    pre = Preprocessor(cfg, plan="sharded", shards=2, transport="proc",
                       **PROC_KW)
    schedule = chaos.make_schedule(seed, n, stall_s=(0.5, 1.0))
    results, fired = chaos.ChaosRunner(pre.plan, pool, schedule,
                                       seed=seed).run()
    assert pre.plan.elastic
    assert sorted(r.wid for r in results) == list(range(n))
    assert [e.action for e in schedule if not e.fired] == []
    assert {e.action for e in fired} == set(chaos.ACTIONS)
    for h in pre.plan.fleet.handles.values():
        assert h.poll() is not None
        assert _proc_state(h.pid) in (None, "Z")
    with backend.use("ref"):
        ref = JPreprocessor(JCFG, plan="two_phase")
        for r in results:
            want = ref(make(r.wid)[0])
            for m in _MASKS:
                np.testing.assert_array_equal(
                    np.asarray(getattr(r.det, m)),
                    np.asarray(getattr(want.det, m)), m)
            assert r.n_kept == want.n_kept
            np.testing.assert_allclose(r.cleaned, np.asarray(want.cleaned),
                                       rtol=2e-4, atol=2e-4)


# ------------------------------------------------------------- pipeline

def test_pipeline_reexports_the_graph():
    assert port_pipeline.PipelineGraph is port_graph.PipelineGraph
    assert port_pipeline.PipelineOutput is port_graph.PipelineOutput
