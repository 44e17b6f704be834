"""Seeded chaos schedules over an elastic worker-process fleet (the port's
own copy of the reference's `ft/chaos.py`, which imports no JAX).

The sensor-network scenario (Lostanlen et al., PAPERS.md) is long-lived
streams on flaky remote nodes with no fixed fleet: workers crash, stall,
join and leave while the stream runs. `make_schedule(seed, n_items)`
derives a random but seed-determined schedule of such events (SIGKILL,
mid-run join, graceful drain, SIGSTOP stall), draw for draw the
reference's, so one seed gives one schedule in both frameworks.
`ChaosRunner` fires it against a live `ShardedPlan` process run through
the plan's `FleetControl` while the stream is consumed.

Events trigger on progress (chunks accepted so far), never on wall time,
so a schedule lands at the same stream positions whatever a worker's
start costs (on the card: interpreter, CUDA context, kernel libraries).
The target is runtime state (who is alive, who holds leases): kills and
stalls prefer lease holders, since a victim holding work is what
exercises redelivery and speculation; without one the event waits
`defer_s`, then fires at whoever is alive. Picks come from their own
`random.Random(seed * 7919 + 13)`, so adding events to a schedule does not
reshuffle them.

An event that would leave no active worker (killing or draining the last
one) spawns a replacement first: the harness tests elasticity, not that an
empty fleet makes no progress. The bar is absolute: every chunk exactly
once, equal to `two_phase`.
"""
from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass

ACTIONS = ("kill", "join", "drain", "stall")


@dataclass
class ChaosEvent:
    """One scheduled disruption: fires once `after_done` chunks have been
    accepted. `target`, `fired_at_done` and `deferred` are filled as it
    fires."""
    after_done: int
    action: str
    stall_s: float = 6.0
    fired: bool = False
    deferred: int = 0
    target: int = None
    fired_at_done: int = None


def make_schedule(seed, n_items, actions=ACTIONS, extra_events=0,
                  stall_s=(5.0, 9.0)):
    """A seed-determined schedule with at least one event per action in
    `actions`, plus `extra_events` random ones. The join goes early (a
    late joiner must sign in before the stream drains), the stall late (a
    stalled lease holder near the end of the stream is what speculative
    re-lease is for). Same seed, same schedule."""
    rng = random.Random(int(seed))
    n_items = int(n_items)
    hi = max(1, n_items - 2)
    events = []
    for a in actions:
        if a == "join":
            after = rng.randint(1, min(2, hi))
        elif a == "stall":
            after = rng.randint(max(1, n_items - 3), hi)
        else:
            after = rng.randint(1, hi)
        events.append(ChaosEvent(after, a, round(rng.uniform(*stall_s), 2)))
    for _ in range(max(0, int(extra_events))):
        events.append(ChaosEvent(rng.randint(1, hi), rng.choice(actions),
                                 round(rng.uniform(*stall_s), 2)))
    order = {a: i for i, a in enumerate(actions)}
    events.sort(key=lambda e: (e.after_done, order[e.action]))
    return events


class ChaosRunner:
    """Consume `plan.run(stream)` on a thread while firing `schedule`
    against `plan.fleet`. `run()` returns (results, fired events).

    The plan is set to `elastic=True`: under a chaos harness, a moment
    with every worker gone is the gap between a kill and its replacement,
    not a verdict; the plan's stall timeout stays the backstop."""

    def __init__(self, plan, stream, schedule, seed=0, poll_s=0.1,
                 defer_s=4.0):
        self.plan = plan
        self.stream = stream
        self.schedule = list(schedule)
        self.seed = int(seed)
        self.poll_s = float(poll_s)
        # how many ticks a kill or stall waits for a lease-holding victim
        self.defer_ticks = max(1, int(float(defer_s) / self.poll_s))
        plan.elastic = True
        self.fired: list[ChaosEvent] = []

    # -- targets ------------------------------------------------------------
    def _active(self, fleet):
        """Live shards not on their way out (a draining worker leaves by
        request: disrupting it proves nothing)."""
        out = []
        for k, h in fleet.live().items():
            st = fleet.service.workers.get(h.worker)
            if st is None or st.state == "active":
                out.append(k)
        return sorted(out)

    def _holders(self, fleet, shards):
        return [k for k in shards
                if fleet.service.queue.leases_held(fleet.handles[k].worker)]

    def _ensure_capacity(self, fleet, losing):
        """About to remove the last active worker: spawn a replacement
        first (recorded as an extra join, `after_done=-1`)."""
        active = self._active(fleet)
        if len(active) - 1 < 1 and losing in active:
            h = fleet.spawn()
            self.fired.append(ChaosEvent(after_done=-1, action="join",
                                         fired=True, target=h.shard))

    # -- firing -------------------------------------------------------------
    def _fire(self, ev: ChaosEvent, fleet, rng, done):
        if ev.action == "join":
            ev.target = fleet.spawn().shard
        else:
            # fully active victims first, then anything alive (a draining
            # worker is still fair game, and every action must fire)
            candidates = self._active(fleet) or sorted(fleet.live())
            if not candidates:
                ev.deferred += 1     # the fleet is empty for a moment
                return ev.deferred > 10 * self.defer_ticks
            if ev.action in ("kill", "stall"):
                holders = self._holders(fleet, candidates)
                if not holders and ev.deferred < self.defer_ticks:
                    ev.deferred += 1     # wait for a victim holding work
                    return False
                pick = rng.choice(holders or candidates)
                if ev.action == "kill":
                    self._ensure_capacity(fleet, pick)
                    fleet.kill(pick)
                else:
                    fleet.stall(pick, ev.stall_s)
            else:                        # drain
                pick = rng.choice(candidates)
                self._ensure_capacity(fleet, pick)
                fleet.drain(pick)
            ev.target = pick
        ev.fired = True
        ev.fired_at_done = int(done)
        self.fired.append(ev)
        return True

    def run(self):
        results, err = [], []

        def consume():
            try:
                for res in self.plan.run(self.stream):
                    results.append(res)
            except BaseException as e:     # noqa: BLE001 (raised below)
                err.append(e)

        t = threading.Thread(target=consume, daemon=True,
                             name="chaos-consumer")
        t.start()
        rng = random.Random(self.seed * 7919 + 13)
        pending = list(self.schedule)
        try:
            while t.is_alive():
                fleet = self.plan.fleet
                if fleet is None:           # the plan is still setting up
                    time.sleep(self.poll_s)
                    continue
                done, _total = fleet.service.progress()
                for ev in list(pending):
                    if done >= ev.after_done and not err:
                        if self._fire(ev, fleet, rng, done):
                            pending.remove(ev)
                t.join(self.poll_s)
        finally:
            if self.plan.fleet is not None:
                self.plan.fleet.resume_all()   # no stopped orphans
            t.join()
        if err:
            raise err[0]
        return results, self.fired
