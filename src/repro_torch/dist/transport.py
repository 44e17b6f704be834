"""Pluggable transports for the master/worker runtime (the port's copy of
the reference's `dist/transport.py`: the same `multiprocessing.connection`
protocol, the same env-only authkey).

A transport answers one question: how does a worker reach the master's
`QueueService`?

  * `InProcTransport`: the address is the service; `connect` hands back
    the object and calls are plain function calls under the queue's lock.
    The worker runtime and the tests use it to run the process path's code
    without a spawn.
  * `ProcTransport`: real OS processes. The master serves the RPC surface
    over `multiprocessing.connection` (pickled `(method, args, kwargs)`
    messages on an authenticated localhost socket, one handler thread per
    accepted connection); workers are spawned as
    `python -m repro_torch.dist.worker --master HOST:PORT` and may be
    SIGKILLed mid-lease: lease-expiry redelivery and `fail_worker` are
    exercised across a real process boundary.
  * `TcpTransport`: `ProcTransport` with a non-loopback bind address
    (default `0.0.0.0`) and a separately advertised dial address, for
    workers on other hosts. Pair it with the store data plane
    (`dist.data_plane.StoreDataPlane` over a shared directory) so that the
    master's socket carries only leases, ids and acks.

Workers are addressed by registration, not argv: `spawn_worker` passes no
shard id on the command line; the worker announces itself at `hello` and
the master assigns its identity there, honouring any
`QueueService.reserve(pid, shard)` made at spawn time. A worker started by
hand on another box joins the same way and gets the next free shard id.

The authkey never rides the command line: workers get it from the
`REPRO_DIST_AUTHKEY` environment variable (never argv, never logged; a
wrong key fails the handshake inside `Listener.accept()`, so no handler
thread is spawned for an unauthenticated peer). Every message is numpy and
plain Python (`QueueService` sees to it): no tensor is pickled onto the
socket. A fetch of chunk batches (`SERVED_FETCHES`) is served under the
program span "serve_fetch": the batches' materialisation on the master and,
over a socket, their pickling and send.
"""
from __future__ import annotations

import os
import secrets
import signal
import subprocess
import sys
import threading
from multiprocessing.connection import Client, Listener
from pathlib import Path

from repro_torch.dist.service import RPC_METHODS, SERVED_FETCHES
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracing as obs_tracing

AUTHKEY_ENV = "REPRO_DIST_AUTHKEY"


class RemoteError(RuntimeError):
    """An RPC raised on the master; the worker sees type + message (the
    traceback stays in the master's log)."""


class InProcTransport:
    """Direct-call transport: serve() returns the service itself and
    connect() hands it back. Exists so the worker runtime and the tests
    can run against the SAME code path proc mode uses, minus pickling."""
    name = "inproc"

    def serve(self, service):
        self._service = service
        return service

    def connect(self, address):
        return _LocalProxy(address if address is not None
                           else self._service)

    def close(self):
        self._service = None


def _n_fetched(method, args, kwargs):
    """The batches one served fetch asks for: `fetch(wid)` one,
    `fetch_many(worker, wids)` its ids."""
    if method != "fetch_many":
        return 1
    wids = kwargs.get("wids", args[1] if len(args) > 1 else ())
    return len(wids)


class _LocalProxy:
    """The in-proc twin of _RpcProxy: same .call surface, no wire."""

    def __init__(self, service):
        self._service = service

    def call(self, method, *args, **kwargs):
        if method not in RPC_METHODS:
            raise RemoteError(f"method {method!r} is not served")
        attr = getattr(self._service, method)
        if method in SERVED_FETCHES:
            with obs_tracing.span("serve_fetch", method=method,
                                  n=_n_fetched(method, args, kwargs)):
                return attr(*args, **kwargs)
        return attr(*args, **kwargs) if callable(attr) else attr

    def close(self):
        self._service = None


class _RpcProxy:
    """Client side of one proc-transport connection. One in-flight call at
    a time per connection (the worker runtime is a single loop; a lock
    keeps any auxiliary thread honest)."""

    def __init__(self, conn):
        self._conn = conn
        self._lock = threading.Lock()

    def call(self, method, *args, **kwargs):
        with self._lock:
            self._conn.send((method, args, kwargs))
            ok, val = self._conn.recv()
        if ok:
            return val
        raise RemoteError(val)

    def close(self):
        try:
            self._conn.close()
        except OSError:
            pass


class WorkerHandle:
    """Master-side handle on one spawned worker process. `shard` is the
    identity the master reserved for it at spawn (None for a worker left
    to the registry's own assignment until its `hello` lands)."""

    def __init__(self, shard, proc):
        self.shard = None if shard is None else int(shard)
        self.proc = proc

    @property
    def worker(self):
        return None if self.shard is None else f"shard{self.shard}"

    @property
    def pid(self) -> int:
        return self.proc.pid

    def poll(self):
        """Exit code, or None while the process runs."""
        return self.proc.poll()

    def kill(self):
        """SIGKILL — no cleanup, no goodbye: the crash the paper's master
        must survive. Leases the worker holds stay registered un-completed
        and come back via expiry or `fail_worker`."""
        try:
            os.kill(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass

    def stall(self, seconds=None):
        """SIGSTOP: freeze the worker where it is (a genuine straggler: no
        heartbeats, no pushes, its lease clock keeps ticking). With
        `seconds`, a daemon timer sends SIGCONT after that long; without,
        call `resume()`. A worker on the card keeps its CUDA context and
        allocations while stopped, and a SIGTERM to it is held until it is
        continued: resume before `shutdown`."""
        if self.proc.poll() is not None:
            return
        try:
            os.kill(self.proc.pid, signal.SIGSTOP)
        except ProcessLookupError:
            return
        if seconds is not None:
            t = threading.Timer(float(seconds), self.resume)
            t.daemon = True
            t.start()

    def resume(self):
        """SIGCONT a stalled worker (a no-op if it is running or gone: a
        timer that fires after the run's teardown signals nothing, since a
        reaped pid may have been reused)."""
        if self.proc.poll() is not None:
            return
        try:
            os.kill(self.proc.pid, signal.SIGCONT)
        except ProcessLookupError:
            pass

    def shutdown(self, timeout=5.0):
        """Best-effort teardown at end of run: TERM, wait, then KILL."""
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout)
            except subprocess.TimeoutExpired:
                self.kill()
        try:
            self.proc.wait(1.0)
        except subprocess.TimeoutExpired:
            pass


class ProcTransport:
    """Real-process transport over authenticated sockets (loopback bind
    by default; `host=` opens it up, `advertise_host=` overrides the
    address handed to workers when the bind address is a wildcard)."""
    name = "proc"

    def __init__(self, host="127.0.0.1", port=0, advertise_host=None):
        self._host, self._port = host, int(port)
        self._advertise_host = advertise_host
        self._listener = None
        self._stop = threading.Event()
        self._authkey = None
        self.address = None

    # -- master side --------------------------------------------------------
    def serve(self, service) -> str:
        """Start serving `service`; returns the address workers dial."""
        if self._listener is not None:
            raise RuntimeError("transport already serving")
        self._authkey = secrets.token_hex(16)
        self._listener = Listener((self._host, self._port),
                                  authkey=self._authkey.encode())
        host, port = self._listener.address
        adv = self._advertise_host or (
            "127.0.0.1" if host in ("0.0.0.0", "::") else host)
        self.address = f"{adv}:{port}"
        self._stop.clear()
        threading.Thread(target=self._accept_loop, args=(service,),
                         daemon=True, name="repro-dist-accept").start()
        return self.address

    def _accept_loop(self, service):
        while not self._stop.is_set():
            try:
                conn = self._listener.accept()
            except Exception:      # closed listener / failed auth handshake
                if self._stop.is_set():
                    return
                continue
            threading.Thread(target=self._serve_conn, args=(conn, service),
                             daemon=True, name="repro-dist-conn").start()

    def _serve_conn(self, conn, service):
        """One handler thread per worker connection: recv (method, args,
        kwargs), dispatch against the RPC surface, send (ok, value). A
        worker SIGKILLed mid-call just drops the connection — the handler
        exits and the queue's lease machinery owns recovery."""
        try:
            while True:
                try:
                    method, args, kwargs = conn.recv()
                except (EOFError, OSError):
                    return
                if method in SERVED_FETCHES:
                    with obs_tracing.span("serve_fetch", method=method,
                                          n=_n_fetched(method, args,
                                                       kwargs)):
                        sent = self._reply(conn, service, method, args,
                                           kwargs)
                else:
                    sent = self._reply(conn, service, method, args, kwargs)
                if not sent:
                    return
        finally:
            try:
                conn.close()
            except OSError:
                pass

    @staticmethod
    def _reply(conn, service, method, args, kwargs):
        """Dispatch one call against the RPC surface and send (ok, value);
        False once the connection is gone."""
        if method not in RPC_METHODS:
            msg = (False, f"method {method!r} is not served")
        else:
            obs_metrics.counter(
                "dist_rpc_calls_total",
                "proc-transport RPCs served, by method",
                ("method",)).labels(method=method).inc()
            try:
                attr = getattr(service, method)
                val = attr(*args, **kwargs) if callable(attr) else attr
                msg = (True, val)
            except Exception as e:          # ship, don't crash
                obs_metrics.counter(
                    "dist_rpc_errors_total",
                    "RPCs that raised on the master",
                    ("method",)).labels(method=method).inc()
                msg = (False, f"{type(e).__name__}: {e}")
        try:
            conn.send(msg)
        except (OSError, ValueError):
            return False
        return True

    def spawn_worker(self, shard=None, lease_items=1, poll_s=None,
                     env_extra=None) -> WorkerHandle:
        """Launch `python -m repro_torch.dist.worker` against this
        transport's address: a fresh interpreter (fork and exec, never a
        forked copy of a process that may hold a CUDA context). The child
        inherits stdio (its tracebacks surface in the master's terminal)
        and gets PYTHONPATH and the authkey through its environment;
        `env_extra` adds to that (a thread count, `CUDA_VISIBLE_DEVICES`).

        No shard id rides the argv: the worker adopts its identity from the
        registry at `hello`. `shard` only stamps the returned handle with
        the id the caller reserved master-side (`QueueService.reserve`);
        None for a pure late joiner. `poll_s` is the worker's sleep after
        an empty lease (None: the worker's default)."""
        if self.address is None:
            raise RuntimeError("serve() first: workers need an address")
        # the directory above the package, from the package's own location
        pkg_root = str(Path(__file__).resolve().parents[2])
        env = dict(os.environ)
        env[AUTHKEY_ENV] = self._authkey
        env["PYTHONPATH"] = pkg_root + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        env.update(env_extra or {})
        argv = [sys.executable, "-m", "repro_torch.dist.worker",
                "--master", self.address,
                "--lease-items", str(int(lease_items))]
        if poll_s is not None:
            argv += ["--poll-s", repr(float(poll_s))]
        proc = subprocess.Popen(argv, env=env)
        return WorkerHandle(shard, proc)

    # -- worker side --------------------------------------------------------
    def connect(self, address, authkey=None) -> _RpcProxy:
        host, _, port = str(address).rpartition(":")
        key = authkey or self._authkey or os.environ.get(AUTHKEY_ENV)
        if not key:
            raise RuntimeError(
                f"no authkey: set {AUTHKEY_ENV} or pass authkey=")
        return _RpcProxy(Client((host, int(port)), authkey=key.encode()))

    def close(self):
        self._stop.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
            self._listener = None


class TcpTransport(ProcTransport):
    """ProcTransport with a non-loopback bind: serve on `0.0.0.0` (or an
    explicit interface) so workers on other hosts can dial in, while the
    wire protocol, authkey handshake, and worker runtime stay identical.
    `advertise_host` is the address workers are told to dial — it
    defaults to loopback for the wildcard bind (the single-box case the
    tests and smoke gates run); set it to the master's routable address
    when the fleet spans machines. Pair with `StoreDataPlane` over a
    shared directory so chunk bytes never transit this socket."""
    name = "tcp"

    def __init__(self, host="0.0.0.0", port=0, advertise_host=None):
        super().__init__(host=host, port=port, advertise_host=advertise_host)
