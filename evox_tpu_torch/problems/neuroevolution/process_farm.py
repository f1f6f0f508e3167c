"""Multi-process and multi-machine host rollout farm, self-healing — the
port of ``evox_tpu/problems/neuroevolution/process_farm.py``.

Scales rollouts of host simulators (envs that do not run on the card)
across worker PROCESSES and machines. A problem that runs on the card
scales over the mesh instead (``core/distributed.py``); this module is for
host simulators only.

Design — a small TCP fan-out instead of an actor framework:

- The :class:`ProcessRolloutFarm` coordinator listens on a socket.
  Workers connect (on the same machine through
  :func:`spawn_local_workers`, or from any machine that can reach it
  through ``python -m evox_tpu_torch.problems.neuroevolution.process_farm
  HOST:PORT``), receive the pickled ``(env_creator, policy, mo_keys,
  device)`` setup once, then serve rollout requests each generation.
- Each generation the coordinator splits the population into exactly
  ``min(num_workers, pop_size)`` slices (the same ``_tree_split`` slices
  and ``seed + 7919 * i`` per-slice seeds as the in-process
  :class:`~evox_tpu_torch.problems.neuroevolution.rollout_farm.
  HostRolloutFarm` with ``batch_policy=False``, whose fitness this farm's
  equals bit for bit) and dispatches the slices as a task queue over the
  live workers.
- Workers run the ``batch_policy=False`` placement: each owns its env
  slice and loops its episodes to completion with the vmapped policy on
  its own CPU (one intra-op thread; the setup names the device, and a
  worker never initialises CUDA), on a machine that may have no card at
  all. Across machines this is the right placement: per-step round trips
  of observations would wait on the network.
- Messages are length-prefixed pickles, the same bytes as the JAX
  package's wire. ``env_creator`` and ``policy`` must pickle (module-level
  callables, ``functools.partial``).

Fault tolerance (the self-healing contract):

- **Slicing is decoupled from membership**: slice boundaries and
  per-slice seeds depend only on ``num_workers`` (the nominal farm
  size), never on how many workers happen to be alive — so a generation
  that loses a worker mid-flight produces *bit-identical* fitness to a
  failure-free one, because the dead worker's slice is simply re-rolled
  (fully seeded env resets, deterministic rollout) on a survivor.
- **Per-request socket timeouts**: every send/recv of a rollout request
  is bounded by ``request_timeout``; a hung worker is dropped and its
  slice re-dispatched, it can never wedge the generation.
- **Heartbeats**: between generations every worker is pinged
  (``heartbeat_timeout``-bounded); silently-dead connections are pruned
  before any population data is committed to them.
- **Bounded retry/backoff**: a slice is re-dispatched at most
  ``max_task_retries`` times, with short exponential backoff between
  attempts — a deterministically-poisonous slice (worker code raising)
  surfaces as a clean error instead of an infinite retry loop.
- **Graceful degradation floor**: when the live worker count drops below
  ``min_workers`` mid-generation, :class:`FarmDegradedError` is raised
  cleanly (the caller may re-bind / spawn replacements and re-evaluate).
- **Worker re-admission**: the listening socket stays open after
  ``bind()``; every ``evaluate`` first :meth:`admit`\\ s any newly
  connected (replacement) workers using the cached setup payload, so a
  respawned worker rejoins the pool with no coordinator restart.
- **Poison-pill shutdown**: ``shutdown()`` sends every worker an
  explicit shutdown message; workers also exit quietly on coordinator
  EOF instead of crashing with a traceback.

Trust boundary: unpickling executes arbitrary code, so BOTH sides must
trust the peer. The coordinator binds loopback by default and every
connection completes a mutual HMAC challenge/response handshake (the
``multiprocessing.connection`` scheme, raw bytes only — no pickle
crosses the wire before both sides prove knowledge of ``authkey``).
For multi-machine use bind an explicit interface, set a private
``authkey`` on both sides, and treat the key as granting code
execution on every participant: run the farm only on networks where
every host that can reach the port is trusted.

Remaining limits (documented contract, kept deliberately simple):
- The coordinating process stays the single owner of algorithm state; only
  (subpop, seed, cap) requests and (rewards, mo, lengths) results cross
  the wire.
- Like every host problem it runs on the host (``jittable = False``):
  numpy candidates in, numpy fitness out; run it through a workflow,
  ideally under
  :func:`~evox_tpu_torch.workflows.pipelined.run_host_pipelined`.
"""

from __future__ import annotations

import hmac
import logging
import os
import pickle
import select
import socket
import struct
import time
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ...core.problem import Problem
from .rollout_farm import _Worker, _tree_batch_size, _tree_split

_LEN = struct.Struct(">Q")
_LOG = logging.getLogger(__name__)

# Default shared secret for same-machine farms (spawn_local_workers). It
# gates accidental connections, not attackers — multi-machine deployments
# MUST pass their own private authkey to both sides (see module docstring).
DEFAULT_AUTHKEY = b"evox-tpu-farm"


class FarmDegradedError(RuntimeError):
    """Raised when the live worker count drops below ``min_workers`` while
    rollout slices are still outstanding. The farm object stays usable:
    spawn/replace workers (they are re-admitted automatically) and call
    ``evaluate`` again."""


def _send_bytes(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_bytes(sock: socket.socket, limit: int = 1 << 16) -> bytes:
    header = _recv_exact(sock, _LEN.size)
    (n,) = _LEN.unpack(header)
    if n > limit:  # handshake frames are tiny; reject junk before reading it
        raise ConnectionError("oversized handshake frame")
    return _recv_exact(sock, n)


def _deliver_challenge(sock: socket.socket, authkey: bytes) -> None:
    """Prove the PEER knows ``authkey`` (multiprocessing.connection scheme)."""
    challenge = os.urandom(32)
    _send_bytes(sock, challenge)
    digest = _recv_bytes(sock)
    if not hmac.compare_digest(
        digest, hmac.new(authkey, challenge, "sha256").digest()
    ):
        _send_bytes(sock, b"#FAIL")
        raise ConnectionError("farm peer failed authkey challenge")
    _send_bytes(sock, b"#OK")


def _answer_challenge(sock: socket.socket, authkey: bytes) -> None:
    """Prove to the peer that WE know ``authkey``."""
    challenge = _recv_bytes(sock)
    _send_bytes(sock, hmac.new(authkey, challenge, "sha256").digest())
    if _recv_bytes(sock) != b"#OK":
        raise ConnectionError("authkey rejected by farm peer")


def _handshake(sock: socket.socket, authkey: bytes, server: bool) -> None:
    """Mutual authentication — runs BEFORE any pickle crosses the wire, so
    neither side unpickles bytes from an unauthenticated peer."""
    if server:
        _deliver_challenge(sock, authkey)
        _answer_challenge(sock, authkey)
    else:
        _answer_challenge(sock, authkey)
        _deliver_challenge(sock, authkey)


def _send(sock: socket.socket, obj: Any) -> None:
    _send_bytes(sock, pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))


def _recv(sock: socket.socket) -> Any:
    return pickle.loads(_recv_bytes(sock, limit=1 << 62))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("farm peer closed the connection")
        buf.extend(chunk)
    return bytes(buf)


def _advertised_host(bind_host: str) -> str:
    """The host remote workers should dial: the bind interface itself,
    except for the IPv4 wildcard bind (the only wildcard ``create_server``
    accepts under its default AF_INET family), where the
    outbound-interface address is resolved via a connectionless UDP route
    lookup."""
    if bind_host not in ("0.0.0.0", ""):
        return bind_host
    probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        probe.connect(("203.0.113.1", 9))  # TEST-NET-3: no packet is sent
        return probe.getsockname()[0]
    except OSError:  # no route (isolated host): loopback is all there is
        return "127.0.0.1"
    finally:
        probe.close()


# ------------------------------------------------------------------ worker
def worker_main(
    address: Tuple[str, int], authkey: bytes = DEFAULT_AUTHKEY
) -> None:
    """Connect to a coordinator and serve rollout requests until shutdown.

    Run on any machine that can reach the coordinator:
    ``python -m evox_tpu_torch.problems.neuroevolution.process_farm HOST:PORT``
    (set ``EVOX_TPU_FARM_AUTHKEY`` to the coordinator's authkey). The
    connection is mutually authenticated before any pickle is exchanged —
    see the module docstring for the trust boundary.

    The policy runs on the device the setup names, the CPU, with one
    intra-op thread; a worker never initialises CUDA.

    Protocol served: ``ping`` → ``pong`` heartbeat, ``rollout`` →
    ``result`` (echoing the request's ``slice`` id so the coordinator can
    dispatch slices out of order) or ``error`` when the rollout itself
    raised (the worker stays alive — the coordinator decides whether to
    retry), ``shutdown`` → clean exit. Coordinator EOF also exits
    cleanly, so a crashed coordinator never leaves tracebacking workers.
    """
    sock = socket.create_connection(address)
    try:
        _handshake(sock, authkey, server=False)
        _send(sock, {"type": "register"})
        setup = _recv(sock)
        if setup.get("type") != "setup":
            raise ConnectionError(f"expected the farm's setup, got {setup.get('type')!r}")
        if setup.get("device") != "cpu":
            raise ValueError(f"farm workers run their policy on the CPU, not {setup.get('device')!r}")
        torch.set_num_threads(1)
        worker = _Worker(setup["env_creator"], setup["mo_keys"])
        policy = torch.func.vmap(setup["policy"])
        while True:
            try:
                msg = _recv(sock)
            except (ConnectionError, OSError):
                return  # coordinator gone: exit quietly
            if msg["type"] == "shutdown":  # poison pill
                return
            if msg["type"] == "ping":
                reply = {"type": "pong"}
            else:
                if msg["type"] != "rollout":
                    raise ConnectionError(f"unknown farm request {msg['type']!r}")
                try:
                    worker.rollout(
                        policy, msg["subpop"], msg["seed"], msg["cap"]
                    )
                    rewards, mo, lengths = worker.results()
                    reply = {
                        "type": "result",
                        "slice": msg.get("slice"),
                        "rewards": rewards,
                        "mo": mo,
                        "lengths": lengths,
                    }
                except Exception as e:  # env/policy bug: report, stay alive
                    reply = {
                        "type": "error",
                        "slice": msg.get("slice"),
                        "error": f"{type(e).__name__}: {e}",
                    }
            try:
                _send(sock, reply)
            except (ConnectionError, OSError):
                return  # coordinator dropped us (timeout/crash): exit quietly
    finally:
        sock.close()


def spawn_local_workers(
    address: Tuple[str, int], n: int, authkey: bytes = DEFAULT_AUTHKEY
) -> list:
    """Start ``n`` local worker processes connecting to ``address``.

    Returns the ``multiprocessing.Process`` handles (daemonized; join or
    let ``ProcessRolloutFarm.shutdown`` end them). The spawn start method,
    so a worker inherits no thread and no CUDA context of the caller."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [
        ctx.Process(target=worker_main, args=(address, authkey), daemon=True)
        for _ in range(n)
    ]
    for p in procs:
        p.start()
    return procs


# ------------------------------------------------------------- coordinator
class ProcessRolloutFarm(Problem):
    """Coordinator problem: shard host rollouts over worker processes.

    Args:
        policy: ``(params, obs) -> action`` for ONE individual, in
            PyTorch — pickled to the workers, vmapped there, run on their
            CPU.
        env_creator: picklable zero-arg callable building one env.
        num_workers: nominal farm size: worker connections to wait for in
            :meth:`bind`, AND the per-generation slice count — slice
            boundaries and per-slice seeds depend only on this number, so
            fitness is bit-identical however many workers are actually
            alive when a generation runs.
        mo_keys: env-info keys accumulated as objectives.
        cap_episode: per-generation step cap handed to the workers.
        port: coordinator port (0 = ephemeral; read ``self.address``).
        host: bind interface. Defaults to loopback; for multi-machine
            farms bind an explicit interface (or ``"0.0.0.0"``) AND set a
            private ``authkey`` — see the module docstring trust boundary.
        authkey: shared secret for the mutual HMAC handshake every
            connection must pass before any pickle is exchanged.
        min_workers: graceful-degradation floor — a generation keeps
            re-dispatching onto survivors while at least this many
            workers are alive; below it :class:`FarmDegradedError` is
            raised cleanly (default 1: a lone survivor still finishes the
            generation, slower).
        request_timeout: seconds each rollout request (send + result
            recv) may take per worker before that worker is declared hung
            and its slice re-dispatched. None disables (NOT recommended:
            a hung worker then stalls its slice forever).
        heartbeat_timeout: seconds a worker has to answer the
            between-generation ping before being pruned as dead.
        max_task_retries: times one slice may be RE-dispatched after a
            failure before the generation errors out (bounds retries on
            a deterministically-failing slice).
        retry_backoff: base seconds of the exponential backoff slept
            before re-queuing a failed slice.
    """

    jittable = False

    _POLL_S = 0.05  # select() granularity while awaiting results
    _HANDSHAKE_S = 3.0  # per-connection handshake/register budget

    def __init__(
        self,
        policy: Callable,
        env_creator: Callable,
        num_workers: int = 2,
        mo_keys: Sequence[str] = (),
        cap_episode: Optional[int] = None,
        port: int = 0,
        host: str = "127.0.0.1",
        authkey: bytes = DEFAULT_AUTHKEY,
        min_workers: int = 1,
        request_timeout: Optional[float] = 600.0,
        heartbeat_timeout: float = 10.0,
        max_task_retries: int = 3,
        retry_backoff: float = 0.05,
    ):
        if not (1 <= min_workers <= num_workers):
            raise ValueError(
                f"min_workers must be in [1, num_workers], got {min_workers}"
            )
        self.policy = policy
        self.env_creator = env_creator
        self.num_workers = num_workers
        self.mo_keys = tuple(mo_keys)
        self.cap = cap_episode
        self.authkey = authkey
        self.min_workers = min_workers
        self.request_timeout = request_timeout
        self.heartbeat_timeout = heartbeat_timeout
        self.max_task_retries = max_task_retries
        self.retry_backoff = retry_backoff
        self._server = socket.create_server((host, port))
        # advertise an address remote workers can actually use: the bind
        # host, except for wildcard binds where we resolve this machine's
        # outbound interface (loopback would be wrong off-machine)
        self.address = (
            _advertised_host(host), self._server.getsockname()[1]
        )
        self._conns: list = []
        self._bound = False
        # workers whose generation was aborted while their request was in
        # flight: they are still healthy but owe a stale reply (and may be
        # mid-rollout) — heartbeat() gives them the full request budget
        # and drains the leftovers instead of pruning them
        self._dirty: set = set()
        self._seed_rng = np.random.default_rng()
        # worker-health accounting for observability (core/instrument.py's
        # Chrome-trace counter tracks and run reports): cumulative host
        # counters plus one (perf_counter, alive, dropped, redispatched)
        # sample per completed generation — pure host bookkeeping, zero
        # effect on the dispatch protocol
        self.health = {
            "generations": 0,
            "workers_dropped": 0,
            "slices_redispatched": 0,
            "heartbeats": 0,
        }
        self._health_samples: list = []
        # cached setup payload: re-admitted (replacement) workers get the
        # exact bytes the original cohort got
        self._setup_msg = {
            "type": "setup",
            "env_creator": self.env_creator,
            "policy": self.policy,
            "mo_keys": self.mo_keys,
            "device": "cpu",
        }

    # -- membership ---------------------------------------------------------
    def _admit_one(self, timeout: float) -> bool:
        """Accept + authenticate + set up ONE pending connection. Returns
        False when no (valid) peer was admitted within ``timeout``."""
        try:
            self._server.settimeout(timeout)
            conn, _ = self._server.accept()
        except (socket.timeout, OSError):
            # no pending peer — or the server socket is closed (farm
            # already shut down): either way, nobody was admitted
            return False
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # bound the handshake+register exchange: a silent peer (port
        # scanner / health check holding the connection open) must not
        # hang admission — it gets dropped and we keep listening. The
        # budget is deliberately SMALL and independent of the accept
        # timeout: a real worker handshakes in a few RTTs (its heavy
        # imports happen before it dials in), while admit() runs on the
        # per-generation hot path where every held connection stalls
        # evaluate by this amount.
        conn.settimeout(self._HANDSHAKE_S)
        try:
            _handshake(conn, self.authkey, server=True)
            reg = _recv(conn)
            if not (isinstance(reg, dict) and reg.get("type") == "register"):
                raise ConnectionError("farm peer did not register")
            # the peer is authenticated past this point: the (possibly
            # large) setup payload gets the full request budget, not the
            # anti-scanner handshake budget — a multi-MB pickled policy
            # over a slow link must still be able to join
            conn.settimeout(self.request_timeout)
            _send(conn, self._setup_msg)
        except (ConnectionError, OSError, EOFError, pickle.UnpicklingError):
            conn.close()  # unauthenticated/silent peer: drop, keep going
            return False
        conn.settimeout(None)  # rollout requests set their own timeouts
        self._conns.append(conn)
        return True

    def bind(self, timeout: float = 60.0) -> None:
        """Accept exactly ``num_workers`` connections and push the setup.
        Call after the workers were started (``spawn_local_workers`` or
        remote ``worker_main`` invocations)."""
        deadline = time.monotonic() + timeout
        while len(self._conns) < self.num_workers:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"farm bind(): only {len(self._conns)} of "
                    f"{self.num_workers} workers connected within {timeout}s"
                )
            self._admit_one(remaining)
        self._bound = True

    def admit(self) -> int:
        """Accept any workers that connected since the last generation
        (non-blocking). This is the re-admission path: spawn a
        replacement worker at any time and the next ``evaluate`` folds it
        into the pool with the cached setup payload. Returns the number
        of workers admitted."""
        admitted = 0
        while self._admit_one(0.001):
            admitted += 1
        if admitted:
            _LOG.info("farm re-admitted %d worker(s)", admitted)
        return admitted

    def heartbeat(self) -> int:
        """Ping every worker; prune connections that fail to answer within
        ``heartbeat_timeout``. Returns the live worker count. Safe only
        between generations (workers answer pings from their idle loop).

        The ping also RESYNCS the stream: a generation aborted mid-flight
        (FarmDegradedError, retry exhaustion) can leave a worker's result
        for the dead generation queued on the socket — every frame before
        the pong is a stale leftover and is drained and discarded, so the
        next generation starts on a clean protocol state. A worker flagged
        dirty (its request was abandoned mid-rollout) gets the full
        ``request_timeout`` budget to finish and answer — a healthy
        survivor of an aborted generation must not be cascade-pruned just
        because its rollout outlives the heartbeat window. (This extended
        grace requires a ``request_timeout``: with ``request_timeout=None``
        rollouts are unbounded, so the farm cannot distinguish a slow
        survivor from a hung one and falls back to ``heartbeat_timeout``
        rather than risk waiting forever.)

        All pings go out first and the pongs are drained in ONE select
        loop under per-worker deadlines, so N unresponsive workers cost
        one shared ``heartbeat_timeout``, not N serial ones."""
        self.health["heartbeats"] += 1
        waiting: dict = {}  # conn -> pong deadline
        now = time.monotonic()
        for conn in list(self._conns):
            budget = self.heartbeat_timeout
            if conn in self._dirty and self.request_timeout is not None:
                budget = max(budget, self.request_timeout)
            try:
                conn.settimeout(self.heartbeat_timeout)
                _send(conn, {"type": "ping"})
            except Exception:
                _LOG.warning("farm pruning unresponsive worker (ping send)")
                self._drop_worker(conn)
                continue
            waiting[conn] = now + budget
        while waiting:
            readable, _, _ = select.select(list(waiting), [], [], self._POLL_S)
            for conn in readable:
                try:
                    conn.settimeout(
                        max(waiting[conn] - time.monotonic(), 0.1)
                    )
                    res = _recv(conn)
                except Exception:
                    del waiting[conn]
                    _LOG.warning("farm pruning unresponsive worker")
                    self._drop_worker(conn)
                    continue
                if isinstance(res, dict) and res.get("type") == "pong":
                    del waiting[conn]
                    conn.settimeout(None)
                    self._dirty.discard(conn)
                else:
                    _LOG.info("farm drained stale frame from worker")
            now = time.monotonic()
            for conn, deadline in list(waiting.items()):
                if now > deadline:
                    del waiting[conn]
                    _LOG.warning("farm pruning unresponsive worker")
                    self._drop_worker(conn)
        return len(self._conns)

    @staticmethod
    def _close_conn(conn: socket.socket) -> None:
        try:
            conn.close()
        except OSError:
            pass

    def _drop_worker(self, conn: socket.socket) -> None:
        self._close_conn(conn)
        self._dirty.discard(conn)
        if conn in self._conns:
            self._conns.remove(conn)
            self.health["workers_dropped"] += 1

    def shutdown(self) -> None:
        """Poison-pill every worker, then close all sockets."""
        for conn in self._conns:
            try:
                conn.settimeout(self.heartbeat_timeout)
                _send(conn, {"type": "shutdown"})
            except OSError:
                pass
            self._close_conn(conn)
        self._conns = []
        self._dirty = set()
        self._server.close()

    # -- Problem interface --------------------------------------------------
    def fit_shape(self, pop_size: int) -> Tuple[int, ...]:
        if self.mo_keys:
            return (pop_size, len(self.mo_keys))
        return (pop_size,)

    def evaluate(self, state, pop):
        if self._bound:
            self.admit()  # fold in replacement workers first
            self.heartbeat()  # then prune the silently dead
        if not self._conns:
            raise RuntimeError(
                "no workers bound; call farm.bind() after starting workers"
            )
        seed = int(self._seed_rng.integers(0, np.iinfo(np.int32).max))
        pop_size = _tree_batch_size(pop)
        # slice count depends on the NOMINAL farm size only — never on the
        # live membership — so the split and the per-slice seed law below
        # are identical with or without failures (bit-identical fitness)
        n_slices = min(self.num_workers, pop_size)
        subpops = _tree_split(pop, n_slices)
        # same per-slice seed law as HostRolloutFarm(batch_policy=False):
        # the two farms produce identical fitness for identical seeds
        tasks = [
            {
                "type": "rollout",
                "slice": i,
                "subpop": sp,
                "seed": seed + 7919 * i,
                "cap": self.cap,
            }
            for i, sp in enumerate(subpops)
        ]
        results = self._run_tasks(tasks)
        self.health["generations"] += 1
        self._health_samples.append(
            (
                time.perf_counter(),
                len(self._conns),
                self.health["workers_dropped"],
                self.health["slices_redispatched"],
            )
        )
        rewards = [results[i]["rewards"] for i in range(n_slices)]
        mo = [results[i]["mo"] for i in range(n_slices)]
        if self.mo_keys:
            return np.concatenate(mo).astype(np.float32), state
        return np.concatenate(rewards).astype(np.float32), state

    # -- fault-tolerant dispatch -------------------------------------------
    def _run_tasks(self, tasks: list) -> dict:
        """Dispatch ``tasks`` over the live workers, re-dispatching on
        worker death / hang / error, until every slice has a result or
        the farm degrades below ``min_workers``.

        Retry backoff never blocks this loop: a failed slice only becomes
        eligible again after its ``not_before`` stamp, while the loop keeps
        draining other workers' results and enforcing their deadlines. If
        the loop exits by exception (degraded/retries exhausted), workers
        with a request still in flight are marked dirty so the next
        generation's heartbeat drains their stale reply instead of
        misreading it (and gives them the full request budget to answer)."""
        pending = set(range(len(tasks)))
        not_before = [0.0] * len(tasks)  # backoff stamps (monotonic)
        attempts = [0] * len(tasks)
        results: dict = {}
        busy: dict = {}  # conn -> (slice index, deadline or None)
        try:
            while len(results) < len(tasks):
                now = time.monotonic()
                # hand every idle worker the next backoff-eligible slice
                idle = [c for c in self._conns if c not in busy]
                eligible = sorted(i for i in pending if not_before[i] <= now)
                for conn in idle:
                    if not eligible:
                        break
                    i = eligible.pop(0)
                    if self._try_send(conn, tasks[i]):
                        pending.discard(i)
                        deadline = (
                            now + self.request_timeout
                            if self.request_timeout is not None
                            else None
                        )
                        busy[conn] = (i, deadline)
                    # send failure: worker dropped, slice stays pending
                if not busy:
                    if len(self._conns) < self.min_workers:
                        # slices outstanding but not enough workers left
                        self._raise_degraded(pending, results, len(tasks))
                    # workers idle, every pending slice is backing off
                    time.sleep(self._POLL_S)
                    continue
                readable, _, _ = select.select(list(busy), [], [], self._POLL_S)
                for conn in readable:
                    i, _ = busy.pop(conn)
                    res = self._try_recv(conn)
                    if res is not None and res.get("type") == "result":
                        results[i] = res
                    elif res is not None and res.get("type") == "error":
                        # worker is alive; the rollout itself raised — retry
                        # the slice (bounded), keep the worker in the pool
                        _LOG.warning(
                            "farm slice %d failed on worker: %s",
                            i, res.get("error"),
                        )
                        self._requeue(i, pending, not_before, attempts)
                    else:  # torn/garbled reply or dead connection
                        self._drop_worker(conn)
                        self._requeue(i, pending, not_before, attempts)
                now = time.monotonic()
                for conn, (i, deadline) in list(busy.items()):
                    if deadline is not None and now > deadline:
                        _LOG.warning(
                            "farm worker exceeded request_timeout=%.1fs on "
                            "slice %d; dropping it and re-dispatching",
                            self.request_timeout, i,
                        )
                        busy.pop(conn)
                        self._drop_worker(conn)
                        self._requeue(i, pending, not_before, attempts)
                if (
                    len(results) < len(tasks)
                    and len(self._conns) < self.min_workers
                ):
                    self._raise_degraded(pending, results, len(tasks))
        except BaseException:
            # aborted mid-generation: surviving workers still computing an
            # abandoned slice will queue a stale reply — flag them for the
            # heartbeat drain so the protocol resyncs instead of pruning
            # or misreading them
            self._dirty.update(busy)
            raise
        return results

    def _try_send(self, conn: socket.socket, msg: Any) -> bool:
        try:
            if self.request_timeout is not None:
                conn.settimeout(self.request_timeout)
            _send(conn, msg)
            return True
        except (OSError, ConnectionError):
            self._drop_worker(conn)
            return False

    def _try_recv(self, conn: socket.socket) -> Optional[dict]:
        # Documented limitation of the deliberately-small design: once
        # select() marks a conn readable, the full frame is read
        # blockingly (bounded by request_timeout). A peer that sends a
        # partial frame and stalls therefore delays deadline enforcement
        # for OTHER workers by up to one request_timeout (worst-case a
        # second hung worker is dropped at ~2x request_timeout). On the
        # LAN/loopback farms this module targets, result frames transfer
        # in milliseconds; frame reassembly buffers are not worth the
        # complexity here.
        try:
            if self.request_timeout is not None:
                conn.settimeout(self.request_timeout)
            res = _recv(conn)
            return res if isinstance(res, dict) else None
        except Exception:  # EOF, timeout, unpickling of a torn frame, ...
            return None

    def _requeue(
        self, i: int, pending: set, not_before: list, attempts: list
    ) -> None:
        attempts[i] += 1
        if attempts[i] > self.max_task_retries:
            raise RuntimeError(
                f"farm slice {i} failed {attempts[i]} times (max_task_retries="
                f"{self.max_task_retries}); giving up on this generation"
            )
        # short bounded exponential backoff, as an eligibility stamp (NOT a
        # sleep — the dispatch loop keeps servicing other workers): a
        # replacement worker or a transient blip gets a moment first
        not_before[i] = time.monotonic() + min(
            self.retry_backoff * (2 ** (attempts[i] - 1)), 2.0
        )
        pending.add(i)
        self.health["slices_redispatched"] += 1

    # -- observability ------------------------------------------------------
    def health_report(self) -> dict:
        """Cumulative worker-health counters plus the live membership —
        host-side bookkeeping for run reports and dashboards; reading it
        never touches the sockets."""
        return {
            "workers_alive": len(self._conns),
            "num_workers": self.num_workers,
            "min_workers": self.min_workers,
            **self.health,
        }

    def counter_tracks(self) -> dict:
        """Worker-health counter tracks for
        :func:`evox_tpu_torch.core.instrument.write_chrome_trace`'s
        ``extra_counters``: ``{track: [(perf_counter_seconds, value),
        ...]}``, one sample per completed generation. Timestamps share
        the DispatchRecorder clock (``time.perf_counter``), so farm
        health lands at its true host time on the exported timeline."""
        return {
            "farm/workers_alive": [(t, a) for t, a, _, _ in self._health_samples],
            "farm/workers_dropped": [(t, d) for t, _, d, _ in self._health_samples],
            "farm/slices_redispatched": [
                (t, r) for t, _, _, r in self._health_samples
            ],
        }

    def _raise_degraded(self, pending, results, n_tasks) -> None:
        raise FarmDegradedError(
            f"farm degraded below min_workers={self.min_workers}: "
            f"{len(self._conns)} worker(s) alive with "
            f"{n_tasks - len(results)} of {n_tasks} slices incomplete. "
            "Spawn replacement workers (they are re-admitted automatically "
            "on the next evaluate) and retry the generation."
        )


def _cli() -> None:  # pragma: no cover - exercised on remote machines
    import sys

    host, port = sys.argv[1].rsplit(":", 1)
    authkey = os.environ.get("EVOX_TPU_FARM_AUTHKEY", "")
    worker_main(
        (host, int(port)),
        authkey.encode() if authkey else DEFAULT_AUTHKEY,
    )


if __name__ == "__main__":  # pragma: no cover
    _cli()
