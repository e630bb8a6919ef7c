"""Fleet front door: replica supervision, affinity routing, failover,
and zero-downtime checkpoint hot-swap.

Every replica is a full ``cli/serve.py`` stack (its own engine, batcher,
health tracker, flight recorder), and this module is the process in front
of them that consumes the router-facing surfaces the stack exposes
(readiness-gated ``/healthz``, ``POST /drainz``, ``POST /migratez``,
``POST /v1/stream_wait`` and the batcher's queue/slot occupancy):

- **Supervision** — a single poll thread probes every replica's
  ``/healthz`` at ``poll_interval_s``; a replica is *lost* on health-poll
  timeout, connection refusal, or process exit.  Verdicts come from
  :class:`~distributed_tensorflow_tpu_torch.obs.fleet.ReplicaSupervisor`
  (the serving twin of the training ``FleetSupervisor``): transient blips
  are ignored below ``fail_threshold``; sustained loss restarts the
  replica under a progress-aware budget with ``train.resilience``-style
  exponential backoff; an exhausted budget QUARANTINES it (the fleet
  routes around a replica that dies instantly rather than feeding it
  traffic to drop).
- **Routing** — power-of-two-choices over ``queue_depth + in_flight +
  slots_active`` (one ``/healthz`` body carries all three), sharpened by
  the router's own per-replica in-flight count so the balancer reacts
  faster than the poll cadence.  **Prefix affinity**: the head of
  ``input_ids`` hashes (blake2b — stable across processes, unlike
  ``hash()``) to a rendezvous pick, so requests sharing a system prompt
  land on the replica whose ``kvpool`` trie is already warm — the
  prefix-cache TTFT win survives fleet spraying.  Affinity yields to
  p2c when the preferred replica is ``affinity_max_imbalance`` loads
  hotter than the coolest (a hot prefix must not melt one replica).
- **Admission + failover** — the door sheds before work reaches a
  replica: no routable replica -> 503 with a minted ``request_id``;
  fleet-wide in-flight cap -> 429 + ``Retry-After``.  A request that
  dies with a replica (transport error, 5xx, mid-drain 503 shed, 429)
  retries on a survivor up to ``max_retries`` times — safe because
  inference is pure: replaying a prompt on another replica returns the
  same tokens.  A ``status: "migrated"`` answer (the stream moved
  mid-generation) is followed to its new home by ``/v1/stream_wait``, or
  replayed with the generated prefix as ``resume_tokens``.
- **Hot swap** — :meth:`Router.hot_swap` rolls a new checkpoint through
  the fleet one replica at a time: ``POST /drainz`` (the balancer stops
  picking it), wait for in-flight + queued work to finish — past
  ``drain_timeout_s`` the live streams move to the survivors by
  ``/migratez`` — stop the old process, relaunch on the new checkpoint,
  wait for warmup-gated ready, VERIFY the replica's ``tag`` actually
  changed, then move on — zero dropped requests by construction, because
  at every instant N-1 replicas are routable.

Observability: ``router_spawn`` / ``replica_lost`` / ``replica_restart``
/ ``hot_swap`` flight-recorder events (the names of
``obs/flightrec.py``'s taxonomy), per-replica labelled Prometheus families
(:meth:`Router.families`), and a ``/fleetz`` digest on the router's own
HTTP server (:func:`build_router_server`).

Threading contract (obs/sanitizer.py discipline): ONE poll thread
(daemon, timeout-joined in ``close()`` exactly like the batcher
flushers); all mutable routing state is guarded by ``Router._lock`` and
declared in ``_RACETRACE_ATTRS``; no HTTP I/O ever happens under the
lock — polls snapshot state, probe outside, then write back.

Port of the JAX package's ``serve/router.py``: host code only, the same
policy, defaults, door rules and HTTP face.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import logging
import random
import subprocess
import threading
import time
import urllib.error
import urllib.request
from collections.abc import Sequence
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import urlparse

from distributed_tensorflow_tpu_torch.obs.export import (
    PROM_CONTENT_TYPE,
    Family,
    render,
)
from distributed_tensorflow_tpu_torch.obs.fleet import ReplicaSupervisor
from distributed_tensorflow_tpu_torch.obs.flightrec import NULL_RECORDER

logger = logging.getLogger(__name__)

__all__ = [
    "Replica",
    "Router",
    "RouterConfig",
    "build_router_server",
    "pick_power_of_two",
    "prefix_affinity_key",
    "rendezvous_pick",
    "replica_load",
]


# --------------------------------------------------------------- policy
# Pure functions: the balancing math is testable without a process,
# a socket, or a thread (tests/test_torch_router.py unit-tests exactly these).


def replica_load(status: dict) -> float:
    """Routing load from one ``/healthz`` body: queued + admitted +
    active decode slots.  Missing keys count zero so a flush-mode replica
    (no slot table) and a bare stub replica rank on the same scale."""
    return float(
        status.get("queue_depth", 0)
        + status.get("in_flight", 0)
        + status.get("slots_active", 0)
    )


def pick_power_of_two(loads: Sequence[float], rng: random.Random) -> int:
    """Power-of-two-choices: sample two distinct replicas, take the less
    loaded (ties -> the first sampled, so the choice stays a pure
    function of ``rng``).  O(1) and within a constant of full scans for
    balance — the classic result this policy is named for."""
    n = len(loads)
    if n <= 0:
        raise ValueError("pick_power_of_two needs at least one load")
    if n == 1:
        return 0
    i, j = rng.sample(range(n), 2)
    return i if loads[i] <= loads[j] else j


def prefix_affinity_key(token_ids, n_tokens: int) -> str | None:
    """Stable hash of the first ``n_tokens`` prompt tokens (the shared
    system-prompt head), or ``None`` for an empty head.  blake2b over the
    decimal token ids: identical across processes and runs — Python's
    ``hash()`` is salted per process and would scatter a restarted
    router's affinity map."""
    head = [int(t) for t in list(token_ids)[: int(n_tokens)]]
    if not head:
        return None
    raw = ",".join(str(t) for t in head).encode()
    return hashlib.blake2b(raw, digest_size=8).hexdigest()

def rendezvous_pick(key: str, names: Sequence[str]) -> str:
    """Highest-random-weight pick of ``names`` for ``key``: every router
    (and every restart) maps the same key to the same replica, and losing
    a replica only remaps the keys that lived on it — the property that
    keeps the other replicas' prefix caches warm through a failure."""
    if not names:
        raise ValueError("rendezvous_pick needs at least one name")
    return max(
        names,
        key=lambda nm: hashlib.blake2b(
            f"{key}:{nm}".encode(), digest_size=8
        ).digest(),
    )


# ------------------------------------------------------------- plumbing


def _get_json(url: str, timeout: float) -> tuple[int, dict]:
    """GET ``url`` -> (code, parsed body).  HTTPError is a RESPONSE here
    (the health contract answers 503 with a JSON body); transport errors
    (refused, timeout, reset) propagate to the caller."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as e:
        try:
            return e.code, json.loads(e.read() or b"{}")
        except (json.JSONDecodeError, OSError):
            return e.code, {"error": str(e)}


def _post_json(
    url: str, payload: dict, request_id: str, timeout: float
) -> tuple[int, dict]:
    """POST JSON -> (code, parsed body); same error split as
    :func:`_get_json`.  The ``X-Request-Id`` header makes the replica
    reuse OUR id, so a retried request keeps one identity across the
    fleet's traces and flight recorders."""
    data = json.dumps(payload).encode()
    req = urllib.request.Request(
        url,
        data=data,
        headers={
            "Content-Type": "application/json",
            "X-Request-Id": request_id,
        },
        method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as e:
        try:
            return e.code, json.loads(e.read() or b"{}")
        except (json.JSONDecodeError, OSError):
            return e.code, {"error": str(e)}


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Router knobs (one frozen bag, like ``BatcherConfig``).

    The restart-budget trio (``max_restarts`` / ``backoff_*``) mirrors
    ``train.resilience.ResilienceConfig`` on purpose — same semantics,
    same defaults — but lives here so the router stays import-light.
    """

    poll_interval_s: float = 0.5     # health-poll cadence
    poll_timeout_s: float = 2.0      # one probe's socket timeout
    start_grace_s: float = 120.0     # failed polls don't count while a
                                     # just-launched replica is starting
    fail_threshold: int = 3          # consecutive failed polls -> lost
    max_restarts: int = 3            # consecutive restarts before quarantine
    backoff_base_s: float = 0.5
    backoff_factor: float = 2.0
    backoff_max_s: float = 30.0
    max_retries: int = 2             # failover hops after the first attempt
    request_timeout_s: float = 60.0
    affinity_tokens: int = 16        # prompt-head tokens hashed for affinity
    affinity_max_imbalance: float = 8.0  # yield affinity when this much hotter
    max_in_flight_per_replica: int = 64  # door cap: this x ready replicas
    ready_timeout_s: float = 180.0   # hot-swap: replica must re-ready by then
    drain_timeout_s: float = 60.0    # hot-swap: in-flight must finish by then
    seed: int = 0                    # p2c rng seed (deterministic tests)


class Replica:
    """One replica's identity + mutable supervision state.

    ``cmd`` is the argv the router (re)launches the replica server with;
    ``cmd=None`` ADOPTS an externally managed replica — it is polled,
    routed to, and failed over from, but never restarted (a lost adopted
    replica just goes ``down`` until its own manager brings it back).
    """

    # Mutated by the poll thread and read by the routing threads; every
    # access is ordered by the owning Router's _lock.
    _RACETRACE_ATTRS = (
        "state", "status", "tag", "in_flight", "requests", "restart_at",
        "swapping",
    )

    def __init__(
        self,
        name: str,
        base_url: str,
        cmd: Sequence[str] | None = None,
        *,
        supervisor: ReplicaSupervisor,
    ):
        self.name = name
        self.base_url = base_url.rstrip("/")
        self.cmd = list(cmd) if cmd else None
        self.supervisor = supervisor
        self.proc: subprocess.Popen | None = None
        self._log_fh = None
        # starting | ready | draining | down | quarantined (plus whatever
        # state string the replica's own /healthz reports while alive).
        self.state = "starting"
        self.status: dict = {}       # last successful probe body
        self.tag: str | None = None  # deployment tag from /healthz
        self.in_flight = 0           # router-side requests on this replica
        self.requests = 0            # lifetime requests routed here
        self.restart_at: float | None = None  # backoff deadline when down
        self.started_at: float | None = None  # launch time (grace window)
        self.swapping = False        # hot_swap owns this replica right now

    def routable(self) -> bool:
        # Degraded stays routable: it IS serving (just burning SLO
        # budget) — dropping every degraded replica under fleet-wide
        # load would shed all traffic exactly when shedding hurts most.
        return self.state in ("ready", "degraded") and not self.swapping


class Router:
    """The fleet front door.  See the module docstring for the design;
    the lifecycle is ``start()`` (spawn + poll thread) ... ``close()``.

    ``specs`` is a list of ``(name, base_url, cmd_or_None)`` triples —
    :func:`replica_specs` builds the common same-host case.
    """

    # Door-level counters, guarded by _lock (watched by sanitize_races in
    # tests/test_torch_router.py's soak).
    _RACETRACE_ATTRS = ("_closed", "_shed", "_retries", "_door_429",
                        "_n_probes", "_migrations")

    def __init__(
        self,
        specs: Sequence[tuple[str, str, Sequence[str] | None]],
        config: RouterConfig | None = None,
        *,
        recorder=None,
        log_dir: str | Path | None = None,
        clock=time.monotonic,
    ):
        if not specs:
            raise ValueError("router needs at least one replica spec")
        self.config = config or RouterConfig()
        self.recorder = recorder if recorder is not None else NULL_RECORDER
        self._clock = clock
        self._lock = threading.Lock()
        self._rng = random.Random(self.config.seed)
        self._req_ids = itertools.count()
        self._log_dir = Path(log_dir) if log_dir else None
        c = self.config
        self.replicas = [
            Replica(
                name,
                url,
                cmd,
                supervisor=ReplicaSupervisor(
                    fail_threshold=c.fail_threshold,
                    max_restarts=c.max_restarts,
                    backoff_base_s=c.backoff_base_s,
                    backoff_factor=c.backoff_factor,
                    backoff_max_s=c.backoff_max_s,
                ),
            )
            for name, url, cmd in specs
        ]
        names = [r.name for r in self.replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate replica names: {names}")
        self._by_name = {r.name: r for r in self.replicas}
        self._closed = False
        self._shed = 0        # door sheds (no routable replica)
        self._door_429 = 0    # door backpressure (fleet in-flight cap)
        self._retries = 0     # failover hops taken
        self._n_probes = 0    # lifetime health probes (fault-hook clock)
        self._migrations = 0  # drain-deadline stream migrations triggered
        # Serving-side chaos (serve/faultinject.py): when set, probe_
        # timeout events swallow health probes on the probe ordinal clock.
        self.fault_injector = None
        self._stop = threading.Event()
        self._poll_thread: threading.Thread | None = None

    # ------------------------------------------------------ spawn / adopt

    def _launch(self, r: Replica) -> None:
        """(Re)launch one replica process; caller holds NO lock (Popen
        can take a while).  Replica stdout/err tees into ``log_dir`` when
        configured so a crashed replica leaves a readable post-mortem."""
        if r.cmd is None:
            raise ValueError(f"replica {r.name} is adopted (no cmd)")
        if self._log_dir is not None:
            self._log_dir.mkdir(parents=True, exist_ok=True)
            if r._log_fh is None or r._log_fh.closed:
                r._log_fh = (self._log_dir / f"{r.name}.log").open("ab")
            out = r._log_fh
        else:
            out = subprocess.DEVNULL
        r.proc = subprocess.Popen(r.cmd, stdout=out, stderr=out)
        r.started_at = self._clock()
        self.recorder.record(
            "router_spawn", replica=r.name, pid=r.proc.pid,
            url=r.base_url,
        )
        logger.info("spawned replica %s pid=%d (%s)",
                    r.name, r.proc.pid, r.base_url)

    def start(self) -> "Router":
        """Spawn every owned replica and start the poll thread."""
        for r in self.replicas:
            if r.cmd is not None and r.proc is None:
                self._launch(r)
            elif r.cmd is None:
                r.started_at = self._clock()
                self.recorder.record(
                    "router_spawn", replica=r.name, adopted=True,
                    url=r.base_url,
                )
        self._poll_thread = threading.Thread(
            target=self._poll_loop, name="router-poll", daemon=True
        )
        self._poll_thread.start()
        return self

    def wait_ready(
        self, n: int | None = None, timeout: float = 60.0
    ) -> bool:
        """Block until >= ``n`` replicas are routable (default: all
        non-quarantined).  Returns False on timeout — callers decide
        whether a partial fleet is fatal."""
        deadline = self._clock() + timeout
        while self._clock() < deadline:
            with self._lock:
                ready = sum(1 for r in self.replicas if r.routable())
                want = n if n is not None else sum(
                    1 for r in self.replicas if r.state != "quarantined"
                )
            if ready >= max(want, 1):
                return True
            time.sleep(0.05)
        return False

    # -------------------------------------------------------- supervision

    def _probe(self, r: Replica) -> tuple[bool, dict | None]:
        """One /healthz probe OUTSIDE the lock: (alive, body).  Alive
        means "answered with parseable JSON" — a 503 draining/starting
        body is an alive replica that must NOT be restarted."""
        inj = self.fault_injector
        if inj is not None:
            with self._lock:
                self._n_probes += 1
                n = self._n_probes
            if inj.check_probe(n):
                return False, None  # drill: the probe timed out
        try:
            _, body = _get_json(
                r.base_url + "/healthz", self.config.poll_timeout_s
            )
            return True, body
        except (urllib.error.URLError, TimeoutError, OSError,
                json.JSONDecodeError):
            return False, None

    def _poll_once(self) -> None:
        now = self._clock()
        with self._lock:
            todo = [
                r for r in self.replicas
                if r.state != "quarantined" and not r.swapping
            ]
        for r in todo:
            exited = r.proc is not None and r.proc.poll() is not None
            alive, body = (False, None) if exited else self._probe(r)
            with self._lock:
                if r.swapping:
                    continue  # hot_swap claimed it mid-poll: hands off
                if alive:
                    r.supervisor.record_poll(True)
                    r.status = body
                    r.tag = body.get("tag", r.tag)
                    new_state = body.get("status", "ready")
                    if new_state == "ready" and r.state != "ready":
                        r.supervisor.record_ready()
                        logger.info("replica %s ready (tag=%s)",
                                    r.name, r.tag)
                    r.state = new_state
                    r.restart_at = None
                    continue
                if exited:
                    # A dead process is not a flaky probe: saturate the
                    # fail count so the verdict fires this poll.
                    for _ in range(self.config.fail_threshold):
                        r.supervisor.record_poll(False)
                else:
                    if r.state == "starting" and r.started_at is not None \
                            and (now - r.started_at) < \
                            self.config.start_grace_s:
                        # Slow start (torch import, AOT grid warmup) is not
                        # a failure: the grace window keeps the restart
                        # budget for replicas that actually died.
                        continue
                    r.supervisor.record_poll(False)
                verdict = r.supervisor.verdict()
                if verdict == "none":
                    # Below threshold: keep routing (failover covers the
                    # window) unless the process is plainly gone.
                    pass
                elif r.state != "down":
                    reason = "exit" if exited else "probe"
                    rc = r.proc.returncode if exited and r.proc else None
                    self.recorder.record(
                        "replica_lost", replica=r.name, reason=reason,
                        returncode=rc, verdict=verdict,
                    )
                    logger.warning(
                        "replica %s lost (%s, rc=%s): verdict=%s",
                        r.name, reason, rc, verdict,
                    )
                    if verdict == "quarantine" or r.cmd is None:
                        r.state = (
                            "quarantined" if verdict == "quarantine"
                            else "down"
                        )
                        r.restart_at = None
                    else:
                        backoff = r.supervisor.record_restart()
                        r.state = "down"
                        r.restart_at = now + backoff
                # Relaunch when the backoff deadline passes (restarts run
                # on the poll thread — no extra supervision thread).
                if (
                    r.state == "down"
                    and r.cmd is not None
                    and r.restart_at is not None
                    and now >= r.restart_at
                ):
                    r.restart_at = None
                    r.state = "starting"
                    relaunch = True
                else:
                    relaunch = False
            if relaunch:
                self._launch(r)
                self.recorder.record(
                    "replica_restart", replica=r.name,
                    restarts=r.supervisor.summary()["total_restarts"],
                )

    def _poll_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._poll_once()
            except Exception:  # noqa: BLE001 — the poll thread must not die
                logger.exception("poll pass failed")
            self._stop.wait(self.config.poll_interval_s)

    # ------------------------------------------------------------ routing

    def pick(self, token_ids=None, exclude: set | None = None) -> str | None:
        """Pick a routable replica name: prefix affinity when the prompt
        head hashes and the preferred replica isn't overloaded, else
        power-of-two-choices on live load.  ``None`` when nothing is
        routable (the caller sheds)."""
        exclude = exclude or set()
        cfg = self.config
        with self._lock:
            ready = [
                (r.name, replica_load(r.status) + r.in_flight)
                for r in self.replicas
                if r.routable() and r.name not in exclude
            ]
        if not ready:
            return None
        loads = dict(ready)
        names = sorted(loads)  # stable order: affinity is order-independent
        if token_ids is not None and cfg.affinity_tokens > 0:
            key = prefix_affinity_key(token_ids, cfg.affinity_tokens)
            if key is not None:
                pref = rendezvous_pick(key, names)
                if loads[pref] <= (
                    min(loads.values()) + cfg.affinity_max_imbalance
                ):
                    return pref
        return names[pick_power_of_two([loads[n] for n in names], self._rng)]

    def route(
        self,
        path: str,
        payload: dict,
        *,
        request_id: str | None = None,
        timeout: float | None = None,
    ) -> tuple[int, dict]:
        """Forward one POST through admission + balancing + failover.

        Returns ``(code, body)``; the body always carries ``request_id``
        and (on success) ``replica``.  Retryable outcomes — transport
        error, 429, 5xx (including a mid-drain 503 shed) — move to a
        survivor up to ``config.max_retries`` times; 2xx and 400/404 are
        final (a malformed request is malformed everywhere)."""
        cfg = self.config
        rid = request_id or f"rt-{next(self._req_ids):08d}"
        token_ids = (
            payload.get("input_ids") if isinstance(payload, dict) else None
        )
        # Door admission: bound fleet-wide in-flight BEFORE picking, so a
        # loaded fleet answers 429-with-Retry-After instead of queueing
        # unboundedly inside the door.
        with self._lock:
            n_ready = sum(1 for r in self.replicas if r.routable())
            total_in_flight = sum(r.in_flight for r in self.replicas)
            cap = cfg.max_in_flight_per_replica * max(n_ready, 1)
            if n_ready and total_in_flight >= cap:
                self._door_429 += 1
                self.recorder.record(
                    "request_reject", rid, cause="router_backpressure",
                    in_flight=total_in_flight, cap=cap,
                )
                return 429, {
                    "error": "router at capacity",
                    "retry_after_s": cfg.poll_interval_s,
                    "request_id": rid,
                }
        tried: set[str] = set()
        attempts = 0
        code, body = None, {}
        while attempts <= cfg.max_retries:
            name = self.pick(token_ids, exclude=tried)
            if name is None:
                break  # nothing routable (left): shed below
            r = self._by_name[name]
            with self._lock:
                r.in_flight += 1
                r.requests += 1
            try:
                code, body = _post_json(
                    r.base_url + path, payload, rid,
                    timeout if timeout is not None
                    else cfg.request_timeout_s,
                )
            except (urllib.error.URLError, TimeoutError, OSError) as e:
                code, body = None, {
                    "error": f"{type(e).__name__}: {e}",
                    "request_id": rid,
                }
            finally:
                with self._lock:
                    r.in_flight -= 1
            if code is not None and (code < 500 and code != 429):
                if code == 200:
                    if body.get("status") == "migrated":
                        # A drain-deadline migration moved this stream
                        # mid-generation: collect the finished result
                        # from the adopting replica (or replay with the
                        # generated prefix) before answering the client.
                        code, body = self._collect_migrated(
                            rid, path, payload, body, timeout
                        )
                    body.setdefault("request_id", rid)
                    body.setdefault("replica", name)
                return code, body
            tried.add(name)
            attempts += 1
            if attempts <= cfg.max_retries:
                with self._lock:
                    self._retries += 1
                logger.info(
                    "request %s failed on %s (code=%s): failing over",
                    rid, name, code,
                )
        if code is not None:
            return code, body  # exhausted retries: last real answer
        with self._lock:
            self._shed += 1
        self.recorder.record("request_reject", rid, cause="router_shed")
        return 503, {
            "error": "no routable replica",
            "request_id": rid,
            "shed": True,
        }

    def _collect_migrated(
        self,
        rid: str,
        path: str,
        payload: dict,
        body: dict,
        timeout: float | None,
    ) -> tuple[int, dict]:
        """Follow a ``status: "migrated"`` answer to the stream's new
        home: ``POST /v1/stream_wait`` on the target blocks for the
        finished generation (the target may itself migrate onward — each
        hop is followed, bounded like failover). When the target cannot
        answer — died, never adopted, already handed the result out — the
        request REPLAYS through normal routing with the client-visible
        generated prefix as ``resume_tokens``, so retry-after-kill never
        re-emits or skips a token: the resumed replica re-prefills the
        prefix at its absolute positions and the accumulated token list
        comes back bit-identical to an uninterrupted run."""
        cfg = self.config
        total = timeout if timeout is not None else cfg.request_timeout_s
        hops = 0
        while body.get("status") == "migrated" and hops <= cfg.max_retries:
            hops += 1
            target = str(body.get("target", ""))
            tokens = [int(t) for t in body.get("tokens", ())]
            deadline = self._clock() + total
            code, out = None, {}
            while self._clock() < deadline:
                try:
                    code, out = _post_json(
                        f"http://{target}/v1/stream_wait",
                        {"request_id": rid, "timeout_s": total},
                        rid,
                        total + 5.0,
                    )
                except (urllib.error.URLError, TimeoutError, OSError):
                    code, out = None, {}
                    break
                if code != 504:
                    break  # 504 = still generating: keep waiting
            if code == 200:
                body = out  # may be "migrated" again: follow the chain
                continue
            # The target can't answer: replay with everything the client
            # (transitively, this router) has already been shown.
            replay = dict(payload)
            if tokens:
                replay["resume_tokens"] = tokens
            with self._lock:
                self._retries += 1
            logger.info(
                "request %s: migrated stream unreachable on %s "
                "(code=%s); replaying with %d resume tokens",
                rid, target, code, len(tokens),
            )
            return self.route(
                path, replay, request_id=rid, timeout=timeout
            )
        return 200, body

    # ----------------------------------------------------------- hot swap

    def _migrate_streams(self, victim: Replica) -> dict:
        """Drain-deadline path: move every live stream off ``victim`` to
        the surviving routable replicas via its ``POST /migratez``.
        Raises RuntimeError when no survivor exists or the victim refuses
        — hot_swap then fails exactly as the old wait-forever path did."""
        with self._lock:
            survivors = [
                r for r in self.replicas
                if r is not victim and r.routable()
            ]
        pairs = []
        for s in survivors:
            u = urlparse(s.base_url)
            pairs.append([u.hostname or "127.0.0.1", int(u.port or 80)])
        if not pairs:
            raise RuntimeError(
                f"hot_swap: {victim.name} did not drain and no survivor "
                "can adopt its streams"
            )
        try:
            code, body = _post_json(
                victim.base_url + "/migratez", {"targets": pairs},
                f"migrate-{victim.name}", self.config.request_timeout_s,
            )
        except (urllib.error.URLError, TimeoutError, OSError) as e:
            raise RuntimeError(
                f"hot_swap: stream migration off {victim.name} failed: {e}"
            ) from e
        if code != 200:
            raise RuntimeError(
                f"hot_swap: stream migration off {victim.name} refused: "
                f"HTTP {code} {body}"
            )
        with self._lock:
            self._migrations += 1
        logger.info(
            "migrated %d live streams off %s (%d to survivors, "
            "%d re-adopted)", body.get("exported", 0), victim.name,
            body.get("migrated", 0), body.get("readopted", 0),
        )
        return body

    def _wait_drained(self, r: Replica, deadline: float) -> bool:
        """Poll the draining replica until queued + in-flight work hits
        zero (its 503 health body still carries the batcher status). One
        zero probe suffices: every flush path — including the serial one,
        which runs its batch ON the flusher thread — counts a running
        batch in ``in_flight`` until its futures resolve, so a zero read
        means nothing is queued, dispatched, or owed to a caller."""
        while self._clock() < deadline:
            alive, body = self._probe(r)
            if alive and (
                body.get("queue_depth", 0) + body.get("in_flight", 0)
                + body.get("slots_active", 0)
            ) == 0:
                return True
            time.sleep(0.05)
        return False

    def _wait_replica_ready(self, r: Replica, deadline: float) -> bool:
        """Probe until /healthz answers ready (warmup-gated on real
        engines) and mirror the result into the routing state."""
        while self._clock() < deadline:
            alive, body = self._probe(r)
            if alive and body.get("status") == "ready":
                with self._lock:
                    r.status = body
                    r.tag = body.get("tag", r.tag)
                    r.state = "ready"
                    r.supervisor.record_ready()
                return True
            time.sleep(0.05)
        return False

    def _stop_proc(self, r: Replica, timeout: float = 10.0) -> None:
        if r.proc is None or r.proc.poll() is not None:
            return
        r.proc.terminate()
        try:
            r.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            r.proc.kill()
            r.proc.wait(timeout)

    def hot_swap(
        self,
        make_cmd,
        *,
        expected_tag: str | None = None,
    ) -> dict:
        """Rolling checkpoint swap: drain -> restart -> verify, one
        replica at a time, so N-1 replicas stay routable throughout.

        ``make_cmd(replica) -> argv`` builds the NEW server command (same
        port, new ``--ckpt-dir``/``--tag``); ``expected_tag`` asserts
        every replica actually came back on the new deployment — a swap
        that silently restarted the old checkpoint is a failure, not a
        success.  Raises RuntimeError on drain timeout, ready timeout, or
        tag mismatch; returns a per-replica summary on success.
        """
        cfg = self.config
        swapped = []
        for r in list(self.replicas):
            with self._lock:
                if r.state == "quarantined" or r.cmd is None:
                    continue
                r.swapping = True  # the poll thread hands this replica off
            try:
                self.recorder.record(
                    "hot_swap", replica=r.name, stage="drain",
                    old_tag=r.tag,
                )
                try:
                    _post_json(
                        r.base_url + "/drainz", {}, f"swap-{r.name}",
                        cfg.poll_timeout_s,
                    )
                except (urllib.error.URLError, TimeoutError, OSError) as e:
                    raise RuntimeError(
                        f"hot_swap: drain of {r.name} failed: {e}"
                    ) from e
                with self._lock:
                    r.state = "draining"
                if not self._wait_drained(
                    r, self._clock() + cfg.drain_timeout_s
                ):
                    # Drain deadline: instead of waiting out
                    # the longest generation (unbounded with a large
                    # max_new_tokens), move the remaining live streams to
                    # the survivors and proceed with the swap. The
                    # victim-held responses come back "migrated" and the
                    # router's route() collects them from their new homes.
                    mig = self._migrate_streams(r)
                    self.recorder.record(
                        "hot_swap", replica=r.name, stage="migrate",
                        exported=mig.get("exported", 0),
                        migrated=mig.get("migrated", 0),
                        readopted=mig.get("readopted", 0),
                    )
                    if not self._wait_drained(
                        r, self._clock() + cfg.drain_timeout_s
                    ):
                        raise RuntimeError(
                            f"hot_swap: {r.name} did not drain within "
                            f"{cfg.drain_timeout_s}s even after migrating "
                            f"{mig.get('migrated', 0)} streams"
                        )
                self._stop_proc(r)
                r.cmd = list(make_cmd(r))
                self._launch(r)
                self.recorder.record(
                    "hot_swap", replica=r.name, stage="restart",
                )
                if not self._wait_replica_ready(
                    r, self._clock() + cfg.ready_timeout_s
                ):
                    raise RuntimeError(
                        f"hot_swap: {r.name} not ready within "
                        f"{cfg.ready_timeout_s}s of restart"
                    )
                if expected_tag is not None and r.tag != expected_tag:
                    raise RuntimeError(
                        f"hot_swap: {r.name} came back with tag "
                        f"{r.tag!r}, expected {expected_tag!r}"
                    )
                self.recorder.record(
                    "hot_swap", replica=r.name, stage="ready",
                    new_tag=r.tag,
                )
                swapped.append({"replica": r.name, "tag": r.tag})
            finally:
                with self._lock:
                    r.swapping = False
        self.recorder.record(
            "hot_swap", stage="done", swapped=len(swapped),
            expected_tag=expected_tag,
        )
        return {"swapped": swapped, "expected_tag": expected_tag}

    # ------------------------------------------------------ observability

    def fleetz(self) -> dict:
        """The /fleetz digest: one consistent read of the routing view."""
        with self._lock:
            reps = [
                {
                    "name": r.name,
                    "url": r.base_url,
                    "state": r.state,
                    "tag": r.tag,
                    "pid": r.proc.pid if r.proc else None,
                    "owned": r.cmd is not None,
                    "in_flight": r.in_flight,
                    "requests": r.requests,
                    "load": replica_load(r.status) + r.in_flight,
                    "served": r.status.get("served"),
                    "supervisor": r.supervisor.summary(),
                }
                for r in self.replicas
            ]
            out = {
                "replicas": reps,
                "n_ready": sum(
                    1 for r in self.replicas if r.routable()
                ),
                "requests": sum(r.requests for r in self.replicas),
                "retries": self._retries,
                "shed": self._shed,
                "door_429": self._door_429,
                "stream_migrations": self._migrations,
                "closed": self._closed,
            }
        return out

    def families(self) -> list[Family]:
        """Per-replica labelled Prometheus families for /metrics."""
        z = self.fleetz()
        up = Family("router_replica_up", "gauge",
                    "1 when the replica is routable")
        inflight = Family("router_replica_in_flight", "gauge",
                          "router-side in-flight requests per replica")
        reqs = Family("router_requests_total", "counter",
                      "requests routed per replica")
        restarts = Family("router_replica_restarts_total", "counter",
                          "replica restarts performed by the router")
        for rep in z["replicas"]:
            lbl = {"replica": rep["name"]}
            up.add(1.0 if rep["state"] == "ready" else 0.0, lbl)
            inflight.add(rep["in_flight"], lbl)
            reqs.add(rep["requests"], lbl)
            restarts.add(rep["supervisor"]["total_restarts"], lbl)
        retries = Family("router_retries_total", "counter",
                         "failover hops taken").add(z["retries"])
        shed = Family("router_shed_total", "counter",
                      "requests shed at the door").add(z["shed"])
        door = Family("router_backpressure_total", "counter",
                      "requests 429ed at the door").add(z["door_429"])
        readyf = Family("router_ready_replicas", "gauge",
                        "routable replicas").add(z["n_ready"])
        return [up, inflight, reqs, restarts, retries, shed, door, readyf]

    # ------------------------------------------------------------ closing

    def close(self, *, stop_replicas: bool = True) -> None:
        """Stop the poll thread (timeout-joined: a stuck join RAISES, the
        batcher idiom) and, by default, the owned replica processes."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._stop.set()
        if self._poll_thread is not None:
            self._poll_thread.join(timeout=30.0)
            if self._poll_thread.is_alive():
                raise RuntimeError("router poll thread failed to stop")
        if stop_replicas:
            for r in self.replicas:
                if r.cmd is not None:
                    self._stop_proc(r)
                if r._log_fh is not None and not r._log_fh.closed:
                    r._log_fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def replica_specs(
    n: int,
    base_port: int,
    make_cmd=None,
    *,
    host: str = "127.0.0.1",
) -> list[tuple[str, str, list[str] | None]]:
    """The common same-host fleet: ``replica-i`` on ``base_port + i``.
    ``make_cmd(name, port) -> argv`` builds each server command; omit it
    to adopt already-running servers on those ports."""
    out = []
    for i in range(n):
        name, port = f"replica-{i}", base_port + i
        cmd = list(make_cmd(name, port)) if make_cmd is not None else None
        out.append((name, f"http://{host}:{port}", cmd))
    return out


# ---------------------------------------------------------------- server


def build_router_server(
    router: Router, host: str = "127.0.0.1", port: int = 0
):
    """The router's own HTTP face (build, don't start — same contract as
    ``serve.server.build_http_server``).

    Routes: ``GET /healthz`` (200 while >=1 replica is routable),
    ``GET /fleetz`` (the digest), ``GET /metrics`` (JSON; ``?format=prom``
    for the exposition), and ``POST /v1/*`` forwarded through
    :meth:`Router.route` (the response body carries ``replica``).
    ``POST /drainz`` drains the whole fleet (operator shutdown path).
    """

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            logger.debug("router http: " + fmt, *args)

        def _reply(self, code: int, body: dict,
                   headers: dict | None = None):
            data = json.dumps(body).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/healthz":
                z = router.fleetz()
                code = 200 if z["n_ready"] > 0 else 503
                self._reply(code, {
                    "status": "ready" if code == 200 else "degraded",
                    "n_ready": z["n_ready"],
                    "n_replicas": len(z["replicas"]),
                })
            elif url.path == "/fleetz":
                self._reply(200, router.fleetz())
            elif url.path == "/metrics":
                if "format=prom" in (url.query or ""):
                    text = render(router.families())
                    data = text.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", PROM_CONTENT_TYPE)
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                else:
                    self._reply(200, router.fleetz())
            else:
                self._reply(404, {"error": f"no route {url.path}"})

        def do_POST(self):
            url = urlparse(self.path)
            if url.path == "/drainz":
                progress = {}
                for r in list(router.replicas):
                    try:
                        _, b = _post_json(
                            r.base_url + "/drainz", {}, "router-drain",
                            router.config.poll_timeout_s,
                        )
                        # Per-replica drain progress (slots_active,
                        # queued, tokens_remaining): the operator sees
                        # why the fleet drain is slow, per replica.
                        progress[r.name] = b.get("progress")
                    except (urllib.error.URLError, TimeoutError, OSError):
                        progress[r.name] = None  # dead = already drained
                self._reply(200, {"draining": True, "progress": progress})
                return
            if not url.path.startswith("/v1/"):
                self._reply(404, {"error": f"no route {url.path}"})
                return
            rid = self.headers.get("X-Request-Id") or None
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
            except json.JSONDecodeError as e:
                self._reply(400, {"error": f"bad JSON: {e}"})
                return
            code, body = router.route(url.path, payload, request_id=rid)
            headers = None
            retry = body.get("retry_after_s")
            if code == 429 and retry is not None:
                headers = {"Retry-After": f"{float(retry):.3f}"}
            self._reply(code, body, headers=headers)

    server = ThreadingHTTPServer((host, port), Handler)
    logger.info("router on http://%s:%d", *server.server_address)
    return server
