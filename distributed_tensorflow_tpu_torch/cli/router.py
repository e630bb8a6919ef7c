"""Run the serving fleet router: spawn (or adopt) N replica servers and
front them with health-driven balancing, failover, and hot-swap.

Spawn mode (the common case) launches ``n`` copies of ``cli/serve.py``
on consecutive ports, every extra flag after ``--`` passed through to
each replica verbatim::

    python -m distributed_tensorflow_tpu_torch.cli.router \\
        --replicas 3 --replica-base-port 8001 --port 8000 \\
        -- --config lm_base --ckpt-dir /ckpts/run1 --slo-p99-ms 200

Adopt mode fronts servers somebody else manages (they are polled and
routed to, never restarted)::

    python -m distributed_tensorflow_tpu_torch.cli.router \\
        --adopt http://10.0.0.1:8000 --adopt http://10.0.0.2:8000

The router's own HTTP face (``/healthz``, ``/fleetz``, ``/metrics``,
forwarded ``/v1/*``) comes from ``serve.router.build_router_server``.
Replicas run on the card by default, as ``cli.serve`` does; pass the serve
CLI's own ``--device cpu`` after ``--`` to run them on the CPU.

Port of the JAX package's ``cli/router.py``: the same flags, the replicas
launched as ``python -m distributed_tensorflow_tpu_torch.cli.serve``.
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys

logger = logging.getLogger(__name__)

# The probe ordinals a key=value --fault-plan places its events within (the
# serve CLI's --fault-steps default); a JSON plan names its own.
FAULT_PROBES = 1000


def main(argv: list[str] | None = None):
    argv = list(sys.argv[1:] if argv is None else argv)
    # Everything after "--" is the replica server's own argv (spawn mode).
    replica_args: list[str] = []
    if "--" in argv:
        split = argv.index("--")
        argv, replica_args = argv[:split], argv[split + 1:]

    parser = argparse.ArgumentParser(
        description="fleet router over N replica serving processes"
    )
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000,
                        help="router listen port (0 = ephemeral)")
    parser.add_argument("--replicas", type=int, default=0,
                        help="spawn this many cli/serve.py replicas "
                             "(flags after -- pass through to each)")
    parser.add_argument("--replica-base-port", type=int, default=8001,
                        help="replica i listens on base+i")
    parser.add_argument("--adopt", action="append", default=[],
                        metavar="URL",
                        help="adopt an externally managed replica "
                             "(repeatable; polled + routed, not restarted)")
    parser.add_argument("--poll-interval", type=float, default=0.5)
    parser.add_argument("--poll-timeout", type=float, default=2.0)
    parser.add_argument("--fail-threshold", type=int, default=3)
    parser.add_argument("--max-restarts", type=int, default=3,
                        help="consecutive restarts before quarantine "
                             "(progress-aware: a replica that re-readies "
                             "resets its count)")
    parser.add_argument("--max-retries", type=int, default=2,
                        help="failover hops per request")
    parser.add_argument("--affinity-tokens", type=int, default=16,
                        help="prompt-head tokens hashed for prefix "
                             "affinity (0 disables)")
    parser.add_argument("--affinity-max-imbalance", type=float, default=8.0)
    parser.add_argument("--max-in-flight-per-replica", type=int, default=64)
    parser.add_argument("--log-dir", default="",
                        help="tee each replica's stdout/stderr to "
                             "<dir>/<name>.log")
    parser.add_argument("--flight-buffer", type=int, default=2048,
                        help="router flight-recorder ring capacity")
    parser.add_argument("--dump-dir", default="",
                        help="router flight-recorder dump directory")
    parser.add_argument("--fault-plan", default="",
                        help="router-side fault plan (chaos drills): "
                        "'seed=..,probe_timeout=N' swallows N seeded health "
                        "probes (of the first 1000) as injected timeouts, or "
                        "a FaultPlan JSON path naming the probe ordinals "
                        "(serve/faultinject.py); replica-side kinds go on "
                        "the replica's own --fault-plan after --")
    args = parser.parse_args(argv)

    if args.replicas <= 0 and not args.adopt:
        parser.error("need --replicas N (spawn) and/or --adopt URL")
    if args.replicas > 0 and not replica_args:
        parser.error("spawn mode needs replica flags after -- "
                     "(at least --config and --ckpt-dir)")

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )

    from distributed_tensorflow_tpu_torch.obs.flightrec import FlightRecorder
    from distributed_tensorflow_tpu_torch.serve.router import (
        Router,
        RouterConfig,
        build_router_server,
        replica_specs,
    )

    def make_cmd(name: str, port: int) -> list[str]:
        return [
            sys.executable, "-m", "distributed_tensorflow_tpu_torch.cli.serve",
            "--host", args.host, "--port", str(port), *replica_args,
        ]

    specs = []
    if args.replicas > 0:
        specs += replica_specs(
            args.replicas, args.replica_base_port, make_cmd, host=args.host
        )
    specs += [
        (f"adopted-{i}", url, None) for i, url in enumerate(args.adopt)
    ]

    recorder = FlightRecorder(
        capacity=args.flight_buffer,
        enabled=args.flight_buffer > 0,
        dump_dir=args.dump_dir or None,
    )
    router = Router(
        specs,
        RouterConfig(
            poll_interval_s=args.poll_interval,
            poll_timeout_s=args.poll_timeout,
            fail_threshold=args.fail_threshold,
            max_restarts=args.max_restarts,
            max_retries=args.max_retries,
            affinity_tokens=args.affinity_tokens,
            affinity_max_imbalance=args.affinity_max_imbalance,
            max_in_flight_per_replica=args.max_in_flight_per_replica,
        ),
        recorder=recorder,
        log_dir=args.log_dir or None,
    )
    if args.fault_plan:
        from distributed_tensorflow_tpu_torch.serve.faultinject import (
            FaultInjector,
            FaultPlan,
        )

        plan = FaultPlan.parse(args.fault_plan, num_steps=FAULT_PROBES)
        router.fault_injector = FaultInjector(plan, recorder=recorder)
        logger.info("router fault plan armed: %d scheduled events",
                    len(plan.events))
    router.start()
    server = build_router_server(router, args.host, args.port)

    # SIGTERM must unwind like Ctrl-C: the default handler would kill the
    # process without running the finallys below, orphaning every owned
    # replica (found by a live kill -TERM drive).
    def _on_term(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _on_term)
    try:
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            logger.info("shutting down fleet")
        finally:
            server.server_close()
        return 0
    finally:
        router.close()


if __name__ == "__main__":
    raise SystemExit(main())
