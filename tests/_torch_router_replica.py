"""Spawnable stub replica for the port router's kill-and-failover drills.

One full port ``serve/server.py`` HTTP stack (Client + ThreadingHTTPServer)
over a trivial echo engine — real sockets, real health lifecycle, real
drain semantics, no model and no device work, so a fleet of these starts
in seconds and dies instantly under SIGKILL. Run by
tests/test_torch_router.py (the ``_torch_mp_worker.py`` launch pattern):

    python tests/_torch_router_replica.py <port> [tag] [delay_ms]

``tag`` surfaces on ``/healthz`` (the hot-swap drill asserts it flips);
``delay_ms`` parks each batch that long so requests can be caught
in flight by a kill. Prints one "READY <port>" line once serving.
"""

import os
import sys
import time

# Launched as a bare script by the router under test — put the repo root
# on sys.path ourselves rather than relying on the spawning env.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    port = int(sys.argv[1])
    tag = sys.argv[2] if len(sys.argv) > 2 else "v1"
    delay_ms = float(sys.argv[3]) if len(sys.argv) > 3 else 0.0

    from distributed_tensorflow_tpu_torch.serve.batcher import BatcherConfig
    from distributed_tensorflow_tpu_torch.serve.engine import RequestError
    from distributed_tensorflow_tpu_torch.serve.server import (
        Client,
        build_http_server,
    )

    class EchoEngine:
        max_batch = 8

        def validate(self, payload):
            if "input_ids" not in payload:
                raise RequestError("input_ids required")

        def run_batch(self, payloads):
            if delay_ms:
                time.sleep(delay_ms / 1e3)
            return [
                {
                    "pred_ids": [int(t) for t in p["input_ids"]],
                    "score": float(sum(int(t) for t in p["input_ids"])),
                }
                for p in payloads
            ]

    client = Client(
        EchoEngine(),
        BatcherConfig(max_batch=8, max_delay_ms=2.0, max_queue=256),
        tag=tag,
    )
    server = build_http_server(client, port=port)
    print(f"READY {server.server_address[1]}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        client.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
