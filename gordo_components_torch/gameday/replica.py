"""Child-process entry for game-day replicas.

``python -m gordo_components_torch.gameday.replica --root DIR --port N``
boots ONE real serving replica over the shared artifact dir — the same
process shape production runs. The interesting configuration all rides
the environment the harness sets before spawning: mesh identity
(``GORDO_MESH_REPLICA_ID`` / ``GORDO_MESH_REPLICAS``), the streaming/push
planes (``GORDO_STREAM``, ``GORDO_PUSH``), observability cadence, and —
the point of this package — ``GORDO_FAULTS``, which ``server.build_app``
arms at boot, so a fault injected by the parent is live inside a process
boundary away.

Counterpart of ``gordo_components_tpu/gameday/replica.py``. The replica
serves on the card unless ``--device cpu`` asks for the CPU (the JAX
child pins itself to the CPU through ``JAX_PLATFORMS``). SIGTERM stops it
with exit code 0.
"""

import argparse
import signal


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", required=True, help="shared artifact dir")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args()

    from gordo_components_torch.server import run_server

    def stop(signum, frame):
        raise KeyboardInterrupt

    previous = signal.signal(signal.SIGTERM, stop)
    try:
        run_server(args.root, host=args.host, port=args.port, device=args.device)
    except KeyboardInterrupt:
        pass
    finally:
        signal.signal(signal.SIGTERM, previous)


if __name__ == "__main__":
    main()
