"""``python -m znicz_tpu_torch fleet`` — boot a serving fleet in one
command; the port of ``znicz_tpu/fleet/cli.py``.

Spawns N ordinary serving workers from one export package, fronts them
with the :class:`~znicz_tpu_torch.fleet.router.FleetRouter`, optionally arms
the SLO autoscaler, and mounts the rolling-update admin endpoints:

    python -m znicz_tpu_torch fleet lm.npz --workers 2 --port 8080 \\
        -- --slots 4 --max-len 256 [--device cpu]

Everything after ``--`` passes through to the worker CLI verbatim.
``POST /rollout {"package": "new.npz"}`` against the router performs a
zero-downtime weight update; SIGTERM drains the whole fleet.  The
fleet modules never touch torch themselves (the federation.py
convention) — all the heavy lifting lives in the worker processes,
which run on the card unless ``-- --device cpu`` says otherwise.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading


def build_fleet_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="znicz_tpu_torch fleet",
        description="front-end router + worker pool + SLO autoscaler "
                    "over one export package")
    p.add_argument("package", help="utils/export.py package the workers "
                                   "boot from (LM package for the "
                                   "generate plane, forward package "
                                   "for the serve plane)")
    p.add_argument("--plane", choices=("generate", "serve"),
                   default="generate",
                   help="which serving CLI the workers run")
    p.add_argument("--workers", type=int, default=2,
                   help="initial worker count (also --min when "
                        "autoscaling unless --min is given)")
    p.add_argument("--port", type=int, default=8080,
                   help="router listen port (0 picks a free one)")
    p.add_argument("--max-retries", type=int, default=2,
                   help="admission failures retried on another worker")
    p.add_argument("--autoscale", action="store_true",
                   help="arm the SLO autoscaler (queue saturation over "
                        "the merged fleet view)")
    p.add_argument("--min", type=int, default=None, dest="min_workers",
                   help="autoscaler floor (default: --workers)")
    p.add_argument("--max", type=int, default=None, dest="max_workers",
                   help="autoscaler ceiling (default: 2x --workers)")
    p.add_argument("--queue-high", type=float, default=8.0,
                   help="fleet-total queue depth that breaches the "
                        "scale-up rule")
    p.add_argument("--cooldown-s", type=float, default=15.0)
    p.add_argument("--idle-down-s", type=float, default=30.0,
                   help="fleet-idle window before a scale-down")
    p.add_argument("--run-dir", default=None,
                   help="worker logs + fleet artifacts (default: "
                        "<package dir>/fleet)")
    p.add_argument("--ready-timeout-s", type=float, default=180.0,
                   help="per-worker boot-to-ready budget")
    p.add_argument("--smoke-test", action="store_true",
                   help="boot, route one request, drain, exit (CI "
                        "probe)")
    p.epilog = ("everything after a literal -- passes through to the "
                "worker CLI verbatim, e.g. `fleet lm.npz --workers 2 "
                "-- --slots 4 --max-len 256`")
    return p


def _smoke(router, plane: str) -> bool:
    """One self-request through the router; True when it round-trips."""
    import urllib.request

    if plane == "generate":
        body = {"tokens": [0], "max_tokens": 4}
        url = f"http://127.0.0.1:{router.port}/generate"
    else:
        # one batch row of zeros at the model's input shape (read off a
        # worker's metadata endpoint), built without numpy — the router
        # process stays torch/numpy-light
        with urllib.request.urlopen(
                router.pool.ready_workers()[0].base + "/",
                timeout=10) as r:
            shape = json.load(r)["model"].get("input_shape", [1])

        def zeros(dims):
            if not dims:
                return 0.0
            return [zeros(dims[1:]) for _ in range(dims[0])]

        body = {"input": [zeros(list(shape))]}
        url = f"http://127.0.0.1:{router.port}/predict"
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        if plane == "generate":
            lines = [json.loads(raw) for raw in r]
            return bool(lines) and lines[-1].get("done") is True and \
                "error" not in lines[-1]
        return "output" in json.load(r)


def fleet_main(argv) -> int:
    from znicz_tpu_torch.fleet.autoscale import Autoscaler
    from znicz_tpu_torch.fleet.rollout import RollingUpdate
    from znicz_tpu_torch.fleet.router import FleetRouter
    from znicz_tpu_torch.fleet.workers import WorkerPool

    # the worker pass-through is split off BEFORE argparse sees it:
    # REMAINDER after a positional would swallow the fleet's own flags
    worker_args: list = []
    argv = list(argv)
    if "--" in argv:
        i = argv.index("--")
        argv, worker_args = argv[:i], argv[i + 1:]
    args = build_fleet_parser().parse_args(argv)
    if args.workers < 1:
        print("fleet: --workers must be >= 1", file=sys.stderr)
        return 2
    try:
        pool = WorkerPool(args.package, plane=args.plane,
                          worker_args=worker_args,
                          run_dir=args.run_dir,
                          ready_timeout_s=args.ready_timeout_s)
    except (OSError, ValueError) as exc:
        print(f"fleet: cannot use {args.package!r}: {exc}",
              file=sys.stderr)
        return 2
    autoscaler = None
    router = None
    prev_sigterm = None
    try:
        for _ in range(args.workers):
            pool.spawn()
        if not pool.wait_all_ready():
            print("fleet: workers never became ready (see "
                  f"{pool.run_dir}/worker_w*.log)", file=sys.stderr)
            return 1
        pool.start_probes()
        router = FleetRouter(pool, port=args.port,
                             max_retries=args.max_retries)
        router.attach_rollout(RollingUpdate(pool))
        port = router.start()
        if args.autoscale:
            autoscaler = Autoscaler(
                pool,
                min_workers=args.min_workers or args.workers,
                max_workers=args.max_workers or 2 * args.workers,
                queue_high=args.queue_high,
                queue_metric="znicz_generate_queue_depth"
                if args.plane == "generate"
                else "znicz_serve_queue_depth",
                cooldown_s=args.cooldown_s,
                idle_down_s=args.idle_down_s)
            autoscaler.start()
        if args.smoke_test:
            ok = _smoke(router, args.plane)
            print(json.dumps({"smoke": "ok" if ok else "bad",
                              "port": port,
                              "router": router.snapshot()}))
            return 0 if ok else 1
        done = threading.Event()
        # the benign handler stays installed THROUGH the drain (which
        # runs in the finally below): restoring the default first
        # would let a second SIGTERM kill the fleet process mid-drain
        # and orphan the still-draining worker subprocesses — the same
        # double-signal bug the serve/generate CLIs guard against
        prev_sigterm = signal.signal(signal.SIGTERM,
                                     lambda *a: done.set())
        try:
            done.wait()
        except KeyboardInterrupt:
            pass
        print("fleet: draining...")
        return 0
    finally:
        if autoscaler is not None:
            autoscaler.stop()
        if router is not None:
            router.stop()
        pool.stop()
        if prev_sigterm is not None:
            signal.signal(signal.SIGTERM, prev_sigterm)
