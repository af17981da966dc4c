"""``python -m znicz_tpu_torch learn`` — the train-while-serve loop in
one command; the port of ``znicz_tpu/learn/cli.py``.

::

    python -m znicz_tpu_torch learn lm.npz --workers 2 --port 8080 \\
        --publish-every 2 --max-epochs 4 [--device cpu] \\
        -- --slots 2 --max-len 64

Assembles, in one process tree:

- a serving fleet (router + N ``generate --serve`` workers
  booted from ``lm.npz``), each worker appending accepted traffic to
  the shared feedback spool (``--feedback-spool``);
- ONE trainer process under the elastic supervisor
  (``resilience/elastic.py``, world size 1) running
  ``learn/trainer_workflow.py`` over the spool — crash/kill of the
  trainer resumes from its newest snapshot with a bit-exact cursor;
- the adoption bridge: every package the trainer publishes rolls onto
  the fleet through the zero-downtime ``RollingUpdate``.

``GET /fleet/status.json`` on the router carries the whole loop's
state: top-level ``package`` (fleet fingerprint + convergence),
``rollout``, and ``learn`` (manifest + adoption latency).  SIGTERM
drains the fleet and stops the trainer at its next poll.  Everything
after a literal ``--`` passes to the worker CLI verbatim.

``--device`` (``cuda``, the default, or ``cpu``) is the port's own flag:
the reference's trainer finds its device through jax, the port's CLIs
run on the card unless told otherwise.  It reaches the trainer's
command line as ``-d`` and every worker's as ``--device`` (ahead of the
pass-through, so a worker flag given after ``--`` wins); without a card
and without ``--device cpu`` the command exits 2 before it starts
anything.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading


def build_learn_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="znicz_tpu_torch learn",
        description="continuous learning on live traffic: serving "
                    "fleet + spool-fed trainer + adoption bridge")
    p.add_argument("package", help="base LM package (utils/export.py "
                                   "export_lm) the fleet serves and "
                                   "the trainer continues from")
    p.add_argument("--workers", type=int, default=2,
                   help="serving worker count")
    p.add_argument("--port", type=int, default=8080,
                   help="router listen port (0 picks a free one)")
    p.add_argument("--run-dir", default=None,
                   help="spool/publish/snapshots/logs root (default: "
                        "<package dir>/learn)")
    p.add_argument("--publish-every", type=int, default=2,
                   help="trainer publishes every K epochs")
    p.add_argument("--max-epochs", type=int, default=4,
                   help="trainer epoch budget (the fleet keeps serving "
                        "after it completes)")
    p.add_argument("--records-per-epoch", type=int, default=8,
                   help="spool records one training epoch consumes")
    p.add_argument("--seq-len", type=int, default=16,
                   help="training window length")
    p.add_argument("--minibatch", type=int, default=8)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--pipeline-depth", type=int, default=2,
                   help="trainer async input-pipeline depth (0 = sync)")
    p.add_argument("--max-restarts", type=int, default=3,
                   help="trainer elastic restart budget")
    p.add_argument("--ready-timeout-s", type=float, default=180.0)
    p.add_argument("--trainer-fault-plan", default=None,
                   metavar="JSON",
                   help="serialized FaultPlan armed in the ROUND-0 "
                        "trainer's env (seeded chaos drills)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the trainer and the workers run (cuda, the "
                        "default, raises without a card; cpu only when "
                        "named)")
    p.add_argument("--smoke-test", action="store_true",
                   help="drive the loop once: self-traffic until one "
                        "publish is adopted fleet-wide, print a JSON "
                        "verdict, exit (CI probe)")
    p.epilog = ("everything after a literal -- passes through to the "
                "generate worker CLI verbatim")
    return p


def _self_traffic(base: str, stop, results, lock) -> None:
    """Background self-requests through the router — the smoke's
    traffic source (and therefore the spool's).  Throttled: the spool
    only needs a trickle, and an unthrottled loop starves the
    co-resident trainer of the whole box."""
    import urllib.error
    import urllib.request

    n = 0
    while not stop.wait(0.1):
        n += 1
        # records must out-length the training window (seq_len + 1
        # ids) or they window to nothing — 2 prompt chars + 12 tokens
        # covers the smoke's --seq-len comfortably
        req = urllib.request.Request(
            base + "/generate",
            data=json.dumps({"prompt": "ab" if n % 2 else "cd",
                             "max_tokens": 12,
                             "timeout_s": 30}).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=90) as r:
                lines = [json.loads(raw) for raw in r]
            terminal = lines[-1] if lines else {}
            with lock:
                results.append(
                    "completed" if terminal.get("done") and
                    "error" not in terminal else "errored")
        except urllib.error.HTTPError as exc:
            exc.read()
            with lock:
                results.append("rejected")
        except Exception:  # noqa: BLE001 — counted, judged at the end
            with lock:
                results.append("broken")


def learn_main(argv) -> int:
    from znicz_tpu_torch.fleet.rollout import RollingUpdate
    from znicz_tpu_torch.fleet.router import FleetRouter
    from znicz_tpu_torch.fleet.workers import WorkerPool
    from znicz_tpu_torch.learn.bridge import AdoptionBridge
    from znicz_tpu_torch.resilience.elastic import run_elastic
    from znicz_tpu_torch.resilience.supervisor import SupervisorPolicy

    worker_args: list = []
    argv = list(argv)
    if "--" in argv:
        i = argv.index("--")
        argv, worker_args = argv[:i], argv[i + 1:]
    args = build_learn_parser().parse_args(argv)
    if args.workers < 1:
        print("learn: --workers must be >= 1", file=sys.stderr)
        return 2
    from znicz_tpu_torch.core.backends import device as _device

    try:
        _device(args.device)
    except RuntimeError as exc:
        print(f"learn: {exc}", file=sys.stderr)
        return 2
    run_dir = args.run_dir or os.path.join(
        os.path.dirname(os.path.abspath(args.package)) or ".", "learn")
    spool_dir = os.path.join(run_dir, "spool")
    publish_dir = os.path.join(run_dir, "publish")
    snap_dir = os.path.join(run_dir, "snaps")
    for d in (run_dir, spool_dir, publish_dir, snap_dir):
        os.makedirs(d, exist_ok=True)
    try:
        pool = WorkerPool(
            args.package, plane="generate",
            worker_args=["--device", args.device, *worker_args,
                         "--feedback-spool", spool_dir],
            run_dir=os.path.join(run_dir, "fleet"),
            ready_timeout_s=args.ready_timeout_s)
    except (OSError, ValueError) as exc:
        print(f"learn: cannot use {args.package!r}: {exc}",
              file=sys.stderr)
        return 2
    trainer_wf = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "trainer_workflow.py")
    trainer_argv = [
        trainer_wf,
        "-o", f"root.learn.spool_dir={spool_dir}",
        "-o", f"root.learn.package={os.path.abspath(args.package)}",
        "-o", f"root.learn.publish_dir={publish_dir}",
        "-o", f"root.learn.publish_every={args.publish_every}",
        "-o", f"root.learn.max_epochs={args.max_epochs}",
        "-o", f"root.learn.records_per_epoch={args.records_per_epoch}",
        "-o", f"root.learn.seq_len={args.seq_len}",
        "-o", f"root.learn.minibatch_size={args.minibatch}",
        "-o", f"root.learn.lr={args.lr}",
        "-o", f"root.learn.pipeline_depth={args.pipeline_depth}",
        "-d", args.device,
    ]
    router = bridge = None
    trainer_stop = threading.Event()
    trainer_box: dict = {"report": None, "error": None}
    prev_sigterm = None
    try:
        for _ in range(args.workers):
            pool.spawn()
        if not pool.wait_all_ready():
            print("learn: serving workers never became ready (see "
                  f"{pool.run_dir}/worker_w*.log)", file=sys.stderr)
            return 1
        pool.start_probes()
        router = FleetRouter(pool, port=args.port)
        rollout = RollingUpdate(pool)
        router.attach_rollout(rollout)
        port = router.start()
        bridge = AdoptionBridge(publish_dir, pool, rollout)
        pool.aggregator.register_status_provider("learn", bridge.status)
        bridge.start()

        def train() -> None:
            try:
                trainer_box["report"] = run_elastic(
                    trainer_argv, snap_dir, workers=1, spmd=False,
                    policy=SupervisorPolicy(
                        max_restarts=args.max_restarts),
                    run_dir=os.path.join(run_dir, "trainer"),
                    fault_plans={0: args.trainer_fault_plan}
                    if args.trainer_fault_plan else None,
                    stop_event=trainer_stop)
            except Exception as exc:  # noqa: BLE001 — surfaced below
                trainer_box["error"] = exc

        trainer = threading.Thread(target=train, daemon=True,
                                   name="znicz-learn-trainer")
        trainer.start()
        base = f"http://127.0.0.1:{port}"
        print(f"learn: fleet on {base}/ ({args.workers} workers), "
              f"trainer supervised over {spool_dir}", flush=True)
        if args.smoke_test:
            return _smoke(args, pool, router, bridge, trainer,
                          trainer_box, base)
        done = threading.Event()
        prev_sigterm = signal.signal(signal.SIGTERM,
                                     lambda *a: done.set())
        try:
            while not done.is_set():
                if trainer_box["error"] is not None:
                    print(f"learn: trainer supervision failed: "
                          f"{trainer_box['error']!r}", file=sys.stderr)
                    return 1
                done.wait(0.5)
        except KeyboardInterrupt:
            pass
        print("learn: draining...")
        return 0
    finally:
        trainer_stop.set()
        if bridge is not None:
            bridge.stop()
        if router is not None:
            router.stop()
        pool.stop()
        # the trainer thread tears its worker down via run_elastic's
        # stop_event + finally; bounded join so SIGTERM stays prompt
        t = threading.enumerate()
        for th in t:
            if th.name == "znicz-learn-trainer":
                th.join(timeout=60.0)
        if prev_sigterm is not None:
            signal.signal(signal.SIGTERM, prev_sigterm)


def _smoke(args, pool, router, bridge, trainer, trainer_box,
           base: str) -> int:
    """CI probe: self-traffic feeds the spool, the trainer publishes,
    the bridge rolls the fleet — verdict on one adopted publish."""
    import time

    from znicz_tpu_torch.utils.naming import package_fingerprint

    stop = threading.Event()
    results: list = []
    lock = threading.Lock()
    threads = [threading.Thread(target=_self_traffic,
                                args=(base, stop, results, lock),
                                daemon=True) for _ in range(2)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 600
    ok, why = False, "timeout before an adoption"
    while time.monotonic() < deadline:
        if trainer_box["error"] is not None:
            why = f"trainer failed: {trainer_box['error']!r}"
            break
        if bridge.adoptions >= 1 and not router.rollout.rolling:
            ok, why = True, ""
            break
        time.sleep(0.5)
    stop.set()
    for t in threads:
        t.join(timeout=60)
    manifest = bridge.last_manifest or {}
    converged = bool(manifest) and all(
        (w.fingerprint or {}).get("sha256") ==
        (manifest.get("fingerprint") or {}).get("sha256")
        for w in pool.workers())
    ledger = router.snapshot()
    closed = ledger["admitted"] == ledger["completed"] + \
        ledger["failed"] + ledger["client_gone"]
    with lock:
        kinds = {k: results.count(k) for k in set(results)}
    verdict = ok and converged and closed and \
        not kinds.get("broken", 0)
    print(json.dumps({
        "smoke": "ok" if verdict else "bad", "why": why,
        "adoptions": bridge.adoptions,
        "adoption_latency_s": bridge.last_adoption_s,
        "converged": converged, "ledger": ledger,
        "traffic": kinds,
        "fingerprint": (manifest.get("fingerprint") or {}).get(
            "sha256", "")[:12],
        "base_fingerprint": package_fingerprint(
            args.package)["sha256"][:12]}), flush=True)
    return 0 if verdict else 1
