"""CLI entry of the port — the ``python -m znicz_tpu_torch <workflow.py>
[config.py ...]`` contract of ``znicz_tpu/__main__.py`` (rebuild of
veles/__main__.py :: Main).

Usage:
    python -m znicz_tpu_torch <workflow.py> [config.py ...] [-d DEVICE]
                              [-w snapshot.npz] [-o root.path=value]
                              [--random-seed N] [--trace OUT.json]
                              [--optimize GENS | --ensemble-train N]
                              [--manhole[=PATH]] [--publish BACKEND]
    python -m znicz_tpu_torch forge [--registry DIR] {list,upload,fetch} ...
    python -m znicz_tpu_torch generate <lm_package.npz> [--prompt TEXT |
                              --serve --port N --slots B]
                              [--device cpu] [options]
    python -m znicz_tpu_torch serve <package.npz> [--port N]
                              [--max-batch N] [--native] [--device cpu]
                              [--smoke-test] [options]
    python -m znicz_tpu_torch fleet <package.npz> [--workers N --port P
                              --autoscale] [-- worker flags ...]
    python -m znicz_tpu_torch learn <lm_package.npz> [--workers N --port P
                              --publish-every K] [--device cpu]
                              [-- worker flags ...]
    python -m znicz_tpu_torch elastic --workers N --snap-dir D
                              <workflow.py> [worker args ...]
    python -m znicz_tpu_torch flight <artifact.json> [--json]
    python -m znicz_tpu_torch trace <out.json> <workflow.py> [cfg ...]
                              [options]
    python -m znicz_tpu_torch trace --fleet -o out.json SRC [SRC ...]

The workflow file must expose ``run(load, main)`` (every ``models/``
sample does); config files are executed Python mutating the global
``root`` tree; ``-o root.path=value`` applies last; ``-w`` resumes from
a snapshot (``snapshotter.py``: the reference's format, so a snapshot of
either package resumes here).  ``-d`` takes ``auto`` (the default:
cuda), ``cuda``, ``cpu`` and ``numpy``; there is no quiet CPU fallback.
``--profile DIR`` writes a ``torch.profiler`` Chrome trace of the run
under DIR (``launcher.py``).

``--optimize GENS`` runs the genetic search over the ``Tune`` leaves in
``root`` (``utils/genetics.py``): a fused StandardWorkflow whose Tunes
move only hyperparameters trains each generation's individuals one
after another through one fused step (on the card, replays of one
captured graph; the printed best config keeps the reference's
``'_evaluator': 'vmapped'`` label for it), anything else by full
sequential runs (``'sequential'``).  ``--ensemble-train N`` trains N
members seeded ``--random-seed`` + i and writes
``ensemble_<workflow>.json`` (``utils/ensemble.py``).  ``--manhole``
serves a REPL into the running workflow on a 0600 UNIX socket
(``utils/manhole.py``; ``--manhole=PATH`` names it).  ``--publish
{markdown,html}`` writes a report of the run (``utils/publishing.py``),
naming the device and the torch and CUDA versions.  They refuse the
reference's combinations with exit code 2.  ``forge`` is the
reference's ``veles forge`` pair over a local registry of forward
packages (``utils/forge.py``): ``upload``, ``list`` and ``fetch``; a
registry failure is a one-line ``forge: ...`` error and exit code 2.

``fleet`` fronts N ``generate --serve`` (or ``serve``) workers of this
CLI with a router, rolling updates and an optional autoscaler
(``fleet/``); the device travels in the worker flags (``-- --device
cpu``).  ``learn`` adds the feedback spool, a spool-fed trainer under
the elastic supervisor and the adoption bridge (``learn/``); its
``--device`` reaches the trainer and the workers.  ``elastic``
supervises N workers of this CLI (``resilience/elastic.py``); a worker
finds ``$ZNICZ_TPU_HEARTBEAT`` (the heartbeat starts before the
``--coordinator`` join) and
``$ZNICZ_TPU_METRICS_EXPORT`` (a rank-tagged registry snapshot file,
``observe/federation.py``) in its env.  ``flight`` pretty-prints a
flight-recorder artifact; ``trace`` runs a workflow and exports its span
timeline, or with ``--fleet`` merges exported timelines.

The parser takes every flag of the reference, so a reference command
line parses, and every flag and subcommand of the reference runs but
``aot``, which has no counterpart: the port has no XLA executables to
compile ahead of time (a recorded divergence; it exits 2).

``--coordinator host:port --num-processes N --process-id R`` joins a
data-parallel world before the workflow is built
(``launcher.multihost``: NCCL on the card, gloo with ``-d cpu``); a
fused step's default mesh is then the whole world.  Every process runs
the same command line but for its ``--process-id``.
"""

from __future__ import annotations

import argparse
import ast
import importlib.util
import os
import sys

def load_workflow_module(path: str):
    spec = importlib.util.spec_from_file_location("znicz_workflow", path)
    if spec is None:
        raise SystemExit(f"cannot import workflow file {path!r}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    if not hasattr(module, "run"):
        raise SystemExit(f"{path!r} does not expose run(load, main)")
    return module


def _parse_value(text: str):
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def apply_site_config() -> str | None:
    """Config layering: package defaults -> SITE config -> workflow
    config files -> CLI overrides.  The site layer is
    ``$ZNICZ_TPU_SITE_CONFIG`` when set (empty string disables the
    layer; a missing file is an error), else
    ``~/.config/znicz_tpu/site_config.py`` when present.  Returns the
    applied path."""
    from znicz_tpu_torch.core.config import apply_config_file

    env = os.environ.get("ZNICZ_TPU_SITE_CONFIG")
    if env is not None:
        if env == "":
            return None                       # layer explicitly disabled
        if not os.path.isfile(env):
            raise SystemExit(f"ZNICZ_TPU_SITE_CONFIG={env!r} does not "
                             f"exist")
        apply_config_file(env)
        return env
    path = os.path.expanduser("~/.config/znicz_tpu/site_config.py")
    if not os.path.isfile(path):
        return None
    apply_config_file(path)
    return path


def build_parser() -> argparse.ArgumentParser:
    """The reference's parser, with the port's device choices."""
    p = argparse.ArgumentParser(
        prog="znicz_tpu_torch",
        description="the PyTorch/CUDA port of znicz_tpu: run a workflow "
                    "file")
    p.add_argument("workflow", help="workflow .py exposing run(load, main)")
    p.add_argument("configs", nargs="*", help="config .py files (executed "
                   "in order, mutating the global root tree)")
    p.add_argument("-d", "--device", choices=("auto", "cuda", "cpu",
                                              "numpy"),
                   default="auto", help="auto (the default) and cuda run "
                   "on the card and raise without one; cpu and numpy only "
                   "when named")
    p.add_argument("--random-seed", type=int, default=1,
                   help="seed for all PRNG streams (reference --random-seed)")
    p.add_argument("-w", "--snapshot", default=None,
                   help="resume from a .npz snapshot (reference -w)")
    p.add_argument("-s", "--stealth", action="store_true",
                   help="accepted for reference command lines; the port "
                   "has no plotters or side services to suppress")
    p.add_argument("-o", "--override", action="append", default=[],
                   metavar="root.path=value",
                   help="config override, applied after config files")
    p.add_argument("--optimize", type=int, default=None, metavar="GENS",
                   help="genetic hyperparameter search over Tune() leaves")
    p.add_argument("--ensemble-train", type=int, default=None,
                   metavar="N", help="train N seeded members of the "
                   "workflow and write an ensemble summary JSON "
                   "(reference: --ensemble-train)")
    p.add_argument("--manhole", nargs="?", const="", default=None,
                   metavar="PATH",
                   help="serve a live REPL into the running workflow on a "
                        "0600-permission UNIX socket (connect with nc -U). "
                        "Bare --manhole auto-creates a private path; to "
                        "pick one, use the --manhole=PATH form (the "
                        "space-separated form would swallow the workflow "
                        "argument)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the run "
                        "under DIR and log its top ops")
    p.add_argument("--trace", default=None, metavar="OUT_JSON",
                   help="export the observe-plane span timeline as "
                        "Chrome-trace JSON after the run")
    p.add_argument("--publish", default=None, metavar="BACKEND",
                   choices=("markdown", "html"),
                   help="write a post-training report (reference: "
                        "veles/publishing)")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="join a data-parallel world whose rank 0 listens "
                        "here (with --num-processes and --process-id)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    return p


def make_device(name: str):
    from znicz_tpu_torch.core.backends import (AutoDevice, NumpyDevice,
                                               TorchDevice)

    if name == "auto":
        return AutoDevice()
    if name == "numpy":
        return NumpyDevice()
    return TorchDevice(name)


def forge_main(argv) -> int:
    """``forge list|upload|fetch`` — the reference's model-zoo up/download
    CLI (veles forge ...) over the local registry."""
    from znicz_tpu_torch.utils.forge import ForgeRegistry

    p = argparse.ArgumentParser(prog="znicz_tpu_torch forge",
                                description="model-zoo package registry")
    p.add_argument("--registry", default=None,
                   help="registry directory (default: root.common.forge."
                        "dir or ./.forge)")
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list", help="list packages and versions")
    up = sub.add_parser("upload", help="register a forward package")
    up.add_argument("package", help="path to a utils/export.py .npz")
    up.add_argument("--name", required=True)
    up.add_argument("--version", required=True)
    fe = sub.add_parser("fetch", help="resolve + checksum-verify a package")
    fe.add_argument("name")
    fe.add_argument("--version", default=None,
                    help="semantic latest when omitted")
    fe.add_argument("-o", "--output", default=None,
                    help="copy to this path (default: print the "
                         "in-registry path)")
    args = p.parse_args(argv)
    reg = ForgeRegistry(registry_dir=args.registry)
    try:
        if args.cmd == "list":
            for name, versions in sorted(reg.list_packages().items()):
                print(f"{name}: {', '.join(versions)}")
            return 0
        if args.cmd == "upload":
            entry = reg.upload(args.package, args.name, args.version)
            print(f"uploaded {args.name}=={args.version} "
                  f"(sha256 {entry['sha256'][:12]})")
            return 0
        path = reg.fetch(args.name, version=args.version, dest=args.output)
        print(path)
        return 0
    except (KeyError, OSError, FileExistsError) as exc:
        # unknown package/version, missing file, corrupt checksum,
        # immutable re-upload — one-line error, CLI convention.  str()
        # renders OS errors with filename+strerror (args[0] is errno)
        msg = (exc.args[0] if isinstance(exc, KeyError) and exc.args
               else str(exc))
        print(f"forge: {msg}", file=sys.stderr)
        return 2


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv:
        print(__doc__.strip(), file=sys.stderr)
        return 2
    if argv[0] == "fleet":
        # the serving fleet: router + worker pool + SLO autoscaler +
        # rolling weight updates over ordinary generate/serve workers
        from znicz_tpu_torch.fleet.cli import fleet_main

        return fleet_main(argv[1:])
    if argv[0] == "learn":
        # train-while-serve: serving fleet + spool-fed trainer under the
        # elastic supervisor + adoption bridge
        from znicz_tpu_torch.learn.cli import learn_main

        return learn_main(argv[1:])
    if argv[0] == "elastic":
        # the multi-process fleet supervisor: spawns N of this CLI as
        # workers — dispatched before the env hooks below, which are
        # worker-side only
        from znicz_tpu_torch.resilience.elastic import elastic_main

        return elastic_main(argv[1:])
    # cross-process chaos: a drill serializes its seeded fault plan into
    # the worker env ($ZNICZ_TPU_FAULT_PLAN); no env var = one lookup
    from znicz_tpu_torch.resilience import faults

    faults.install_from_env()
    # fleet metric federation: an elastic supervisor asks its workers to
    # publish rank-tagged registry snapshots beside the heartbeat files;
    # the exporter covers every subcommand's registry.  No env = nothing.
    mx_path = os.environ.get("ZNICZ_TPU_METRICS_EXPORT")
    if mx_path:
        from znicz_tpu_torch.observe.federation import start_metrics_export

        start_metrics_export(mx_path, interval_s=float(os.environ.get(
            "ZNICZ_TPU_METRICS_EXPORT_INTERVAL", "1.0")))
    if argv[0] == "forge":
        site = apply_site_config()            # site may set the forge dir
        if site:
            print(f"applied site config {site}", file=sys.stderr)
        return forge_main(argv[1:])
    if argv[0] == "flight":
        # the flight-recorder post-mortem viewer
        from znicz_tpu_torch.observe import flight

        return flight.flight_main(argv[1:])
    if argv[0] == "trace":
        if "--fleet" in argv:
            # align N workers' exported timelines (or live /trace.json
            # endpoints) onto one clock
            from znicz_tpu_torch.observe.federation import fleet_trace_main

            return fleet_trace_main([a for a in argv[1:] if a != "--fleet"])
        # shorthand: run the workflow, export its span timeline
        if len(argv) < 3:
            print("usage: znicz_tpu_torch trace <out.json> <workflow.py> "
                  "[config.py ...] [options] | znicz_tpu_torch trace "
                  "--fleet -o out.json SRC [SRC ...]", file=sys.stderr)
            return 2
        return main(list(argv[2:]) + ["--trace", argv[1]])
    if argv[0] == "generate":
        from znicz_tpu_torch.serve.server import generate_main

        return generate_main(argv[1:])
    if argv[0] == "serve":
        from znicz_tpu_torch.serve.server import serve_main

        return serve_main(argv[1:])
    if argv[0] == "aot":
        print("znicz_tpu_torch: 'aot' has no counterpart in the port (no "
              "XLA executables to compile ahead of time)", file=sys.stderr)
        return 2
    args = build_parser().parse_args(argv)
    # elastic-fleet liveness: the beat starts BEFORE the --coordinator
    # join (torch import + the rendezvous can outlast a heartbeat
    # timeout, and a silent boot window would read as a wedged process);
    # its progress source is patched in once the launcher exists, until
    # then it carries -1 ("process alive, no workflow yet")
    hb_box: dict = {"launcher": None}
    hb_path = os.environ.get("ZNICZ_TPU_HEARTBEAT")
    if hb_path:
        from znicz_tpu_torch.resilience.elastic import start_heartbeat

        def hb_progress():
            launcher = hb_box["launcher"]
            if launcher is None or launcher.workflow is None:
                return -1
            return getattr(launcher.workflow, "signals_dispatched", -1)

        start_heartbeat(hb_path, interval=float(os.environ.get(
            "ZNICZ_TPU_HEARTBEAT_INTERVAL", "0.25")), progress=hb_progress)
    if args.coordinator is None:
        return _run_workflow(args, hb_box)
    if args.num_processes is None or args.process_id is None:
        raise SystemExit("--coordinator needs --num-processes and "
                         "--process-id")
    import torch.distributed as dist

    from znicz_tpu_torch.launcher import multihost

    multihost(args.coordinator, args.num_processes, args.process_id,
              device=args.device)
    try:
        return _run_workflow(args, hb_box)
    finally:
        dist.destroy_process_group()


def _run_workflow(args, hb_box: dict) -> int:
    """Seed, configure, load the workflow file and run it."""
    from znicz_tpu_torch.core import prng
    from znicz_tpu_torch.core.config import (apply_config_file, root,
                                             set_by_path)
    from znicz_tpu_torch.launcher import Launcher

    prng.seed_all(args.random_seed)
    site = apply_site_config()
    if site:
        print(f"applied site config {site}", file=sys.stderr)
    for cfg in args.configs:
        apply_config_file(cfg)
    for override in args.override:
        path, _, value = override.partition("=")
        path = path.removeprefix("root.")
        set_by_path(root, path, _parse_value(value))
    module = load_workflow_module(args.workflow)
    if args.ensemble_train is not None:
        import json

        if args.ensemble_train <= 0:
            print("--ensemble-train needs N >= 1", file=sys.stderr)
            return 2
        if args.publish or args.snapshot or args.profile or \
                args.optimize is not None or args.manhole is not None:
            print("--ensemble-train cannot be combined with --publish/"
                  "-w/--profile/--optimize/--manhole (members are "
                  "independent runs)", file=sys.stderr)
            return 2
        from znicz_tpu_torch.utils.ensemble import train_members_from_module
        from znicz_tpu_torch.utils.naming import slugify

        summary = train_members_from_module(
            module, args.ensemble_train, args.random_seed,
            lambda: Launcher(device=make_device(args.device),
                             stealth=args.stealth))
        out = f"ensemble_{slugify(summary['workflow'])}.json"
        with open(out, "w") as f:
            json.dump(summary, f, indent=1)
        print(f"ensemble summary -> {out}")
        return 0
    launcher = Launcher(device=make_device(args.device),
                        snapshot=args.snapshot, stealth=args.stealth,
                        profile_dir=args.profile,
                        manhole_path=args.manhole)
    hb_box["launcher"] = launcher     # the heartbeat reports progress now
    if args.optimize is not None:
        if args.publish is not None:
            print("--publish cannot be combined with --optimize "
                  "(GA evaluation runs are throwaway)", file=sys.stderr)
            return 2
        if args.manhole is not None:
            print("--manhole cannot be combined with --optimize "
                  "(GA evaluation runs bypass Launcher.main)",
                  file=sys.stderr)
            return 2
        from znicz_tpu_torch.utils.genetics import optimize

        best = optimize(module, launcher, generations=args.optimize)
        print(f"best config: {best}")
        return 0
    module.run(launcher.load, launcher.main)
    if args.trace is not None:
        from znicz_tpu_torch.observe.trace import export_trace

        n = export_trace(args.trace)
        print(f"trace: wrote {n} events -> {args.trace}")
    if args.publish is not None and launcher.workflow is not None:
        from znicz_tpu_torch.utils.publishing import Publisher

        Publisher(backend=args.publish).publish(launcher.workflow)
    return 0


if __name__ == "__main__":
    sys.exit(main())
