"""CLI entry of the port — the ``python -m znicz_tpu_torch <workflow.py>
[config.py ...]`` contract of ``znicz_tpu/__main__.py`` (rebuild of
veles/__main__.py :: Main).

Usage:
    python -m znicz_tpu_torch <workflow.py> [config.py ...] [-d DEVICE]
                              [-w snapshot.npz] [-o root.path=value]
                              [--random-seed N] [--trace OUT.json]
    python -m znicz_tpu_torch generate <lm_package.npz> [--prompt TEXT |
                              --serve --port N --slots B]
                              [--device cpu] [options]
    python -m znicz_tpu_torch serve <package.npz> [--port N]
                              [--max-batch N] [--native] [--device cpu]
                              [--smoke-test] [options]
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

``elastic`` supervises N workers of this CLI (``resilience/
elastic.py``); a worker finds ``$ZNICZ_TPU_HEARTBEAT`` (the heartbeat
starts before the ``--coordinator`` join) and
``$ZNICZ_TPU_METRICS_EXPORT`` (a rank-tagged registry snapshot file,
``observe/federation.py``) in its env.  ``flight`` pretty-prints a
flight-recorder artifact; ``trace`` runs a workflow and exports its span
timeline, or with ``--fleet`` merges exported timelines.

The parser takes every flag of the reference, so a reference command
line parses.  What is not ported yet raises ``NotImplementedError``
naming its ROADMAP item rather than being ignored: ``--optimize``,
``--ensemble-train``, ``--manhole``, ``--publish`` and the subcommands
``fleet``, ``learn`` and ``forge`` (item 14).  ``aot`` has no
counterpart: the port has no XLA executables to compile ahead of time
(a recorded divergence).

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

#: subcommands not ported yet -> their ROADMAP queue A item
_UNPORTED_SUBCOMMANDS = {"fleet": "14", "learn": "14", "forge": "14"}
#: flags not ported yet -> (what, item); each raises when given
_UNPORTED_FLAGS = {
    "optimize": ("the genetic hyperparameter search (--optimize)", "14"),
    "ensemble_train": ("ensemble training (--ensemble-train)", "14"),
    "manhole": ("the manhole (--manhole)", "14"),
    "publish": ("the post-training report (--publish)", "14")}


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md queue "
                               f"A item {item})")


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
                   help="not ported yet (item 14)")
    p.add_argument("--ensemble-train", type=int, default=None,
                   metavar="N", help="not ported yet (item 14)")
    p.add_argument("--manhole", nargs="?", const="", default=None,
                   metavar="PATH", help="not ported yet (item 14)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the run "
                        "under DIR and log its top ops")
    p.add_argument("--trace", default=None, metavar="OUT_JSON",
                   help="export the observe-plane span timeline as "
                        "Chrome-trace JSON after the run")
    p.add_argument("--publish", default=None, metavar="BACKEND",
                   choices=("markdown", "html"),
                   help="not ported yet (item 14)")
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


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv:
        print(__doc__.strip(), file=sys.stderr)
        return 2
    if argv[0] in _UNPORTED_SUBCOMMANDS:
        raise _not_ported(f"the {argv[0]!r} subcommand",
                          _UNPORTED_SUBCOMMANDS[argv[0]])
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
    for flag, (what, item) in _UNPORTED_FLAGS.items():
        if getattr(args, flag) is not None:
            raise _not_ported(what, item)
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
    launcher = Launcher(device=make_device(args.device),
                        snapshot=args.snapshot, stealth=args.stealth,
                        profile_dir=args.profile)
    hb_box["launcher"] = launcher     # the heartbeat reports progress now
    module.run(launcher.load, launcher.main)
    if args.trace is not None:
        from znicz_tpu_torch.observe.trace import export_trace

        n = export_trace(args.trace)
        print(f"trace: wrote {n} events -> {args.trace}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
