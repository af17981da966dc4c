"""CLI entry of the port.

Usage:
    python -m znicz_tpu_torch generate <lm_package.npz> [--prompt TEXT |
                                  --serve --port N --slots B]
                                  [--device cpu] [options]

Only the ``generate`` subcommand is ported so far; the reference's
other subcommands (``python -m znicz_tpu``) come with later slices.
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] != "generate":
        print(__doc__.strip(), file=sys.stderr)
        return 2
    # cross-process chaos: a drill serializes its seeded fault plan into
    # the worker env ($ZNICZ_TPU_FAULT_PLAN); no env var = one lookup
    from znicz_tpu_torch.resilience import faults

    faults.install_from_env()
    from znicz_tpu_torch.serve.server import generate_main

    return generate_main(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
