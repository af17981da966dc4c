"""znicz_tpu_torch — the PyTorch/CUDA port of ``znicz_tpu``.

The JAX package stays the reference; this package mirrors its module
paths (``serve/paged.py`` here is ``znicz_tpu/serve/paged.py`` there) and
ports it slice by slice.  It imports ``torch`` and never ``jax`` or any
``znicz_tpu`` module: framework-free modules it needs are kept as copies.

Every TPU kernel on a ported path becomes a hand-written Hopper kernel
under ``csrc/`` with a wrapper, a plain PyTorch twin and a launch
counter in ``kernels/``.  Entry points run on ``cuda`` unless the caller
asks for the CPU; there is no silent CPU fallback.

Ported so far: generative serving through the paged KV arena
(``python -m znicz_tpu_torch generate <lm.npz> --serve``).
"""
