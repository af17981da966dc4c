"""Shape policy of the serving plane — the part of
``znicz_tpu/serve/engine.py`` the generative slice uses.

Every cache, prompt and page-view width is padded up to one of a small
set of power-of-two buckets, so the set of shapes the device sees stays
bounded and enumerable (``warmup`` walks it once).  The batch engine of
the forward-package plane comes with a later slice of the port.
"""

from __future__ import annotations


def bucket_sizes(max_batch: int) -> tuple:
    """Powers of two up to ``max_batch``; ``max_batch`` itself is always
    the final bucket so one shape covers the full admission range."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    sizes = []
    b = 1
    while b < max_batch:
        sizes.append(b)
        b *= 2
    sizes.append(max_batch)
    return tuple(sizes)
