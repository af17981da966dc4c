"""Dropout mask op — the port of ``znicz_tpu/ops/dropout.py``.  One
definition shared by every path (numpy oracle, eager torch) so the mask
semantics cannot diverge.
"""

from __future__ import annotations

import numpy as np


def make_mask(xp, u, ratio: float, dtype):
    """Bernoulli keep-mask from uniforms ``u`` in [0,1): kept entries hold
    ``1/(1-ratio)`` (inverted-dropout scale, reference semantics), dropped
    entries 0."""
    keep = 1.0 - ratio
    kept = u >= ratio
    return (kept.astype(dtype) if xp is np else kept.to(dtype)) / keep
