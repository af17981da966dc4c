"""Fleet-federation helpers — the part of
``znicz_tpu/observe/federation.py`` the serving slice uses: request-id
minting, the per-request trace track, and the fleet rank the tracer
stamps on its export.  The cross-process aggregator comes with a later
slice of the port.
"""

from __future__ import annotations

import itertools
import os
import zlib
from typing import Optional


def fleet_rank() -> Optional[int]:
    """This process's fleet rank, or None outside a fleet
    (``ZNICZ_TPU_ELASTIC_RANK``, the elastic supervisor's env contract)."""
    rank = os.environ.get("ZNICZ_TPU_ELASTIC_RANK")
    if rank is None:
        return None
    try:
        return int(rank)
    except ValueError:
        return None


#: rolling id for requests minted at HTTP admission — combined with the
#: pid so ids stay unique across a worker fleet without coordination
_RID_SEQ = itertools.count(1)


def next_request_id() -> str:
    """Mint one request id (``<pid hex>-<seq hex>``) — the distributed
    tracing correlation key threaded HTTP admission -> batcher ->
    decode phases (serve/server.py)."""
    return f"{os.getpid():x}-{next(_RID_SEQ):x}"


def request_track(rid: str) -> int:
    """Deterministic synthetic trace track (Chrome-trace ``tid``) for
    one request: every phase span of a request shares a row in
    Perfetto instead of overlapping arbitrarily on the worker threads
    that happened to run it."""
    return 0x40000000 | zlib.crc32(rid.encode())
