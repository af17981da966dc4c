"""Flight-recorder plane registry — the part of
``znicz_tpu/observe/flight.py`` the serving slice uses.

Live subsystems register zero-arg snapshot providers here (the
continuous batcher registers its admission ledger); the artifact
writer that embeds them into crash post-mortems comes with a later
slice of the port.
"""

from __future__ import annotations

#: name -> zero-arg callable returning a JSON-able dict.  Newest
#: registration per name wins (the registry-gauge convention).
_planes: dict = {}


def register_plane(name: str, fn) -> None:
    _planes[str(name)] = fn


def unregister_plane(name: str, fn=None) -> None:
    """Remove a provider — with ``fn`` given, only if it is still the
    registered one (a torn-down batcher must not evict its
    replacement)."""
    if fn is None or _planes.get(str(name)) is fn:
        _planes.pop(str(name), None)


def planes() -> dict:
    """Snapshot of every registered provider's current document."""
    return {name: fn() for name, fn in list(_planes.items())}
