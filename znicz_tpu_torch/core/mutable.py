"""Mutable gate booleans and linkable attributes — rebuild of veles/mutable.py.

``Bool`` is a shared, lazily-evaluated boolean cell used for control-graph
gates (``gate_block``, ``gate_skip``): many units can hold the *same* Bool
object, and composite expressions (``a & ~b``) re-evaluate their operands at
read time, so flipping ``decision.complete`` instantly opens/closes every
gate built from it.  Reference: veles/mutable.py :: Bool.

``LinkableAttribute`` implements the data-link side (``link_attrs``):
attribute aliasing so consumer.attr *is* provider.attr — reads always see the
provider's current value, writes (when two_way) propagate back.  Reference:
veles/mutable.py :: LinkableAttribute.
"""

from __future__ import annotations

from typing import Any, Callable


class Bool:
    """Shared mutable boolean with lazy composite expressions."""

    def __init__(self, value: bool | Callable[[], bool] = False) -> None:
        if callable(value):
            self._expr: Callable[[], bool] | None = value
            self._value = False
        else:
            self._expr = None
            self._value = bool(value)

    def __bool__(self) -> bool:
        if self._expr is not None:
            return bool(self._expr())
        return self._value

    def __ilshift__(self, value: Any) -> "Bool":
        """``b <<= True`` — the reference's assignment operator."""
        self.set(value)
        return self

    def set(self, value: Any) -> None:
        if isinstance(value, Bool):
            value = bool(value)
        if self._expr is not None:
            raise ValueError("cannot assign to a composite Bool expression")
        self._value = bool(value)

    # composite expressions stay live: operands re-evaluated on read
    def __invert__(self) -> "Bool":
        return Bool(lambda: not bool(self))

    def __and__(self, other: Any) -> "Bool":
        return Bool(lambda: bool(self) and bool(other))

    def __or__(self, other: Any) -> "Bool":
        return Bool(lambda: bool(self) or bool(other))

    def __repr__(self) -> str:
        kind = "expr" if self._expr is not None else "value"
        return f"Bool({bool(self)}, {kind})"

    # pickling composite Bools would capture closures; snapshot code only
    # pickles value-Bools (expressions are rebuilt by workflow wiring).
    def __getstate__(self):
        if self._expr is not None:
            return {"_expr": None, "_value": bool(self)}
        return self.__dict__


class LinkableAttribute:
    """Descriptor-free attribute alias: installs a property-like forwarding
    on the *instance* via the owner's ``__linked__`` table (consulted by
    Unit.__getattr__/__setattr__)."""

    def __init__(self, provider: Any, attr: str, two_way: bool = True) -> None:
        self.provider = provider
        self.attr = attr
        self.two_way = two_way

    def get(self) -> Any:
        return getattr(self.provider, self.attr)

    def set(self, value: Any) -> None:
        if not self.two_way:
            raise AttributeError(
                f"one-way link to {type(self.provider).__name__}.{self.attr}")
        setattr(self.provider, self.attr, value)
