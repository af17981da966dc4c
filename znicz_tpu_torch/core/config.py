"""Attribute-tree configuration, the rebuild of veles/config.py :: Config and
root.

The reference exposes a process-global ``root`` attribute tree; config files
are plain Python that mutates subtrees (``root.mnist.loader.minibatch_size =
60``). Layering is by execution order: package defaults, then the workflow's
``*_config.py``, then CLI ``root.path=value`` overrides.  We keep that model
exactly — it is the API every sample workflow consumes — and add ``Tune``
leaves for the genetic optimizer (reference: veles/genetics/config.py :: Tune).
"""

from __future__ import annotations

import os
import runpy
from typing import Any, Iterator


class Config:
    """A node in the attribute tree.  Reading a missing attribute creates a
    child node (so config files can write deep paths without boilerplate);
    ``update()`` merges nested dicts; ``__bool__`` is False for empty nodes so
    code can test ``if root.workflow.something:`` safely.
    """

    def __init__(self, path: str = "root", **kwargs: Any) -> None:
        object.__setattr__(self, "_path", path)
        object.__setattr__(self, "_children", {})
        self.update(kwargs)

    # -- attribute protocol -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        children = object.__getattribute__(self, "_children")
        if name not in children:
            children[name] = Config(f"{self._path}.{name}")
        return children[name]

    def __setattr__(self, name: str, value: Any) -> None:
        if name.startswith("_"):
            object.__setattr__(self, name, value)
            return
        if isinstance(value, dict):
            node = Config(f"{self._path}.{name}")
            node.update(value)
            value = node
        object.__getattribute__(self, "_children")[name] = value

    def __delattr__(self, name: str) -> None:
        object.__getattribute__(self, "_children").pop(name, None)

    # -- mapping-ish helpers ------------------------------------------------
    def __contains__(self, name: str) -> bool:
        child = object.__getattribute__(self, "_children").get(name)
        return child is not None and not (isinstance(child, Config) and not child)

    def __bool__(self) -> bool:
        return bool(object.__getattribute__(self, "_children"))

    def __iter__(self) -> Iterator[str]:
        return iter(object.__getattribute__(self, "_children"))

    def items(self):
        return object.__getattribute__(self, "_children").items()

    def get(self, name: str, default: Any = None) -> Any:
        """Return a *leaf* value or ``default`` (missing or empty subtree)."""
        child = object.__getattribute__(self, "_children").get(name)
        if child is None or (isinstance(child, Config) and not child):
            return default
        return child

    def update(self, tree: dict | "Config") -> "Config":
        items = tree.items() if isinstance(tree, (dict, Config)) else tree
        for key, value in items:
            if isinstance(value, (dict, Config)):
                node = getattr(self, key)
                if not isinstance(node, Config):
                    node = Config(f"{self._path}.{key}")
                    object.__getattribute__(self, "_children")[key] = node
                node.update(value if isinstance(value, dict) else dict(value.items()))
            else:
                setattr(self, key, value)
        return self

    def as_dict(self) -> dict:
        out = {}
        for key, value in self.items():
            out[key] = value.as_dict() if isinstance(value, Config) else value
        return out

    def __repr__(self) -> str:
        return f"Config({self._path}: {self.as_dict()!r})"


class Tune:
    """A tunable config leaf: ``Tune(default, min, max)``.

    The genetic optimizer (znicz_tpu.utils.genetics) searches the inclusive
    range; outside an optimization run ``fix_config`` collapses each Tune to
    its default value.  Reference: veles/genetics/config.py :: Tune.
    """

    def __init__(self, default: Any, minv: Any, maxv: Any) -> None:
        self.default = default
        self.min = minv
        self.max = maxv

    def __repr__(self) -> str:
        return f"Tune({self.default}, {self.min}, {self.max})"


def fix_config(node: Config) -> None:
    """Collapse every Tune leaf under ``node`` to its default value."""
    for key, value in list(node.items()):
        if isinstance(value, Config):
            fix_config(value)
        elif isinstance(value, Tune):
            setattr(node, key, value.default)


def walk_tunes(node: Config, prefix: str = ""):
    """Yield ``(dotted_path, Tune)`` for every Tune leaf under ``node``."""
    for key, value in node.items():
        path = f"{prefix}{key}"
        if isinstance(value, Config):
            yield from walk_tunes(value, path + ".")
        elif isinstance(value, Tune):
            yield path, value


def get_by_path(node: Config, dotted: str) -> Any:
    for part in dotted.split("."):
        node = getattr(node, part)
    return node


def set_by_path(node: Config, dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    for part in parts[:-1]:
        node = getattr(node, part)
    setattr(node, parts[-1], value)


def apply_config_file(path: str) -> None:
    """Execute a Python config file with ``root`` in scope (reference
    semantics: config files are executed Python mutating the global tree)."""
    runpy.run_path(path, init_globals={"root": root})


#: process-global configuration tree (reference: veles/config.py :: root)
root = Config()

#: run-time data lives under the checkout that holds this package
_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), ".data")

# package defaults (reference: root.common.*)
root.common.update({
    "engine": {
        # "tpu" | "numpy" | "auto" — device_type selection, the rebuild of
        # root.common.engine.backend (numpy/ocl/cuda) from the reference.
        "backend": "auto",
        # matmul precision policy on TPU: "bfloat16" keeps MXU throughput,
        # "highest" forces f32 accumulation everywhere (test oracle).
        "precision": "bfloat16",
    },
    "dirs": {
        "datasets": os.path.join(_DATA, "datasets"),
        "snapshots": os.path.join(_DATA, "snapshots"),
        "cache": os.path.join(_DATA, "cache"),
    },
    "trace": {"enabled": False, "dir": os.path.join(_DATA, "trace")},
})
