"""Checkpoint/resume — the port of ``znicz_tpu/snapshotter.py``
(rebuild of veles/snapshotter.py :: SnapshotterBase, SnapshotterToFile
and veles.znicz nn_units.py :: NNSnapshotter).

A snapshot is the reference's file, byte for byte in its layout: one
``np.savez_compressed`` archive of explicit arrays plus a JSON
``__meta__`` (forwards' weights/bias, gds' momentum, the fused step's
optimizer state under ``step.opt.*``, loader position, shuffles and
normalizer, Decision counters, every host PRNG stream) with the same key
names and the same content checksum.  So a snapshot crosses between the
packages in both directions: ``restore_state(workflow, path)`` into a
freshly built workflow is the analog of ``veles -w snap.pickle.gz``.

One key is the port's own.  The fused step's NEEDS_RNG forwards draw
from a ``torch.Generator`` (the reference's from a ``jax.random`` key,
saved as ``step.key``), so the port saves that generator's state as
``step.generator`` (uint8; the reference's restore ignores it, as it
ignores every ``step.*`` key it does not know) and never reads or
writes ``step.key``.  A snapshot that carries only ``step.key`` (written
by the JAX package) restores everything else identically and keeps the
generator the step minted at initialize, with a logged warning: no
torch generator draws the key's bits.

In a data-parallel world (``launcher.multihost``) every rank collects
the state, since the fused step gathers its sharded leaves to the param
shape by collectives; rank 0 alone writes, and the other ranks verify
the published file.  Every rank restores from the same file and takes
its own slice, at any world size.

Exactness contract (pinned by tests/test_torch_port_snapshotter.py):
resume from the epoch-N snapshot and the metric history of epochs N+1..
is bit-identical to an uninterrupted run.  A restore into a step whose
bodies are already captured into CUDA graphs copies into the tensors
the graphs read, so the graphs go on replaying the restored state.
"""

from __future__ import annotations

import json
import os
import re
import time
import zlib
from typing import Optional

import numpy as np
import torch

from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.logger import Logger
from znicz_tpu_torch.core.units import Unit
from znicz_tpu_torch.resilience.faults import fault_hook
from znicz_tpu_torch.resilience.retry import DEFAULT_IO_RETRY

FORMAT_VERSION = 1


def process_rank_world() -> tuple[int, int]:
    """(rank, world) of this process in a multi-process job.

    The elastic fleet's env (``ZNICZ_TPU_ELASTIC_RANK`` /
    ``ZNICZ_TPU_ELASTIC_WORLD``, set per worker) wins; an
    already-initialized ``torch.distributed`` process group is the
    fallback (rank discovery never initializes one); the single-process
    default is ``(0, 1)``."""
    rank = os.environ.get("ZNICZ_TPU_ELASTIC_RANK")
    if rank is not None:
        return int(rank), int(os.environ.get("ZNICZ_TPU_ELASTIC_WORLD",
                                             "1"))
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() and \
            dist.get_world_size() > 1:
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class SnapshotCorruptError(ValueError):
    """Stored checksum does not match the snapshot's content — a torn or
    bit-rotted snapshot must never be silently resumed from."""


def content_checksum(arrays: dict) -> int:
    """CRC32 over the arrays' names, dtypes, shapes and bytes (sorted key
    order, so it is independent of dict insertion order)."""
    crc = 0
    for key in sorted(arrays):
        arr = np.ascontiguousarray(arrays[key])
        head = f"{key}:{arr.dtype.str}:{arr.shape}".encode()
        crc = zlib.crc32(arr.tobytes(), zlib.crc32(head, crc))
    return crc & 0xFFFFFFFF


# -- state collection -------------------------------------------------------
def _flatten_state(prefix: str, obj, out: dict) -> None:
    """Nested dict/list state -> flat npz keys (``.name`` for dict keys,
    ``#i`` for list positions) — how state_dict-only units (e.g. the
    transformer LM step's param pytree) ride the array snapshot."""
    if isinstance(obj, dict):
        for k in obj:
            _flatten_state(f"{prefix}.{k}", obj[k], out)
    elif isinstance(obj, (list, tuple)):
        for j, v in enumerate(obj):
            _flatten_state(f"{prefix}#{j}", v, out)
    else:
        out[prefix] = np.asarray(obj)


_PATH_STEP = re.compile(r"([.#])([^.#]+)")


def _unflatten_state(prefix: str, arrays: dict):
    """Inverse of :func:`_flatten_state` for one unit's key prefix."""
    root: dict = {}
    for key, val in arrays.items():
        if not key.startswith((prefix + ".", prefix + "#")):
            continue
        steps = _PATH_STEP.findall(key[len(prefix):])
        node = root
        for n, (sep, name) in enumerate(steps):
            k = int(name) if sep == "#" else name
            if n == len(steps) - 1:
                node[k] = val
            else:
                node = node.setdefault(k, {})

    def materialize(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return [materialize(node[i]) for i in sorted(node)]
        return {k: materialize(v) for k, v in node.items()}

    return materialize(root)


def _state_only_units(workflow) -> dict:
    """unit index -> unit, for forwards that snapshot through
    state_dict/load_state_dict instead of weights/bias Arrays."""
    out = {}
    for i, fwd in enumerate(workflow.forwards):
        has_arrays = any(getattr(fwd, a, None)
                         for a in ("weights", "bias"))
        if not has_arrays and hasattr(fwd, "state_dict") and \
                hasattr(fwd, "load_state_dict"):
            out[i] = fwd
    return out


def collect_state(workflow) -> tuple[dict, dict]:
    """-> (arrays, meta): every array the training state needs, plus
    JSON-able metadata.  Covers forwards' weights/bias, gds' momentum
    buffers, state_dict-only forwards (flattened pytrees), loader
    position + shuffle order, decision counters, and all PRNG streams."""
    step = getattr(workflow, "step", None)
    if step is not None and getattr(step, "_params", None) is not None \
            and hasattr(step, "sync_to_units"):
        step.sync_to_units()  # device params -> unit Arrays
    arrays: dict[str, np.ndarray] = {}
    # three-arg getattr: non-standard forwards (KohonenTrainer has no bias)
    # simply contribute fewer arrays
    state_only = _state_only_units(workflow)
    for i, fwd in enumerate(workflow.forwards):
        if i in state_only:
            _flatten_state(f"unitstate.{i}", fwd.state_dict(), arrays)
            continue
        for attr in ("weights", "bias"):
            arr = getattr(fwd, attr, None)
            if arr:
                arrays[f"forward.{i}.{attr}"] = np.asarray(arr.map_read())
    for i, gd in enumerate(getattr(workflow, "gds", []) or []):
        for attr in ("gradient_weights", "gradient_bias"):
            arr = getattr(gd, attr, None)
            if arr:
                arrays[f"gd.{i}.{attr}"] = np.asarray(arr.map_read())
    if step is not None and getattr(step, "_gen", None) is not None:
        # the step's generator is training state: the NEEDS_RNG forwards
        # draw from it, so bit-exact resume must restore it.  Its state
        # is read after every queued replay advanced it (the graphs
        # registered it), not as it stood at capture
        arrays["step.generator"] = step._gen.get_state().numpy().copy()
    if step is not None and hasattr(step, "extra_state_arrays"):
        # optimizer state with no unit home (adam 2nd moments, step count)
        for k, v in step.extra_state_arrays().items():
            arrays[f"step.opt.{k}"] = v
    loader_state = workflow.loader.state_dict()
    for cls, order in loader_state.pop("shuffled").items():
        arrays[f"loader.shuffled.{cls}"] = np.asarray(order)
    # fitted normalizers split into JSON meta + npz arrays (file loaders)
    norm_state = loader_state.pop("normalizer", None)
    if norm_state is not None:
        for k, v in norm_state["arrays"].items():
            arrays[f"loader.normalizer.{k}"] = np.asarray(v)
        loader_state["normalizer_meta"] = norm_state["meta"]
    meta = {
        "format_version": FORMAT_VERSION,
        "workflow_name": workflow.name,
        "loader": loader_state,
        "decision": workflow.decision.state_dict(),
        "prng": prng.state_dict(),
    }
    if step is not None and hasattr(step, "optimizer"):
        meta["optimizer"] = step.optimizer
    return arrays, meta


def restore_state(workflow, path: str) -> dict:
    """Load a snapshot into a freshly built workflow (post-``initialize``).
    Returns the metadata dict."""
    with np.load(path, allow_pickle=False) as zf:
        meta = json.loads(str(zf["__meta__"]))
        if meta["format_version"] != FORMAT_VERSION:
            raise ValueError(f"snapshot format {meta['format_version']} "
                             f"!= supported {FORMAT_VERSION}")
        arrays = {k: zf[k] for k in zf.files if k != "__meta__"}
    # poison-snapshot detection (resilience supervisor contract): the
    # checksum written at save time must match the content read back.
    # Pre-checksum snapshots (no key) load as before.
    stored = meta.get("checksum")
    if stored is not None and int(stored) != content_checksum(arrays):
        raise SnapshotCorruptError(
            f"snapshot {path} checksum mismatch: stored {stored}, "
            f"computed {content_checksum(arrays)} — refusing to resume "
            f"from a corrupt snapshot")
    # strict key/shape matching: a snapshot from a different architecture
    # must fail loudly, never silently resume from partly-random weights
    state_only = _state_only_units(workflow)
    targets: dict[str, object] = {}
    for i, fwd in enumerate(workflow.forwards):
        if i in state_only:
            continue
        for attr in ("weights", "bias"):
            if getattr(fwd, attr, None):
                targets[f"forward.{i}.{attr}"] = getattr(fwd, attr)
    for i, gd in enumerate(getattr(workflow, "gds", []) or []):
        for attr in ("gradient_weights", "gradient_bias"):
            if getattr(gd, attr, None):
                targets[f"gd.{i}.{attr}"] = getattr(gd, attr)
    param_keys = {k for k in arrays
                  if not k.startswith(("loader.", "step.", "unitstate."))}
    if param_keys != set(targets):
        raise ValueError(
            f"snapshot/workflow architecture mismatch: snapshot-only keys "
            f"{sorted(param_keys - set(targets))}, workflow-only keys "
            f"{sorted(set(targets) - param_keys)}")
    # ...and the same strictness for state_dict-only units: the pytree
    # STRUCTURE (key set) must match the unit's current state; shape
    # semantics are the unit's own load_state_dict contract (e.g. the LM
    # validates d/blocks/vocab — the vocab dimension may legitimately
    # track the restored loader rather than the fresh build)
    snap_state_units = {int(k[len("unitstate."):].split(".")[0]
                            .split("#")[0])
                        for k in arrays if k.startswith("unitstate.")}
    if snap_state_units != set(state_only):
        raise ValueError(
            f"snapshot/workflow architecture mismatch: snapshot carries "
            f"unit state for {sorted(snap_state_units)}, workflow expects "
            f"it for {sorted(state_only)}")
    for i, fwd in state_only.items():
        expected: dict = {}
        _flatten_state(f"unitstate.{i}", fwd.state_dict(), expected)
        got = {k for k in arrays
               if k.startswith((f"unitstate.{i}.", f"unitstate.{i}#"))}
        if got != set(expected):
            raise ValueError(
                f"snapshot/workflow architecture mismatch in unit {i} "
                f"state: snapshot-only keys {sorted(got - set(expected))},"
                f" workflow-only keys {sorted(set(expected) - got)}")
    for key, arr in targets.items():
        if tuple(arrays[key].shape) != tuple(arr.shape):
            raise ValueError(f"{key}: snapshot shape {arrays[key].shape} "
                             f"!= workflow shape {arr.shape}")
        arr.map_invalidate()
        arr.mem = arrays[key]
    loader_state = dict(meta["loader"])
    loader_state["shuffled"] = {
        int(k.rsplit(".", 1)[1]): v for k, v in arrays.items()
        if k.startswith("loader.shuffled.")}
    norm_meta = loader_state.pop("normalizer_meta", None)
    if norm_meta is not None:
        prefix = "loader.normalizer."
        loader_state["normalizer"] = {
            "meta": norm_meta,
            "arrays": {k[len(prefix):]: v for k, v in arrays.items()
                       if k.startswith(prefix)}}
    workflow.loader.load_state_dict(loader_state)
    workflow.decision.load_state_dict(meta["decision"])
    prng.load_state_dict(meta["prng"])
    # state_dict-only forwards (after the loader restore: their guards
    # may depend on restored loader state, e.g. the LM vocab check)
    for i, fwd in state_only.items():
        fwd.load_state_dict(_unflatten_state(f"unitstate.{i}", arrays))
    step = getattr(workflow, "step", None)
    if step is not None and getattr(step, "_params", None) is not None \
            and hasattr(step, "gather_params"):
        # (state_dict-only steps — the transformer LM — restored above;
        # this branch is the FusedTrainStep re-placement path)
        # optimizer identity is training state: resuming adam moments as
        # sgd momentum (or adam from zeroed second moments) would change
        # semantics silently — fail loudly like the architecture check.
        # Snapshots predating the meta key were all sgd.
        snap_opt = meta.get("optimizer", "sgd")
        if getattr(step, "optimizer", "sgd") != snap_opt:
            raise ValueError(
                f"snapshot optimizer {snap_opt!r} != workflow optimizer "
                f"{step.optimizer!r}; rebuild the workflow with "
                f"optimizer={snap_opt!r}")
        # re-place the restored weights: copied into the live leaves (a
        # captured graph reads those tensors)
        step.place_params(step.gather_params())
        # a restored normalizer may have re-normalized the loader's served
        # data: refresh the device-pinned dataset copy too
        step._pin_dataset()
        if "step.generator" in arrays:
            step.load_generator_state(arrays["step.generator"])
        elif "step.key" in arrays:
            Logger().warning(
                f"snapshot {path} carries a jax.random key (step.key) and "
                f"no torch generator state: the fused step keeps the "
                f"generator it minted at initialize")
        opt = {k[len("step.opt."):]: v for k, v in arrays.items()
               if k.startswith("step.opt.")}
        has_ema = any(k.split(".", 1)[1] in ("ew", "eb") for k in opt)
        if has_ema and step.ema_decay is None:
            # injecting ew/eb into a step whose compiled functions were
            # built without them would crash later with an opaque
            # pytree-structure mismatch — fail loudly here instead
            raise ValueError(
                "snapshot carries EMA weight mirrors but the workflow "
                "was built without ema_decay; rebuild with ema_decay set")
        if opt:
            step.load_extra_state(opt)
    return meta


def write_snapshot(path: str, arrays: dict, meta: dict,
                   retry=DEFAULT_IO_RETRY) -> None:
    """Crash-safe snapshot write: content checksum into the metadata,
    temp file + flush + fsync + atomic ``os.replace`` publish (a crash at
    ANY point leaves either the old snapshot or the new one, never a torn
    file), flaky-filesystem ``OSError`` s retried under ``retry``."""
    meta = {**meta, "checksum": content_checksum(arrays)}

    def _write_once() -> None:
        # pid-unique temp name: even if the rank-0 election is bypassed
        # (mixed versions, operator error) two processes racing the same
        # snapshot path can each publish atomically instead of tearing
        # one shared temp file
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                np.savez_compressed(
                    f, __meta__=np.array(json.dumps(meta)), **arrays)
                f.flush()
                os.fsync(f.fileno())
            # chaos hook (site "snapshot.write"): fires between the
            # durable temp write and the publish, so an injected failure
            # aborts the snapshot WITHOUT touching the previously
            # published one — the invariant the supervisor relies on
            fault_hook("snapshot.write", path=path)
            os.replace(tmp, path)  # atomic publish
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)     # never leave stale temp litter

    if retry is None:
        _write_once()
    else:
        retry.call(_write_once)


def verify_snapshot(path: str) -> bool:
    """True iff ``path`` is a readable snapshot whose stored checksum
    (when present) matches its content.  ANY failure — unreadable zip,
    truncated member, bad JSON, checksum mismatch — is "invalid": the
    supervisor treats it as poison and falls back to an older snapshot."""
    try:
        with np.load(path, allow_pickle=False) as zf:
            meta = json.loads(str(zf["__meta__"]))
            if meta.get("format_version") != FORMAT_VERSION:
                return False
            arrays = {k: zf[k] for k in zf.files if k != "__meta__"}
        stored = meta.get("checksum")
        return stored is None or int(stored) == content_checksum(arrays)
    except Exception:  # noqa: BLE001 — corruption surfaces many ways
        return False


# -- units ------------------------------------------------------------------
class SnapshotterBase(Unit):
    """Periodic snapshot unit (reference: SnapshotterBase).

    Sits in the gated side chain after Decision; StandardWorkflow wires
    ``gate_skip = ~decision.epoch_ended``.  ``interval`` further thins to
    every k-th epoch; when ``only_improved`` (reference: keyed on
    Decision.improved) epochs without validation improvement are skipped.
    """

    def __init__(self, workflow=None, prefix: str = "wf",
                 directory: Optional[str] = None, interval: int = 1,
                 only_improved: bool = True, keep_all: bool = False,
                 verify_timeout: float = 5.0,
                 **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.prefix = prefix
        self.directory = directory or os.getcwd()
        self.interval = int(interval)
        self.only_improved = only_improved
        self.keep_all = keep_all
        #: multi-process election: how long a non-zero rank
        #: waits for rank 0's snapshot to appear before degrading to a
        #: warning (the fleet's ranks run the same replicated decision
        #: logic, so they reach — and gate — the same epochs).  Keep it
        #: at or below the fleet's SIGTERM ``term_grace``: a verifier
        #: whose writer just died should warn and exit gracefully, not
        #: out-wait its own kill
        self.verify_timeout = float(verify_timeout)
        #: verification outcomes on non-zero ranks, for tests/status
        self.verified_ok = 0
        self.verified_failed = 0
        self.target_workflow = None
        self.decision = None
        #: path of the most recent snapshot (reference: destination)
        self.destination: Optional[str] = None
        #: the last snapshot written: its path, size in bytes, and the
        #: seconds to collect the state (device to host) and to write it
        #: (compression, checksum, fsync, publish)
        self.last_export: Optional[dict] = None
        self._epoch_counter = 0

    def link_workflow_state(self, workflow) -> "SnapshotterBase":
        self.target_workflow = workflow
        self.decision = workflow.decision
        return self

    def run(self) -> None:
        self._epoch_counter += 1
        if self._epoch_counter % self.interval != 0:
            return
        if self.only_improved and not bool(self.decision.improved):
            return
        self.export()

    def snapshot_path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"{self.prefix}_{epoch}.npz")

    def export(self) -> None:
        raise NotImplementedError


class SnapshotterToFile(SnapshotterBase):
    """Writes ``{prefix}_{epoch}.npz`` + ``{prefix}_latest.npz`` symlink
    (reference: SnapshotterToFile; compression is npz-deflate instead of
    the reference's gz/bz2/xz-by-extension)."""

    def _verify_published(self, path: str) -> bool:
        """Non-zero-rank half of the snapshot election: poll for rank
        0's file at ``path`` and checksum-verify it.  Degrades to a
        warning on timeout or corruption — a verifier must never kill
        the training run (rank 0 may have died; the fleet supervisor
        owns that failure)."""
        deadline = time.monotonic() + self.verify_timeout
        while not os.path.exists(path):
            if time.monotonic() >= deadline:
                self.verified_failed += 1
                self.warning(f"snapshot election: rank-0 snapshot {path} "
                             f"did not appear within "
                             f"{self.verify_timeout}s")
                return False
            time.sleep(0.05)
        # rank 0 publishes atomically (os.replace), so an existing path
        # is a complete file; a checksum failure is real corruption
        if verify_snapshot(path):
            self.verified_ok += 1
            self.debug(f"snapshot election: verified {path}")
            return True
        self.verified_failed += 1
        self.warning(f"snapshot election: {path} FAILED checksum "
                     f"verification")
        return False

    def _sweep_stale_temps(self) -> None:
        """Unlink ``<prefix>_*.npz.tmp.<pid>`` litter left by writers
        that were SIGKILL'd mid-write (pid-unique temps are crash-safe
        but not self-cleaning the way the old shared name was).  Only
        temps whose owning pid is gone are removed — a live concurrent
        writer keeps its file."""
        import glob as _glob
        for tmp in _glob.glob(os.path.join(
                self.directory, f"{self.prefix}_*.npz.tmp.*")):
            pid_text = tmp.rsplit(".", 1)[1]
            if pid_text.isdigit() and int(pid_text) != os.getpid():
                try:
                    os.kill(int(pid_text), 0)    # raises if pid is gone
                except ProcessLookupError:
                    try:
                        os.unlink(tmp)
                        self.debug(f"swept stale snapshot temp {tmp}")
                    except OSError:
                        pass
                except OSError:
                    pass                         # EPERM: someone else's

    def export(self) -> None:
        w = self.target_workflow
        rank, world = process_rank_world()
        t0 = time.perf_counter()
        # every rank collects: a data-parallel step's sharded state
        # reaches the param shape through collectives
        arrays, meta = collect_state(w)
        if rank != 0:
            # rank-0-writes / all-ranks-verify: concurrent writers would
            # race each other into torn files; every other rank instead
            # verifies the published artifact so corruption is caught at
            # save time on some rank, not at restore time after a crash
            del arrays
            self._verify_published(self.snapshot_path(
                int(meta["loader"]["epoch_number"])))
            return
        collected = time.perf_counter()
        epoch = int(meta["loader"]["epoch_number"])
        path = self.snapshot_path(epoch)
        os.makedirs(self.directory, exist_ok=True)
        self._sweep_stale_temps()
        try:
            write_snapshot(path, arrays, meta)
            self.last_export = {
                "path": path, "bytes": os.path.getsize(path),
                "collect_s": collected - t0,
                "write_s": time.perf_counter() - collected}
        except OSError as exc:
            # a snapshot that cannot be written (full/flaky disk, even
            # after retries) must not kill the training run: the previous
            # published snapshot stays the resume point.  Injected
            # crashes (FaultInjected) are not OSError and do propagate.
            self.error(f"snapshot write failed after retries, keeping "
                       f"{self.destination!r} as resume point: {exc!r}")
            return
        # prune only after the new snapshot is durably published — a failed
        # write must never leave the run without a resumable checkpoint
        if not self.keep_all and self.destination and \
                self.destination != path and \
                os.path.exists(self.destination):
            os.unlink(self.destination)
        self.destination = path
        latest = os.path.join(self.directory, f"{self.prefix}_latest.npz")
        try:
            if os.path.lexists(latest):
                os.unlink(latest)
            os.symlink(os.path.basename(path), latest)
        except OSError:
            pass  # symlink-less filesystems: latest pointer is best-effort
        self.info(f"snapshot -> {path}")


class NNSnapshotter(SnapshotterToFile):
    """SnapshotterToFile + per-layer weight statistics logging (reference:
    nn_units.py :: NNSnapshotter logs min/max/avg of weights/bias)."""

    def export(self) -> None:
        super().export()
        for i, fwd in enumerate(self.target_workflow.forwards):
            for attr in ("weights", "bias"):
                # three-arg: state_dict-only forwards carry no Arrays
                arr = getattr(fwd, attr, None)
                if arr:
                    m = arr.map_read()
                    self.info(
                        f"{fwd.name}.{attr}: min {m.min():+.4f} "
                        f"max {m.max():+.4f} avg {m.mean():+.4f}")
