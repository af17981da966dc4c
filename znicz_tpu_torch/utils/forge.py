"""Forge — the model-zoo package registry, the port of
``znicz_tpu/utils/forge.py`` (rebuild of veles/forge/ forge_client.py:
manifest-driven ``veles forge upload/fetch``; SURVEY.md §3.3 Forge row).

A local directory registry with the reference's contract: packages are
the forward exports of ``utils/export.py`` (the same ``.npz`` format in
both packages, so a registry is shared between them) plus a manifest
entry (name, version, workflow metadata, sha256); re-uploads are
refused, fetches verify the checksum, versions order semantically and
uploads take an ``fcntl`` lock.  Point ``root.common.forge.dir`` (or the
``registry_dir`` argument) at a shared filesystem for the multi-user
behavior the reference's server provided.  A copy of the reference's
module, under the drift check of ``tests/test_torch_port_isolation.py``.
"""

from __future__ import annotations

import contextlib
import fcntl
import hashlib
import json
import os
import shutil

from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.logger import Logger

MANIFEST = "manifest.json"


def version_key(version: str):
    """Semantic ordering: numeric components compare as ints ('1.10' >
    '1.9'), non-numeric ones as strings."""
    return tuple((0, int(p)) if p.isdigit() else (1, p)
                 for p in version.split("."))


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class ForgeRegistry(Logger):
    """Local manifest-driven package registry (reference: ForgeClient)."""

    def __init__(self, registry_dir: str | None = None) -> None:
        super().__init__()
        cfg = root.common.get("forge", None)
        cfg_dir = cfg.get("dir", None) if cfg is not None else None
        self.dir = registry_dir or cfg_dir or \
            os.path.join(os.getcwd(), ".forge")

    # -- manifest -----------------------------------------------------------
    def _manifest_path(self) -> str:
        return os.path.join(self.dir, MANIFEST)

    @contextlib.contextmanager
    def _locked(self):
        """Exclusive advisory lock over the registry: uploads are
        read-modify-write on the manifest, and the docstring's
        shared-filesystem promise needs them serialized."""
        os.makedirs(self.dir, exist_ok=True)
        with open(os.path.join(self.dir, ".lock"), "w") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(lockf, fcntl.LOCK_UN)

    def _load_manifest(self) -> dict:
        try:
            with open(self._manifest_path()) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return {}

    def _save_manifest(self, manifest: dict) -> None:
        os.makedirs(self.dir, exist_ok=True)
        tmp = self._manifest_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)
        os.replace(tmp, self._manifest_path())

    # -- the up/download contract --------------------------------------------
    def upload(self, package_path: str, name: str, version: str,
               metadata: dict | None = None) -> dict:
        """Register a forward package (utils/export.py .npz) under
        ``name``/``version``; re-uploading an existing version is refused
        (reference semantics: packages are immutable)."""
        with self._locked():
            manifest = self._load_manifest()
            versions = manifest.setdefault(name, {})
            if version in versions:
                raise FileExistsError(f"{name}=={version} already in the "
                                      f"registry (packages are immutable)")
            fname = f"{name}-{version}.npz"
            shutil.copyfile(package_path, os.path.join(self.dir, fname))
            entry = {"file": fname,
                     "sha256": _sha256(os.path.join(self.dir, fname)),
                     "metadata": metadata or {}}
            versions[version] = entry
            self._save_manifest(manifest)
        self.info(f"forge: uploaded {name}=={version}")
        return entry

    def upload_workflow(self, workflow, name: str, version: str,
                        metadata: dict | None = None) -> dict:
        """Export ``workflow``'s forward chain and upload it in one go."""
        from znicz_tpu_torch.utils.export import export_forward

        tmp = os.path.join(self.dir,
                           f".upload-{name}-{version}.{os.getpid()}.npz")
        os.makedirs(self.dir, exist_ok=True)
        try:
            export_forward(workflow, tmp)
            meta = {"workflow": workflow.name,
                    "best_metric": workflow.decision.best_metric,
                    **(metadata or {})}
            return self.upload(tmp, name, version, meta)
        finally:
            # a failed export must surface ITS error, not the cleanup's
            with contextlib.suppress(FileNotFoundError):
                os.unlink(tmp)

    def list_packages(self) -> dict:
        """name -> version list in semantic order."""
        return {name: sorted(vs, key=version_key) for name, vs in
                self._load_manifest().items()}

    def fetch(self, name: str, version: str | None = None,
              dest: str | None = None) -> str:
        """Resolve a package (latest version when unspecified), verify its
        checksum and return a local path: the in-registry file for
        read-only use, or a copy when ``dest`` is given."""
        manifest = self._load_manifest()
        if name not in manifest:
            raise KeyError(f"unknown forge package {name!r}; have "
                           f"{sorted(manifest)}")
        versions = manifest[name]
        version = version or sorted(versions, key=version_key)[-1]
        if version not in versions:
            raise KeyError(f"{name} has no version {version!r}; have "
                           f"{sorted(versions)}")
        entry = versions[version]
        src = os.path.join(self.dir, entry["file"])
        if _sha256(src) != entry["sha256"]:
            raise IOError(f"forge package {name}=={version} is corrupt "
                          f"(sha256 mismatch)")
        if dest is None:
            self.info(f"forge: fetched {name}=={version} (in place)")
            return src
        shutil.copyfile(src, dest)
        self.info(f"forge: fetched {name}=={version} -> {dest}")
        return dest
