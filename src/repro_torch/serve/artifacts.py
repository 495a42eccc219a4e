"""Versioned on-disk artifacts for servable indexes — the port of
``repro.serve.artifacts``, with the same on-disk format, so an index one
package saves the other loads.

An :class:`IndexStore` keeps ``root/v0001``, ``root/v0002``, ... — one
directory per version, each a ``manifest.json`` plus one ``.npy`` file per
array. The manifest records each array's file, sha256, shape, logical
dtype and stored dtype. Integrity contract: a torn artifact never reaches
a serving hot-swap.

* **atomic publication** — a version is written into a hidden temp
  directory and renamed into place, so a reader sees either nothing or
  the whole version;
* **checksums and shape/dtype echo** — re-verified on load; any mismatch
  raises :class:`ArtifactError`;
* **structural validation** — ``check_servable()`` before save and after
  load.

bf16 buffers are stored as their uint16 bit pattern and re-viewed on
load, so every round trip keeps every bit.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.core.index import DTYPES, ClusterIndex, tensor_from_numpy
from repro_torch.core.plan import FitResult
from repro_torch.runtime import resolve_device

_FORMAT = 1
_MANIFEST = "manifest.json"
_VERSION_RE = re.compile(r"^v(\d{4,})$")

# (field, required): the ClusterIndex arrays in manifest order; the packed
# buffers are left out of the manifest when the index has none
_FIELDS = (
    ("protos", True),
    ("proto_mass", True),
    ("proto_valid", True),
    ("proto_labels", True),
    ("n_prototypes", True),
    ("protos_bf16", False),
    ("protos_q8", False),
    ("q8_scale", False),
    ("q8_zero", False),
)


class ArtifactError(RuntimeError):
    """A stored index version is missing, torn, or fails validation."""


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _to_storable(t: torch.Tensor) -> tuple:
    """Tensor → (host array to write, logical dtype, stored dtype)."""
    # repro_torch: allow[HS201]: an artifact is written from host memory
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:  # numpy has no portable bf16
        # repro_torch: allow[HS201]: an artifact is written from host memory
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16", "uint16"
    # repro_torch: allow[HS201]: an artifact is written from host memory
    host = t.numpy()
    return host, str(host.dtype), str(host.dtype)


class IndexStore:
    """Directory of versioned, checksummed index artifacts.

    ``save`` publishes the next version number; ``load`` defaults to the
    latest and places the index on ``device`` (default: the runtime
    config's). The store only ever adds versions; pruning old ones is the
    deployment's retention policy.
    """

    def __init__(self, root: Union[str, os.PathLike]):
        self.root = os.fspath(root)
        os.makedirs(self.root, exist_ok=True)

    # ---- enumeration ------------------------------------------------------

    def list_versions(self) -> List[int]:
        """Published version numbers, ascending (temp dirs excluded)."""
        out = []
        for name in sorted(os.listdir(self.root)):
            mt = _VERSION_RE.match(name)
            if mt and os.path.isdir(os.path.join(self.root, name)):
                out.append(int(mt.group(1)))
        return sorted(out)

    def latest(self) -> Optional[int]:
        """The newest published version, or None for an empty store."""
        versions = self.list_versions()
        return versions[-1] if versions else None

    def path(self, version: int) -> str:
        return os.path.join(self.root, f"v{version:04d}")

    # ---- save -------------------------------------------------------------

    def save(self, source: Union[ClusterIndex, FitResult], *,
             metadata: Optional[Dict[str, Any]] = None) -> int:
        """Publish ``source`` (an index, or a FitResult frozen and packed on
        the way in) as the next version; returns its number. Validated
        before a byte is written; written into a temp directory, then
        renamed into place."""
        if isinstance(source, FitResult):
            index = ClusterIndex.build(source)
        elif isinstance(source, ClusterIndex):
            index = source
        else:
            raise TypeError(
                f"IndexStore.save takes a ClusterIndex or FitResult, got "
                f"{type(source).__name__}")
        index.check_servable()

        version = (self.latest() or 0) + 1
        final = self.path(version)
        tmp = os.path.join(self.root, f"_tmp.v{version:04d}")
        if os.path.isdir(tmp):  # a crashed previous save; sweep it
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        try:
            arrays: Dict[str, Dict[str, Any]] = {}
            for name, required in _FIELDS:
                arr = getattr(index, name)
                if arr is None:
                    if required:
                        raise ArtifactError(
                            f"index is missing required array {name!r}")
                    continue
                host, logical, stored = _to_storable(arr)
                fname = f"{name}.npy"
                np.save(os.path.join(tmp, fname), host, allow_pickle=False)
                arrays[name] = {
                    "file": fname,
                    "dtype": logical,
                    "stored_dtype": stored,
                    "shape": [int(s) for s in host.shape],
                    "sha256": _sha256(os.path.join(tmp, fname)),
                }
            manifest = {
                "format": _FORMAT,
                "version": version,
                "kind": "cluster_index",
                "dim": int(index.dim),
                "arrays": arrays,
                "metadata": dict(metadata or {}),
            }
            with open(os.path.join(tmp, _MANIFEST), "w") as f:
                json.dump(manifest, f, indent=2, sort_keys=True)
            if os.path.exists(final):
                raise ArtifactError(
                    f"version {version} already exists at {final} "
                    f"(concurrent saver?)")
            os.rename(tmp, final)  # atomic publication
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        return version

    # ---- load -------------------------------------------------------------

    def load(self, version: Optional[int] = None, *,
             expect_dim: Optional[int] = None, device=None) -> ClusterIndex:
        """Reconstruct a stored version (latest when ``version`` is None) on
        ``device``, rejecting torn artifacts: a missing or unreadable
        manifest, a missing array file, a checksum or shape/dtype mismatch,
        or an index that fails ``check_servable(expect_dim)`` raises
        :class:`ArtifactError`."""
        dev = resolve_device(device)
        if version is None:
            version = self.latest()
            if version is None:
                raise ArtifactError(f"index store {self.root!r} is empty")
        vdir = self.path(version)
        mpath = os.path.join(vdir, _MANIFEST)
        if not os.path.isfile(mpath):
            raise ArtifactError(f"version {version} has no manifest at {mpath}")
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except (OSError, json.JSONDecodeError) as exc:
            raise ArtifactError(
                f"version {version}: torn manifest ({exc})") from exc
        if manifest.get("format") != _FORMAT:
            raise ArtifactError(
                f"version {version}: unknown artifact format "
                f"{manifest.get('format')!r} (this reader speaks {_FORMAT})")
        arrays = manifest.get("arrays")
        if not isinstance(arrays, dict):
            raise ArtifactError(
                f"version {version}: manifest has no arrays table")

        fields: Dict[str, Any] = {}
        for name, required in _FIELDS:
            meta = arrays.get(name)
            if meta is None:
                if required:
                    raise ArtifactError(
                        f"version {version}: manifest is missing required "
                        f"array {name!r}")
                continue
            apath = os.path.join(vdir, meta["file"])
            if not os.path.isfile(apath):
                raise ArtifactError(
                    f"version {version}: listed array file {meta['file']!r} "
                    f"is missing")
            digest = _sha256(apath)
            if digest != meta["sha256"]:
                raise ArtifactError(
                    f"version {version}: checksum mismatch on "
                    f"{meta['file']!r} (stored {meta['sha256'][:12]}…, "
                    f"recomputed {digest[:12]}…) — torn or corrupted")
            try:
                raw = np.load(apath, allow_pickle=False)
            except (OSError, ValueError, EOFError) as exc:
                raise ArtifactError(
                    f"version {version}: unreadable array {meta['file']!r} "
                    f"({exc})") from exc
            if (list(raw.shape) != list(meta["shape"])
                    or str(raw.dtype) != meta["stored_dtype"]):
                raise ArtifactError(
                    f"version {version}: {meta['file']!r} is "
                    f"{raw.dtype}{list(raw.shape)}, manifest says "
                    f"{meta['stored_dtype']}{meta['shape']}")
            want = DTYPES[name]
            if meta["dtype"] != str(want).replace("torch.", ""):
                raise ArtifactError(
                    f"version {version}: {name} is stored as {meta['dtype']}, "
                    f"want {want}")
            fields[name] = tensor_from_numpy(raw, want, dev)

        try:
            index = ClusterIndex(**fields).check_servable(expect_dim)
        except ValueError as exc:
            raise ArtifactError(
                f"version {version}: not servable ({exc})") from exc
        return index
