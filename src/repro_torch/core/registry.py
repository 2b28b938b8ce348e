"""Model registry: content-addressed, versioned reranker parameters.

The paper's workflow treats a trained model as a portable artifact — "we can
extract the parameters of a trained CNN ... and import the model" into the
serving runtime (arXiv:1707.08275). This module makes that artifact a
first-class *version*: a publish writes the weights (in the
``RPROAVRO1`` export container, the Avro analogue) plus a manifest under a
version id derived purely from the tensor contents, so

  * the same weights always publish to the same id (publishing is
    idempotent — re-promoting a checkpoint is a no-op);
  * two ids differ iff the weights differ (an A/B arm or a hot-swap target
    is unambiguous);
  * a load can verify, byte-for-byte, that the registry entry is intact.

Layout (everything published atomically via tmp dir + ``os.replace``, the
same discipline as the JAX package's ``training.checkpoint``):

  <root>/versions/<version_id>/params.rpro     export container (weights)
  <root>/versions/<version_id>/manifest.json   id, hash, provenance, sizes

The layout and the ids are the JAX package's: a registry directory written
by either package is read by the other. Serving binds a version instead of
raw params: ``PlanContext(registry=..., model_version=...)`` resolves the id
and loads the weights at construction (see ``core.plan``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import export as export_lib

_HASH_CHARS = 12  # of 64 hex chars: 48 bits — plenty for one registry


class RegistryError(ValueError):
    """Unknown/ambiguous version id, corrupt entry, or bad publish."""


@dataclasses.dataclass(frozen=True)
class ModelVersion:
    """One published version: its id, on-disk path, and manifest."""

    version_id: str
    path: str
    manifest: Dict[str, Any]


def content_hash(flat: Dict[str, np.ndarray]) -> str:
    """sha256 over the sorted named tensors (name, dtype, shape, bytes).

    A pure function of the WEIGHTS: independent of manifest metadata,
    training step, or publish time — so the derived version id is stable
    across re-publishes and across processes."""
    h = hashlib.sha256()
    for name in sorted(flat):
        arr = np.ascontiguousarray(np.asarray(flat[name]))
        h.update(name.encode())
        h.update(str(arr.dtype).encode())
        h.update(json.dumps(list(arr.shape)).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def nest_flat(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Rebuild nested dicts from '/'-joined tensor names ("conv_q/w"):
    ``export.unflatten``, with a name clash raised as ``RegistryError``."""
    try:
        return export_lib.unflatten(flat)
    except ValueError as e:
        raise RegistryError(str(e)) from None


class ModelRegistry:
    """Content-addressed store of reranker parameter versions."""

    def __init__(self, directory: str):
        self.directory = directory
        self._versions_dir = os.path.join(directory, "versions")
        os.makedirs(self._versions_dir, exist_ok=True)

    # -- publish -----------------------------------------------------------

    def _vdir(self, version_id: str) -> str:
        return os.path.join(self._versions_dir, version_id)

    def publish(self, params: Any, model: str = "",
                meta: Optional[Dict] = None,
                source_step: Optional[int] = None) -> ModelVersion:
        """Version a params tree (or {name: array} dict): serialize,
        hash, and atomically publish. Idempotent — identical weights land
        on the identical version id and the existing entry is kept."""
        blob = export_lib.dumps(params, model=model, meta=meta)
        flat, _ = export_lib.loads(blob)
        return self._publish_blob(blob, flat, model=model, meta=meta,
                                  source_step=source_step)

    def publish_checkpoint(self, manager, step: Optional[int] = None
                           ) -> ModelVersion:
        """Promote a ``training.checkpoint.CheckpointManager`` checkpoint
        (its ``params.rpro``, optimizer state excluded) into the registry."""
        if step is None:
            step = manager.latest_step()
        if step is None:
            raise RegistryError(f"no checkpoints in {manager.directory}")
        path = os.path.join(manager.directory, f"ckpt_{step:010d}",
                            "params.rpro")
        with open(path, "rb") as f:
            blob = f.read()
        flat, header = export_lib.loads(blob)
        return self._publish_blob(blob, flat, model=header.get("model", ""),
                                  meta=header.get("meta"), source_step=step)

    def _publish_blob(self, blob: bytes, flat: Dict[str, np.ndarray],
                      model: str, meta: Optional[Dict],
                      source_step: Optional[int]) -> ModelVersion:
        digest = content_hash(flat)
        vid = "v-" + digest[:_HASH_CHARS]
        final = self._vdir(vid)
        if os.path.exists(os.path.join(final, "manifest.json")):
            return self.get(vid)  # same weights, same id: already published
        manifest = {
            "version_id": vid,
            "content_hash": digest,
            "created": time.time(),
            "model": model,
            "meta": meta or {},
            "source_step": source_step,
            "n_tensors": len(flat),
            "nbytes": int(sum(np.asarray(a).nbytes for a in flat.values())),
        }
        tmp = tempfile.mkdtemp(prefix=vid + ".tmp", dir=self._versions_dir)
        try:
            with open(os.path.join(tmp, "params.rpro"), "wb") as f:
                f.write(blob)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f, indent=2, sort_keys=True)
            try:
                os.replace(tmp, final)  # atomic publish
            except OSError:
                # Lost a publish race for the same content hash: the entry
                # that won is byte-identical, so simply adopt it.
                if not os.path.exists(os.path.join(final, "manifest.json")):
                    raise
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        return ModelVersion(vid, final, manifest)

    # -- read ----------------------------------------------------------------

    def list_versions(self) -> List[str]:
        """Version ids, oldest first (by manifest creation time)."""
        entries: List[Tuple[float, str]] = []
        for d in os.listdir(self._versions_dir):
            mpath = os.path.join(self._versions_dir, d, "manifest.json")
            if not os.path.exists(mpath):
                continue  # a tmp dir mid-publish, or debris
            with open(mpath) as f:
                manifest = json.load(f)
            entries.append((float(manifest.get("created", 0.0)), d))
        return [vid for _, vid in sorted(entries)]

    def latest(self) -> Optional[str]:
        versions = self.list_versions()
        return versions[-1] if versions else None

    def get(self, version_id: str) -> ModelVersion:
        path = self._vdir(version_id)
        mpath = os.path.join(path, "manifest.json")
        if not os.path.exists(mpath):
            raise RegistryError(f"unknown model version {version_id!r} "
                                f"in {self.directory}")
        with open(mpath) as f:
            return ModelVersion(version_id, path, json.load(f))

    def resolve(self, version: str) -> str:
        """Resolve ``"latest"``, an exact id, or a unique id prefix."""
        if version == "latest":
            vid = self.latest()
            if vid is None:
                raise RegistryError(f"registry {self.directory} is empty")
            return vid
        if os.path.exists(os.path.join(self._vdir(version), "manifest.json")):
            return version
        matches = [v for v in self.list_versions() if v.startswith(version)]
        if len(matches) == 1:
            return matches[0]
        if matches:
            raise RegistryError(f"ambiguous version prefix {version!r}: "
                                f"{matches}")
        raise RegistryError(f"unknown model version {version!r} "
                            f"in {self.directory}")

    def load(self, version: str) -> Tuple[Dict[str, np.ndarray], Dict]:
        """Load a version's named tensors + manifest, verifying that the
        stored bytes still hash to the manifest's content hash."""
        mv = self.get(self.resolve(version))
        flat, _ = export_lib.load(os.path.join(mv.path, "params.rpro"))
        digest = content_hash(flat)
        if digest != mv.manifest["content_hash"]:
            raise RegistryError(
                f"version {mv.version_id}: content hash mismatch "
                f"({digest[:_HASH_CHARS]}... != "
                f"{mv.manifest['content_hash'][:_HASH_CHARS]}...) — "
                f"registry entry is corrupt")
        return flat, mv.manifest

    def load_params(self, version: str, template: Any = None) -> Any:
        """Load a version as a params tree. With a ``template`` (numpy
        arrays or tensors) the exact tree structure, dtypes and devices are
        restored (``export.restore_into``); without one, nested dicts of
        numpy arrays are rebuilt from the tensor names."""
        flat, _ = self.load(version)
        if template is not None:
            return export_lib.restore_into(template, flat)
        return nest_flat(flat)
