"""Fault-tolerant checkpointing: atomic writes, keep-K retention, and
restore into templates.

Checkpoints reuse the ``core.export`` container (schema'd named tensors),
so a training checkpoint is readable by the same language-agnostic tooling
as a serving export, and the files are the JAX package's byte for byte: a
checkpoint written by either package restores in the other. State is
pulled to the host before writing, so a restore may place it on any
device (the template's).

Layout: ``<dir>/ckpt_<step:010d>/{params.rpro, opt.rpro, meta.json}``.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import time
from typing import Any, Dict, Optional, Tuple

from repro_torch.core import export as export_lib


def _write(path: str, tree: Any, model: str, step: int) -> None:
    with open(path, "wb") as f:
        f.write(export_lib.dumps(tree, model=model, meta={"step": step}))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # -- write ---------------------------------------------------------------

    def save(self, step: int, params: Any, opt_state: Any = None,
             extra: Optional[Dict] = None) -> str:
        """Atomic: write to tmp dir then rename; prune to keep-K."""
        name = f"ckpt_{step:010d}"
        final = os.path.join(self.directory, name)
        if os.path.exists(os.path.join(final, "meta.json")):
            return final  # idempotent: this step is already published
        tmp = tempfile.mkdtemp(prefix=name + ".tmp", dir=self.directory)
        try:
            _write(os.path.join(tmp, "params.rpro"), params, "checkpoint",
                   step)
            if opt_state is not None:
                _write(os.path.join(tmp, "opt.rpro"), opt_state, "opt_state",
                       step)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump({"step": step, "time": time.time(),
                           "extra": extra or {}}, f)
            os.replace(tmp, final)  # atomic publish
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._prune()
        return final

    def _prune(self):
        ckpts = self.list_steps()
        for step in ckpts[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"ckpt_{step:010d}"),
                          ignore_errors=True)

    # -- read ----------------------------------------------------------------

    def list_steps(self):
        out = []
        for d in os.listdir(self.directory):
            m = re.fullmatch(r"ckpt_(\d+)", d)
            if m and os.path.exists(os.path.join(self.directory, d, "meta.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    # -- serving handoff -------------------------------------------------------

    def publish_to_registry(self, registry, step: Optional[int] = None):
        """Promote a checkpoint (latest by default) into a serving
        ``core.registry.ModelRegistry``: the params container is re-published
        under a content-hashed version id, decoupling serving rollout from
        the keep-K retention window here — a promoted version outlives
        ``_prune``. Returns the registry's ``ModelVersion``."""
        return registry.publish_checkpoint(self, step=step)

    def restore(self, params_template: Any, opt_template: Any = None,
                step: Optional[int] = None, shardings: Any = None, mesh=None
                ) -> Tuple[Any, Any, int]:
        """Restore into templates: each leaf takes its template leaf's
        dtype, and a tensor leaf its device. With ``shardings``, a tree of
        ``distributed.sharding.P`` matching the params, and ``mesh``, a
        ``DeviceMesh`` (elastic restore onto a different mesh, JAX's
        ``shardings`` of ``NamedSharding``), each restored param is placed
        by its spec through ``sharding.distribute``: a DTensor whose
        shard on each rank is the rank's block of the values restored."""
        if (shardings is None) != (mesh is None):
            raise ValueError("restore places params with shardings and a mesh together")
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = os.path.join(self.directory, f"ckpt_{step:010d}")
        flat, _ = export_lib.load(os.path.join(d, "params.rpro"))
        params = export_lib.restore_into(params_template, flat)
        opt_state = None
        if opt_template is not None:
            flat_o, _ = export_lib.load(os.path.join(d, "opt.rpro"))
            opt_state = export_lib.restore_into(opt_template, flat_o)
        if shardings is not None:
            from repro_torch.distributed import sharding
            params = sharding.distribute(params, shardings, mesh)
        return params, opt_state, step
