"""Mesh construction + axis conventions.

Axes:
  pod   — slowest axis (data-center network / inter-node links);
          pure data parallelism + compressed gradient all-reduce.
  data  — data parallelism (batch, edges, candidates, groups).
  model — tensor/expert/table parallelism (heads, ffn, experts, vocab rows).

The port of the JAX package's ``distributed/mesh.py``. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
process group, laid out row-major (rank r at the r-th position of the
mesh's C-order walk, as ``jax.make_mesh`` lays out devices). Building one
needs an initialised default process group (``torch.distributed.
init_process_group``, with its address, world size and rank given by the
caller): nothing here creates one. ``AbstractMesh`` is a mesh's axis names
and sizes alone, for the partition rules, which read nothing else and so
run without a process group, as JAX's run on its ``AbstractMesh``.

``mesh_shape``, ``data_axes`` and ``axis_size`` take either kind.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch.distributed as dist

from repro_torch import resolve_device


class AbstractMesh:
    """Axis sizes and names, no devices: ``.shape`` maps each name to its
    size in axis order, ``.axis_names`` lists the names (JAX's
    ``AbstractMesh(axis_sizes, axis_names)``)."""

    def __init__(self, axis_sizes: Tuple[int, ...], axis_names: Tuple[str, ...]):
        if len(axis_sizes) != len(axis_names):
            raise ValueError(f"{len(axis_sizes)} axis sizes for {len(axis_names)} "
                             f"axis names")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in axis_sizes)))

    def __repr__(self) -> str:
        return f"AbstractMesh({', '.join(f'{k}={v}' for k, v in self.shape.items())})"


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod", "data",
    "model"): 256 or 512 ranks, which the default process group must
    hold."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device_type=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` on ``device_type``
    ("cuda" unless the caller asks for "cpu"; "cuda" without a card
    raises). The default process group must be initialised and hold
    exactly prod(shape) ranks."""
    dev = resolve_device(device_type)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised default process group "
                           "(torch.distributed.init_process_group); it never creates one")
    n = 1
    for s in shape:
        n *= s
    if dist.get_world_size() != n:
        raise ValueError(f"a mesh of shape {tuple(shape)} needs {n} ranks; the default "
                         f"process group holds {dist.get_world_size()}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axes))


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size, in axis order, of a ``DeviceMesh`` or an
    ``AbstractMesh``."""
    if isinstance(mesh, AbstractMesh):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_axes(mesh) -> Tuple[str, ...]:
    """Axes used for batch-like sharding (everything except 'model')."""
    return tuple(a for a in mesh_shape(mesh) if a != "model")


def axis_size(mesh, *names: str) -> int:
    shape = mesh_shape(mesh)
    n = 1
    for name in names:
        if name in shape:
            n *= shape[name]
    return n
