"""Mesh construction (counterpart of ``src/repro/launch/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks
of the initialised process group: ``make_mesh`` builds one of any shape on
``init_device_mesh``, ``make_production_mesh`` the reference's production
shapes. Functions, not module constants: importing this module touches no
process group. The dry run (``launch/dryrun.py``) builds the production
meshes in one process on the ``fake`` backend; the sharded runs build
small ones on gloo ranks (``spmd.run_ranks``).

Mesh shapes (the reference's pods of 256 chips):
  single-pod: (16, 16)    axes (data, model)
  multi-pod:  (2, 16, 16) axes (pod, data, model)

Axis roles: ``data`` = FSDP and batch, ``model`` = TP, EP, vocab and the
decode cache's sequence, ``pod`` = pure data parallelism across pods.

``AbstractMesh`` is a mesh's shape without ranks (the reference's
``jax.sharding.AbstractMesh``): the sharding rules and the memory model
take either.
"""

from __future__ import annotations

from typing import NamedTuple

from repro_torch.dist import axes_size, axis_sizes

__all__ = ["make_production_mesh", "make_mesh", "mesh_num_nodes"]


class AbstractMesh(NamedTuple):
    """A mesh's axis sizes and names, with no ranks behind it."""

    axis_sizes: tuple
    axis_names: tuple


def production_shape(multi_pod: bool = False) -> tuple[tuple, tuple]:
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The production mesh over the initialised group (256 or 512 ranks)."""
    return make_mesh(*production_shape(multi_pod), device_type=device_type)


def make_mesh(shape: tuple, axes: tuple, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the initialised
    group (its world size is the product of ``shape``): on the card unless
    the caller asks for ``device_type="cpu"``."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def mesh_size(mesh) -> int:
    """The number of ranks (chips) of a mesh."""
    return axes_size(mesh, axis_sizes(mesh))


def mesh_num_nodes(mesh, axis: str = "model") -> int:
    """Redynis 'node' count for a mesh (EP ranks along the model axis)."""
    return int(axis_sizes(mesh)[axis])
