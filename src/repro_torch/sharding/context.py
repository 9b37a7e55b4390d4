"""Mesh shapes: the port's counterpart of the JAX package's
``sharding/context.py``. That module holds a thread-local mesh which the
JAX layers consult (the MoE goes per data shard when it has a data axis);
here the mesh reaches the layers only through the
:class:`repro_torch.sharding.parallel.TensorParallel` view a forward
takes, so what is left is reading a mesh's axes.

A mesh here is a ``torch.distributed.device_mesh.DeviceMesh`` or, for the
placement table alone, a ``{axis: size}`` mapping."""
from __future__ import annotations


def mesh_shape(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` or of such a mapping."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def data_axes(mesh) -> tuple:
    shape = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in shape)
