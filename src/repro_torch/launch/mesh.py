"""Mesh construction (the JAX package's ``launch/mesh.py``).

Functions, not module-level constants: importing this module touches no
process group.  A mesh is a ``torch.distributed`` ``DeviceMesh`` over the
default process group, one rank a process, with ``mesh_dim_names`` the
axes; the launcher's is ``(W, 1)`` over ``("data", "model")``.
"""
from __future__ import annotations


def make_mesh(shape, axes, device_type=None):
    """A ``DeviceMesh`` of ``shape`` over the default process group, whose
    world must be ``prod(shape)``: of ``"cuda"`` devices under NCCL, else
    of ``"cpu"`` ones (a gloo group reduces CUDA tensors too: the mesh only
    names its groups), unless ``device_type`` says."""
    import math

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs "
                         f"{math.prod(shape)} ranks; the world has {world}")
    device_type = device_type or (
        "cuda" if dist.get_backend() == "nccl" else "cpu")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """The JAX package's production mesh, ``(16, 16)`` over ``("data",
    "model")`` or ``(2, 16, 16)`` with a ``pod`` axis: it builds only in a
    world of 256 (512) ranks, such as the dry run's world of fake ranks
    (``launch/dryrun.fake_world``)."""
    import torch.distributed as dist
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 512 if multi_pod else 256
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(f"the production mesh {dict(zip(axes, shape))} "
                         f"needs a world of {need} ranks; this one has "
                         f"{world}")
    return make_mesh(shape, axes, device_type)


def data_axes(mesh) -> tuple:
    """Axes the global batch is sharded over ('pod' folds into data)."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def fsdp_axes(mesh) -> tuple:
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
