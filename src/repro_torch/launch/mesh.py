"""Device meshes over ``torch.distributed``.

The port of ``repro.launch.mesh``: functions, not module-level
constants, so importing touches no device or process group.  Each is a
``torch.distributed.device_mesh.init_device_mesh`` over the process
group the caller has started (``torch.distributed.init_process_group``,
or ``torchrun``'s environment); the mesh's dims carry the reference's
axis names.  Meshes are built on the card unless the caller asks for
another device type (the CPU tests pass ``"cpu"``, over gloo).
"""

from __future__ import annotations


def _world() -> int:
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("a device mesh needs a process group: call "
                           "torch.distributed.init_process_group first "
                           "(or run under torchrun)")
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """Single pod: (data=16, model=16) = 256 devices.
    Multi-pod: (pod=2, data=16, model=16) = 512 devices."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    world = _world()
    if world != n:
        raise ValueError(f"the production mesh {dict(zip(axes, shape))} "
                         f"needs {n} ranks; the process group has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(model: int = 1, device_type: str = "cuda"):
    """(data, model) mesh of (world // model, model) over every rank of
    the process group."""
    from torch.distributed.device_mesh import init_device_mesh
    n = _world()
    if n % model:
        raise ValueError(f"a model axis of {model} does not divide the "
                         f"{n} rank(s) of the process group")
    return init_device_mesh(device_type, (n // model, model),
                            mesh_dim_names=("data", "model"))


def mesh_axis_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))
