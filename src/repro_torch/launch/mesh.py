"""Production and test meshes: the JAX package's ``launch/mesh.py`` as
``torch.distributed`` device meshes over the default process group.

Functions, not module-level constants: importing this module touches no
process-group state. The caller initialises the group first (NCCL ranks
on cards, gloo ranks or the fake group on the CPU).
"""
from __future__ import annotations

import math

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def _mesh(shape, names, device: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("no default process group: initialise one "
                           "(torch.distributed.init_process_group) first")
    n = math.prod(shape)
    if dist.get_world_size() != n:
        raise RuntimeError(f"a {shape} mesh needs {n} ranks; the default "
                           f"group has {dist.get_world_size()}")
    if device == "cuda":
        from repro_torch import resolve_device
        resolve_device(device)
    return init_device_mesh(device, tuple(shape), mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """16x16 = 256 ranks per pod; ``multi_pod`` adds a leading 2-pod axis.
    Raises unless the default group has exactly 256 (512) ranks."""
    shape, names = PRODUCTION_SHAPES[multi_pod]
    return _mesh(shape, names, device)


def make_test_mesh(n_data: int = 1, n_model: int = 1, device: str = "cuda"):
    """A (n_data, n_model) ("data", "model") mesh over the default group
    (of n_data x n_model ranks)."""
    return _mesh((n_data, n_model), ("data", "model"), device)


def batch_axis_size(mesh) -> int:
    size = 1
    names = list(mesh.mesh_dim_names)
    for a in ("pod", "data"):
        if a in names:
            size *= mesh.shape[names.index(a)]
    return size
