"""Production mesh construction.

Functions (no module-level mesh), so importing this module touches no
process-group or device state.  The caller initialises the process
group first: ``fake_world`` (torch's ``"fake"`` backend, one rank of a
256- or 512-rank world) for the dry-run, a 1-rank NCCL group on one GPU,
or a gloo group of a few CPU ranks in the tests.
"""

from __future__ import annotations

import contextlib


def production_shape(multi_pod: bool = False) -> tuple[tuple, tuple]:
    """The production mesh's shape and axis names."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = production_shape(multi_pod)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_local_mesh(device_type="cuda"):
    """1-rank mesh with the production axis names."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (1, 1),
                            mesh_dim_names=("data", "model"))


def make_ep_mesh(n_experts: int, *, devices: int = 256, device_type="cuda"):
    """Expert-parallel regroup: ("data", "expert", "model")."""
    from torch.distributed.device_mesh import init_device_mesh
    if devices % n_experts:
        raise ValueError(f"{n_experts} experts do not divide {devices} "
                         "devices")
    rest = devices // n_experts
    data = 16 if rest % 16 == 0 else rest
    model = rest // data if rest % data == 0 else 1
    return init_device_mesh(device_type, (data, n_experts, model),
                            mesh_dim_names=("data", "expert", "model"))


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """A process group of ``world_size`` ranks on torch's ``"fake"``
    backend, this process as ``rank``: collectives return at once, so one
    process traces one rank's program of a large cluster.  The group is
    destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
