"""Meshes, the port of ``repro.launch.mesh``.

PyTorch has no single-process SPMD, so a mesh is a world of ranks, one
process each (``repro_torch.launch.world``): ``make_serving_mesh((data,
model))`` lays a ``DeviceMesh`` with axes ``("data", "model")`` over the
initialised world; rank ``r`` sits at ``(r // model, r % model)``.

``make_production_mesh`` is shape-only (``MeshShape``: axis names and
sizes, no process group): the rules and a dry run plan the production
meshes, one TPU v5e pod ``(data=16, model=16)`` or two ``(pod=2, data=16,
model=16)``, in one process.
"""

from __future__ import annotations

import dataclasses
import math

SINGLE_POD = (16, 16)
MULTI_POD = (2, 16, 16)


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, with no process group behind it."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape(("pod", "data", "model"), MULTI_POD)
    return MeshShape(("data", "model"), SINGLE_POD)


def axis_names(mesh) -> tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def dp_axes(mesh) -> tuple:
    """Data-parallel axes: ('pod', 'data') on multi-pod, ('data',)
    otherwise."""
    return tuple(a for a in axis_names(mesh) if a != "model")


def data_shards(mesh) -> int:
    """Data shards a serving engine splits its slots and page pool into:
    the product of the non-model axes."""
    from repro_torch.sharding.rules import axis_sizes

    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in dp_axes(mesh))


def make_serving_mesh(shape: tuple[int, int] = (2, 2), *, device=None):
    """A ``(data, model)`` ``DeviceMesh`` over the initialised world, whose
    size must be ``data * model``. ``device``: the device type the mesh
    names ("cuda" or "cpu"; default: "cuda" when the world's backend is
    NCCL, else "cpu"; the ranks' tensors may live on the card either way,
    gloo takes CUDA tensors for ``all_reduce`` and ``broadcast``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(
            f"serving mesh {shape} needs an initialised world of {n} ranks: "
            f"start it with torchrun --nproc-per-node {n} (or "
            f"repro_torch.launch.world)")
    if dist.get_world_size() != n:
        raise RuntimeError(
            f"serving mesh {shape} needs {n} ranks, the world has "
            f"{dist.get_world_size()}: start it with torchrun "
            f"--nproc-per-node {n}")
    if device is None:
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(str(device), shape,
                            mesh_dim_names=("data", "model"))


def mesh_tensor_parallel(mesh):
    """This rank's ``repro_torch.sharding.ctx.TensorParallel`` on a serving
    mesh: its model-axis group and rank, and its data-axis group and
    shard (the MoE router's global counts); no weight recorded as split
    yet (``launch.shardings.lay_out_params`` records them)."""
    from repro_torch.sharding.ctx import TensorParallel

    data, model = (int(x) for x in tuple(mesh.shape))
    shard, rank = (int(x) for x in mesh.get_coordinate())
    return TensorParallel(
        group=mesh.get_group("model"), rank=rank, size=model,
        row_split=frozenset(), vocab_split=frozenset(),
        data_group=mesh.get_group("data"), data_rank=shard, data_size=data)
