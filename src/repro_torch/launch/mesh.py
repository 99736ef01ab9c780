"""Mesh builders; the port of ``repro.launch.mesh``.

The reference's mesh is a grid of JAX devices with named axes. The port's is
a :class:`torch.distributed.device_mesh.DeviceMesh` over the ranks of the
process group that :func:`repro_torch.launch.dist.join` joined (one rank per
device of the grid), with the same axis names: ``("data", "model")``, or
``("pod", "data", "model")`` with a pod axis. Ranks fill the grid in
row-major order, the model axis fastest, as ``jax.make_mesh`` lays devices
out.

Building a mesh is a FUNCTION (no module constant), so importing this
module touches no process group; each builder needs one, and a world of
exactly the mesh's size (every rank raises otherwise, so no rank is left
waiting in a collective).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..device import DeviceLike

PRODUCTION_SHAPE = (16, 16)
MULTI_POD_SHAPE = (2, 16, 16)


class MeshSizeError(ValueError):
    """The process group's world size is not the mesh's size."""


def _mesh(shape: Tuple[int, ...], names: Tuple[str, ...], device_type: str) -> DeviceMesh:
    if not (dist.is_available() and dist.is_initialized()):
        raise MeshSizeError(
            f"a {'x'.join(map(str, shape))} mesh {names} needs a process group of "
            f"{_size(shape)} ranks, and this process is in none: launch one rank per device "
            "under torchrun")
    world = dist.get_world_size()
    if world != _size(shape):
        raise MeshSizeError(
            f"a {'x'.join(map(str, shape))} mesh {names} needs {_size(shape)} ranks, and the "
            f"world has {world}: launch {_size(shape)} (torchrun --nproc-per-node "
            f"{_size(shape)}), or choose axis sizes whose product is {world}")
    return DeviceMesh(device_type, torch.arange(world).reshape(shape), mesh_dim_names=names)


def _device_type(device: DeviceLike) -> str:
    """The mesh's device type: the caller's, else cuda when a card is
    present. A dry run's fake group passes ``"cpu"``, so it never starts
    CUDA."""
    if device is None:
        return "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(device).type


def _size(shape: Sequence[int]) -> int:
    out = 1
    for s in shape:
        out *= s
    return out


def make_production_mesh(*, multi_pod: bool = False, device: DeviceLike = None) -> DeviceMesh:
    """The reference's production mesh: 16x16 ``(data, model)``, or
    2x16x16 ``(pod, data, model)``; only in a world of 256 (512) ranks.
    ``device``: the ranks' device type, as in :func:`make_host_mesh`."""
    if multi_pod:
        return _mesh(MULTI_POD_SHAPE, ("pod", "data", "model"), _device_type(device))
    return _mesh(PRODUCTION_SHAPE, ("data", "model"), _device_type(device))


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 1,
                   device: Optional[DeviceLike] = None) -> DeviceMesh:
    """A ``data x model`` mesh (``pod x data x model`` when ``pod > 1``) over
    the joined group's ranks; ``device``: the ranks' device type (cuda when
    a card is present, else cpu)."""
    if pod > 1:
        return _mesh((pod, data, model), ("pod", "data", "model"), _device_type(device))
    return _mesh((data, model), ("data", "model"), _device_type(device))


def join_lm_mesh(ap, arch: str, data_par: int, model_par: int, dist_backend: Optional[str],
                 device: DeviceLike, entry: str):
    """For an LM entry point run with ``--data-par``/``--model-par``: join
    the torchrun job (``launch/dist.join``) and build the ``data x model``
    mesh over it (``data_par`` 0: the world over ``model_par``). A launcher missing, a
    backend that cannot work and a world of another size are ``ap.error``
    on every rank. Returns ``(RankContext, DeviceMesh)``."""
    from . import dist as launch_dist

    device_type = torch.device(device or "cuda").type
    try:
        ctx = launch_dist.join(
            dist_backend, device_type,
            what="--data-par/--model-par above 1 run one process per device of the mesh",
            example=f"{entry} --arch {arch} --data-par {data_par or 2} --model-par {model_par}")
    except launch_dist.LaunchError as e:
        ap.error(str(e))
    data = data_par or ctx.world // model_par
    if data * model_par != ctx.world:
        ctx.close()
        ap.error(f"--data-par {data} --model-par {model_par} is a mesh of {data * model_par} "
                 f"ranks, and the job has {ctx.world}: launch {data * model_par} (torchrun "
                 f"--nproc-per-node {data * model_par})")
    return ctx, make_host_mesh(data=data, model=model_par, device=ctx.device.type)


def print_peaks(device: torch.device) -> None:
    """On the card, every rank's peak device memory, printed by the caller
    that prints (a collective: every rank calls it)."""
    if device.type != "cuda":
        return
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, torch.cuda.max_memory_allocated(device))
    print("peak device memory per rank: " + ", ".join(str(p) for p in peaks) + " bytes")
