"""Mesh builders over ``torch.distributed`` (port of
``repro.launch.mesh``).

One process drives one device: a mesh of ``data x model`` ranks is that
many processes joined by :func:`init_distributed` (NCCL between cards,
gloo between CPU processes).  :func:`mesh_from_spec` is the builder behind
the launchers' ``--mesh`` flag: ``"2x4"`` (data x model) or
``"data=2,model=4"`` both give a (data=2, model=4)
``torch.distributed.device_mesh.DeviceMesh`` over the first 8 ranks.

Nothing here touches the process group at import.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     *, local_device_count: Optional[int] = None,
                     device: Optional[str] = None) -> None:
    """Join a ``torch.distributed`` process group: every process runs the
    same program with its own ``process_id``.

    ``coordinator`` is ``host:port`` (a TCP store on process 0, the
    reference's coordinator address) or any ``init_method`` URL
    (``tcp://...``, ``file:///path`` — a ``FileStore``, no port needed).
    The backend is NCCL on the card (``device`` "cuda", the default when a
    card is present; process i uses card ``i % device_count``) and gloo on
    the CPU.  One process is one device: ``local_device_count`` above 1 is
    refused (the reference fabricates that many host devices per process;
    the port has no such devices to fabricate)."""
    if local_device_count is not None and local_device_count > 1:
        raise ValueError(
            f"local_device_count={local_device_count}: one process drives "
            "one device in the port (run one process per device instead)")
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    backend = "nccl" if device == "cuda" else "gloo"
    if device == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)


def add_process_flags(ap) -> None:
    """The launchers' multi-process flags (one process a device)."""
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 (or an init_method URL, "
                         "e.g. file:///tmp/store): joins a torch.distributed "
                         "job; every process runs this same command with "
                         "its own --process-id")
    ap.add_argument("--num-processes", type=int, default=None,
                    help="total process count of the multi-process job")
    ap.add_argument("--process-id", type=int, default=None,
                    help="this process's rank in [0, num_processes)")
    ap.add_argument("--local-devices", type=int, default=None,
                    help="devices per process; one process drives one "
                         "device, so only 1 is accepted")


def join_from_flags(ap, args, device: torch.device) -> torch.device:
    """Join the job that :func:`add_process_flags`' flags name, when
    ``--coordinator`` is given, and return the device this process
    drives (on the card, the one ``init_distributed`` picked); refuse the
    flags' misuse through ``ap.error``."""
    if args.coordinator:
        if args.num_processes is None or args.process_id is None:
            ap.error("--coordinator requires --num-processes and "
                     "--process-id")
        init_distributed(args.coordinator, args.num_processes,
                         args.process_id,
                         local_device_count=args.local_devices,
                         device=device.type)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
    elif args.local_devices is not None and args.local_devices > 1:
        ap.error("--local-devices: one process drives one device; start "
                 "one process a device with --coordinator")
    return device


def device_type() -> str:
    """The device type of the joined process group's tensors."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_host_mesh():
    """A 1x1 (data, model) mesh over rank 0 (smoke runs; keeps the axis
    names)."""
    return mesh_from_spec("1x1")


def data_axes(mesh) -> tuple[str, ...]:
    """Axes that carry the batch dimension (pod folds into data)."""
    from repro_torch.dist.shardings import data_axes as _impl
    return _impl(mesh)


def parse_mesh_spec(spec: str) -> dict[str, int]:
    """Parse a ``--mesh`` value into ``{axis: size}`` (ordered).

    Accepted forms:
      - ``"2x4"``            -> {"data": 2, "model": 4}
      - ``"data=2,model=4"`` -> {"data": 2, "model": 4} (any axis names)
    Sizes must be positive integers; no device-count check happens here.
    """
    spec = spec.strip()
    if not spec:
        raise ValueError("empty mesh spec")
    if "=" in spec:
        axes: dict[str, int] = {}
        for part in spec.split(","):
            name, _, size = part.partition("=")
            name = name.strip()
            if not name or name in axes:
                raise ValueError(f"bad mesh spec {spec!r}: axis {name!r}")
            axes[name] = int(size)
    else:
        sizes = [int(s) for s in spec.replace(",", "x").split("x")]
        if len(sizes) != 2:
            raise ValueError(
                f"bad mesh spec {spec!r}: want DxM (e.g. 2x4) or name=size "
                "pairs")
        axes = {"data": sizes[0], "model": sizes[1]}
    if any(s < 1 for s in axes.values()):
        raise ValueError(f"bad mesh spec {spec!r}: sizes must be >= 1")
    return axes


def mesh_from_spec(spec: str):
    """A ``DeviceMesh`` with the spec's axis names over the first
    prod(sizes) ranks of the joined process group (so a 2x2 mesh works in a
    world of 8).  Raises when the world is too small, or when no process
    group was joined (``init_distributed``).  Every rank of the world
    calls it, as it builds process groups."""
    from torch.distributed.device_mesh import DeviceMesh

    axes = parse_mesh_spec(spec)
    need = math.prod(axes.values())
    if not dist.is_initialized():
        raise ValueError(
            f"mesh {spec!r} needs {need} ranks but no process group is "
            "joined; call launch.mesh.init_distributed first (one process a "
            "device)")
    world = dist.get_world_size()
    if need > world:
        raise ValueError(
            f"mesh {spec!r} needs {need} ranks (one device each) but the "
            f"process group has only {world}; start {need} processes")
    grid = torch.arange(need).reshape(tuple(axes.values()))
    return DeviceMesh(device_type(), grid, mesh_dim_names=tuple(axes))
