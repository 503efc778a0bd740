"""Ranks and process groups of the port: the counterpart of the JAX
package's ``mesh.py``.

JAX builds one device mesh with named axes and lets XLA place the
collectives. Here every rank is one process (``torchrun`` starts one per
rank), and a :class:`Mesh` says where this rank sits: the axis sizes, this
rank's coordinate on each axis, and one ``torch.distributed`` group per
axis larger than 1, plus the world. Ranks are numbered row-major over
:data:`MESH_AXES`, ``dp`` outermost, as the JAX mesh lays its devices out.

The backend follows one rule (:func:`pick_backend`): NCCL when every rank of
a host has a CUDA device of its own, gloo otherwise (the CPU, or ranks that
share a card). Under gloo, CUDA tensors travel through host memory
(``comms.py``).
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch

from .config import MeshConfig

# Canonical axis order, outermost first (the JAX package's MESH_AXES).
MESH_AXES: tuple[str, ...] = ("dp", "fsdp", "pp", "tp", "cp", "ep")

# Axes over which the global batch is split.
BATCH_AXES: tuple[str, ...] = ("dp", "fsdp")


def axis_sizes(cfg: MeshConfig, n_devices: int) -> dict[str, int]:
    """Every axis's size over ``n_devices`` ranks; one axis may be ``-1``
    and absorbs the ranks left over (``MeshConfig.axis_sizes`` of the JAX
    package)."""
    sizes = {a: getattr(cfg, a) for a in MESH_AXES}
    wild = [a for a, s in sizes.items() if s == -1]
    if len(wild) > 1:
        raise ValueError(f"at most one mesh axis may be -1, got {wild}")
    for a, s in sizes.items():
        if s < 1 and s != -1:
            raise ValueError(f"axis {a!r} has invalid size {s}")
    fixed = math.prod(s for s in sizes.values() if s != -1)
    if wild:
        if n_devices % fixed:
            raise ValueError(
                f"{n_devices} devices not divisible by fixed axes product "
                f"{fixed}"
            )
        sizes[wild[0]] = n_devices // fixed
    if math.prod(sizes.values()) != n_devices:
        raise ValueError(
            f"mesh {sizes} needs {math.prod(sizes.values())} devices, "
            f"have {n_devices}"
        )
    return sizes


@dataclasses.dataclass(frozen=True)
class DistEnv:
    """What ``torchrun`` tells a rank about the job."""

    rank: int = 0
    world_size: int = 1
    local_rank: int = 0
    local_world_size: int = 1
    master_addr: str = "localhost"
    master_port: int = 29500

    @classmethod
    def from_environ(cls, environ=None) -> DistEnv:
        env = os.environ if environ is None else environ
        world = int(env.get("WORLD_SIZE", 1))
        return cls(
            rank=int(env.get("RANK", 0)), world_size=world,
            local_rank=int(env.get("LOCAL_RANK", 0)),
            local_world_size=int(env.get("LOCAL_WORLD_SIZE", world)),
            master_addr=env.get("MASTER_ADDR", "localhost"),
            master_port=int(env.get("MASTER_PORT", 29500)),
        )


def pick_backend(device_type: str, local_world_size: int,
                 cuda_devices: int) -> str:
    """``nccl`` when the ranks run on CUDA and every rank of this host has a
    card of its own; ``gloo`` on the CPU, or when ranks share a card (NCCL
    refuses two ranks on one GPU)."""
    if device_type == "cuda" and local_world_size <= cuda_devices:
        return "nccl"
    return "gloo"


def rank_device(device, env: DistEnv | None = None) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` when each rank has a card,
    the cards shared round-robin when there are fewer cards than ranks, the
    CPU as asked."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    env = env or DistEnv.from_environ()
    return torch.device("cuda", env.local_rank % torch.cuda.device_count())


def init_distributed(device="cuda", env: DistEnv | None = None) -> bool:
    """Join the job ``torchrun`` started: the process group over
    ``WORLD_SIZE`` ranks at ``tcp://MASTER_ADDR:MASTER_PORT`` (localhost
    when every rank runs on this host), on the
    backend :func:`pick_backend` chooses (printed once, by rank 0). Returns
    False for the single-process path (no ``WORLD_SIZE`` above 1), True
    once the group is up."""
    import torch.distributed as dist

    env = env or DistEnv.from_environ()
    if env.world_size <= 1:
        return False
    if dist.is_initialized():
        return True
    device = rank_device(device, env)
    n_cuda = torch.cuda.device_count() if device.type == "cuda" else 0
    backend = pick_backend(device.type, env.local_world_size, n_cuda)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    addr = env.master_addr
    if env.local_world_size == env.world_size:
        # Every rank on this host: meet on the loopback device, whatever
        # the hostname resolves to.
        addr = "localhost"
        if backend == "gloo":
            os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(
        backend, init_method=f"tcp://{addr}:{env.master_port}",
        world_size=env.world_size, rank=env.rank,
    )
    if env.rank == 0:
        where = (f"{n_cuda} cuda device{'s' if n_cuda != 1 else ''}"
                 if device.type == "cuda" else "the cpu")
        print(f"dist: {backend}, {env.world_size} ranks on {where}",
              flush=True)
    return True


def is_rank0() -> bool:
    """True on rank 0 of the process group, or where there is none: the
    rank that prints, writes metrics and writes checkpoints."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def coords_of(shape: dict[str, int], rank: int) -> dict[str, int]:
    """Rank -> its coordinate on every axis, row-major over MESH_AXES."""
    coords, rest = {}, rank
    for a in reversed(MESH_AXES):
        coords[a] = rest % shape[a]
        rest //= shape[a]
    return {a: coords[a] for a in MESH_AXES}


def axis_ranks(shape: dict[str, int], rank: int, axis: str) -> list[int]:
    """The ranks of ``rank``'s group along ``axis`` ('world': every rank),
    ordered by their coordinate on it."""
    if axis == "world":
        return list(range(math.prod(shape.values())))
    stride = math.prod(shape[a] for a in MESH_AXES[MESH_AXES.index(axis) + 1:])
    base = rank - coords_of(shape, rank)[axis] * stride
    return [base + i * stride for i in range(shape[axis])]


class Mesh:
    """This rank's place on the mesh.

    - ``shape``: axis -> size over :data:`MESH_AXES` (as ``jax.sharding.
      Mesh.shape``); ``size`` their product, the number of ranks;
    - ``coords``: axis -> this rank's coordinate;
    - ``comm``: the transport the collectives of ``comms.py`` run on: a
      :class:`comms.DistComm` over torch.distributed groups, or None where
      no collective runs (one rank, or a mesh used for its shape only).
    """

    def __init__(self, shape: dict[str, int], rank: int = 0, comm=None):
        self.shape = {a: int(shape.get(a, 1)) for a in MESH_AXES}
        self.size = math.prod(self.shape.values())
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        self.coords = coords_of(self.shape, rank)
        self.comm = comm

    def axis_ranks(self, axis: str) -> list[int]:
        return axis_ranks(self.shape, self.rank, axis)

    def __repr__(self) -> str:
        live = {a: s for a, s in self.shape.items() if s > 1}
        return f"Mesh({live or {'dp': 1}}, rank={self.rank})"


def single_device_mesh() -> Mesh:
    """The mesh of the single-process path: every axis of size 1."""
    return Mesh({a: 1 for a in MESH_AXES})


def check_dcn(cfg: MeshConfig, sizes: dict[str, int]) -> None:
    """``mesh.dcn_dp``: the dp axis spans that many slices (hosts), so it
    must divide dp (the JAX package's ``build_mesh``)."""
    if cfg.dcn_dp < 1:
        raise ValueError(f"mesh.dcn_dp={cfg.dcn_dp} must be >= 1")
    if sizes["dp"] % cfg.dcn_dp:
        raise ValueError(
            f"dp={sizes['dp']} not divisible by dcn_dp={cfg.dcn_dp}")


def build_mesh(cfg: MeshConfig) -> Mesh:
    """The mesh of ``cfg`` over the ranks of the process group (one rank
    when there is none), with one group per axis larger than 1. With
    ``dcn_dp > 1`` dp member ``i`` sits on slice ``i // (dp / dcn_dp)``
    (the JAX package's member numbering: ranks are host-major and dp is
    the outermost axis, so consecutive dp members share a host), and the
    transport also holds the hierarchy's sub-groups ``dp_intra`` (this
    rank's slice) and ``dp_cross`` (its position across slices)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        sizes = axis_sizes(cfg, 1)
        check_dcn(cfg, sizes)
        return Mesh(sizes)
    from .comms import DistComm

    sizes = axis_sizes(cfg, dist.get_world_size())
    check_dcn(cfg, sizes)
    rank, n = dist.get_rank(), dist.get_world_size()
    groups = {"world": dist.group.WORLD}
    lines = {}
    for axis in MESH_AXES:
        if sizes[axis] == 1:
            continue
        # Every rank creates every group of the axis, in the same order, as
        # new_group requires; each keeps the one it belongs to.
        lines[axis] = sorted({tuple(axis_ranks(sizes, r, axis))
                              for r in range(n)})
        for ranks in lines[axis]:
            g = dist.new_group(list(ranks))
            if rank in ranks:
                groups[axis] = g
    ici = sizes["dp"] // cfg.dcn_dp
    if cfg.dcn_dp > 1 and ici > 1:
        # The hierarchy's sub-groups of every dp group (comms_hier): the
        # members of each slice, then the same position across slices.
        for sub, cut in (("dp_intra", lambda m: [m[d * ici:(d + 1) * ici]
                                               for d in range(cfg.dcn_dp)]),
                         ("dp_cross", lambda m: [m[j::ici]
                                               for j in range(ici)])):
            for members in lines["dp"]:
                for ranks in cut(list(members)):
                    g = dist.new_group(ranks)
                    if rank in ranks:
                        groups[sub] = g
    comm = DistComm(groups, stage_on_host=dist.get_backend() == "gloo")
    return Mesh(sizes, rank, comm=comm)
