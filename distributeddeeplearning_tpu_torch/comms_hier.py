"""Hierarchical gradient collectives over a data-parallel axis that spans
slices: the counterpart of the JAX package's ``comms_hier.py``.

With ``mesh.dcn_dp > 1`` the dp axis is ``dcn_dp`` slices of ``ici = dp /
dcn_dp`` members each. On GPUs a slice is a host: ``torchrun`` and ``cli
launch`` number ranks host-major, and dp is the outermost mesh axis, so dp
member ``i`` sits in slice ``d = i // ici`` at slice-local position ``j = i
% ici`` (the JAX package's member numbering). Members of a slice talk over
the fast intra-host links, members at the same position of different
slices over the network. A flat all-reduce ships the full payload across
the network; the hierarchical one cuts those bytes by ``ici``:

1. **intra-slice reduce-scatter** — each member ends with a 1/ici shard of
   its slice's partial sum;
2. **cross-slice all-reduce** of that shard among same-position peers —
   the only cross-slice traffic, ``payload / ici`` bytes;
3. **intra-slice all-gather** of the reduced shards.

The intra- and cross-slice groups are ``torch.distributed`` groups that
``mesh.build_mesh`` makes (``<axis>_intra`` and ``<axis>_cross`` in the
transport's groups); every rank creates all of them in the same order.

**Sharded update**: the cross-slice step becomes a reduce-scatter too,
leaving member ``(d, j)`` with global chunk ``j * dcn + d``
(:meth:`HierTopology.chunk_index`); the param refresh reverses it with a
two-phase all-gather (cross, then intra).

**Wire formats** compose as in ``comms_overlap``: fp32 buckets use the
grouped collectives; bf16/int8 buckets ride the ``comms_quant`` codec on
grouped rings, with error feedback once per bucket before the first hop.
Hierarchical summation re-associates the fp32 sum, so it agrees with the
flat all-reduce to fp32 rounding, not bitwise.
"""

from __future__ import annotations

import dataclasses

import torch

from .comms_overlap import BucketLayout, _ef_flat
from .comms_quant import (
    DEFAULT_BLOCK_SIZE,
    Ring,
    _compress,
    _decompress,
    _ring_all_reduce,
    _ring_hop,
    _ring_reduce_scatter,
)

HIERARCHY_MODES: tuple[str, ...] = ("flat", "hierarchical", "auto")


@dataclasses.dataclass(frozen=True)
class HierTopology:
    """Static shape of the hierarchical decomposition: ``n`` dp members in
    ``dcn`` slices of ``ici = n // dcn`` members."""

    n: int
    dcn: int

    def __post_init__(self):
        if self.dcn < 2:
            raise ValueError(
                f"HierTopology needs dcn >= 2 (got {self.dcn}): with one "
                "slice there is no cross-slice phase to split off"
            )
        if self.n % self.dcn:
            raise ValueError(
                f"dp={self.n} not divisible by dcn_dp={self.dcn}"
            )
        if self.n // self.dcn < 2:
            raise ValueError(
                f"dp={self.n} / dcn_dp={self.dcn} leaves ici_size=1: every "
                "member is its own slice and 'hierarchical' degenerates to "
                "a flat DCN all-reduce — use comm_hierarchy='flat'"
            )

    @property
    def ici(self) -> int:
        return self.n // self.dcn

    def intra_groups(self) -> tuple[tuple[int, ...], ...]:
        """The members of each slice."""
        return tuple(tuple(d * self.ici + j for j in range(self.ici))
                     for d in range(self.dcn))

    def cross_groups(self) -> tuple[tuple[int, ...], ...]:
        """Same slice-local position across all slices."""
        return tuple(tuple(d * self.ici + j for d in range(self.dcn))
                     for j in range(self.ici))

    def chunk_index(self, member_index: int) -> int:
        """Global 1/n chunk owned by dp member ``i`` after intra-slice THEN
        cross-slice reduce-scatter: ``(i % ici) * dcn + i // ici``."""
        return (member_index % self.ici) * self.dcn + member_index // self.ici

    def intra_perm(self) -> list[tuple[int, int]]:
        """The ring within each slice: ``(d,j) -> (d, j+1 mod ici)``."""
        return [(d * self.ici + j, d * self.ici + (j + 1) % self.ici)
                for d in range(self.dcn) for j in range(self.ici)]

    def cross_perm(self) -> list[tuple[int, int]]:
        """The ring across slices: ``(d,j) -> (d+1 mod dcn, j)``."""
        return [(d * self.ici + j, ((d + 1) % self.dcn) * self.ici + j)
                for d in range(self.dcn) for j in range(self.ici)]


def resolve_hierarchy(comm_hierarchy: str, dcn_dp: int) -> bool:
    """Whether the hierarchical path is active: explicit 'hierarchical', or
    'auto' on a hybrid mesh (``dcn_dp > 1``). 'flat' never."""
    if comm_hierarchy not in HIERARCHY_MODES:
        raise ValueError(
            f"train.comm_hierarchy={comm_hierarchy!r} not in "
            f"{HIERARCHY_MODES}"
        )
    if comm_hierarchy == "hierarchical":
        return True
    return comm_hierarchy == "auto" and dcn_dp > 1


def check_comm_hierarchy_config(*, comm_hierarchy: str, dcn_dp: int,
                                dp: int | None = None) -> None:
    """Config-time fences for the hierarchy knobs, by name (``cli.build_all``
    calls this before any build; the Trainer re-checks with the real dp):
    unknown mode; 'hierarchical' with one slice; a slice count that does
    not divide dp; ici_size == 1."""
    if dcn_dp < 1:
        raise ValueError(f"mesh.dcn_dp={dcn_dp} must be >= 1")
    use = resolve_hierarchy(comm_hierarchy, dcn_dp)
    if comm_hierarchy == "hierarchical" and dcn_dp == 1:
        raise ValueError(
            "train.comm_hierarchy='hierarchical' requires mesh.dcn_dp > 1: "
            "with a single slice there is no cross-slice phase — use "
            "'flat' or 'auto'"
        )
    if use and dp is not None:
        HierTopology(n=dp, dcn=dcn_dp)


def rings(mesh, topo: HierTopology, axis: str = "dp") -> tuple[Ring, Ring]:
    """This rank's (intra-slice ring, cross-slice ring) over ``axis``."""
    members = mesh.axis_ranks(axis)
    i = mesh.coords[axis]
    j, d = i % topo.ici, i // topo.ici
    intra = Ring(mesh, f"{axis}_intra",
                 tuple(members[m] for m in topo.intra_groups()[d]), j)
    cross = Ring(mesh, f"{axis}_cross",
                 tuple(members[m] for m in topo.cross_groups()[j]), d)
    return intra, cross


def _comm(mesh):
    from .comms import _comm

    return _comm(mesh, "hierarchical collective")


# ---------------------------------------------------------------------------
# fp32 hierarchical collectives (grouped torch.distributed calls)
# ---------------------------------------------------------------------------


def _gather(comm, shard: torch.Tensor, group: str, n: int) -> torch.Tensor:
    out = torch.empty(shard.numel() * n, dtype=shard.dtype,
                      device=shard.device)
    return comm.all_gather(shard.detach(), group, out)


def hier_psum(flat: torch.Tensor, mesh, topo: HierTopology,
              axis: str = "dp") -> torch.Tensor:
    """Hierarchical all-reduce-sum of a flat buffer: intra-slice
    reduce-scatter -> cross-slice all-reduce of the 1/ici shard -> intra
    all-gather. ``flat.shape[0]`` must divide by ``topo.ici``."""
    comm = _comm(mesh)
    shard = comm.reduce_scatter_sum(flat.detach(), f"{axis}_intra")
    shard = comm.all_reduce_sum(shard, f"{axis}_cross")
    return _gather(comm, shard, f"{axis}_intra", topo.ici)


def hier_psum_scatter(flat: torch.Tensor, mesh, topo: HierTopology,
                      axis: str = "dp") -> torch.Tensor:
    """Hierarchical reduce-scatter: intra-slice scatter then cross-slice
    scatter. Member ``i`` ends with global chunk ``topo.chunk_index(i)``
    of the sum."""
    comm = _comm(mesh)
    shard = comm.reduce_scatter_sum(flat.detach(), f"{axis}_intra")
    return comm.reduce_scatter_sum(shard, f"{axis}_cross")


def hier_all_gather(shard: torch.Tensor, mesh, topo: HierTopology,
                    axis: str = "dp") -> torch.Tensor:
    """Inverse of :func:`hier_psum_scatter`'s placement: cross-slice
    all-gather first (each member's contiguous intra-shard), then
    intra-slice all-gather (the full buffer in order)."""
    comm = _comm(mesh)
    intra_shard = _gather(comm, shard, f"{axis}_cross", topo.dcn)
    return _gather(comm, intra_shard, f"{axis}_intra", topo.ici)


# ---------------------------------------------------------------------------
# Quantized hierarchical collectives (grouped rings)
# ---------------------------------------------------------------------------


def hier_quantized_all_reduce_flat(flat: torch.Tensor, mesh,
                                   topo: HierTopology, *, mode: str,
                                   block_size: int = DEFAULT_BLOCK_SIZE,
                                   axis: str = "dp") -> torch.Tensor:
    """Quantized hierarchical all-reduce: intra quantized ring
    reduce-scatter -> cross quantized ring all-reduce of the 1/ici shard ->
    intra compressed-circulate all-gather. ``flat.shape[0]`` must be a
    multiple of ``topo.n * block_size``."""
    intra, cross = rings(mesh, topo, axis)
    j = intra.index
    # Intra reduce-scatter: member (d, j) reduces its slice's chunk j.
    shard = _ring_reduce_scatter(flat, intra, mode, block_size)
    # Cross all-reduce among same-position peers.
    shard = _ring_all_reduce(shard, cross, mode, block_size)
    # Intra all-gather: circulate each member's reduced shard compressed;
    # every member, the shard's owner included, uses the decompressed value.
    payload = _compress(shard, mode, block_size)
    out = shard.new_zeros((topo.ici, shard.shape[0]))
    out[j] = _decompress(payload, mode)
    for s in range(topo.ici - 1):
        payload = _ring_hop(payload, intra)
        out[(j - 1 - s) % topo.ici] = _decompress(payload, mode)
    return out.reshape(-1)


def hier_quantized_reduce_scatter_flat(flat: torch.Tensor, mesh,
                                       topo: HierTopology, *, mode: str,
                                       block_size: int = DEFAULT_BLOCK_SIZE,
                                       axis: str = "dp") -> torch.Tensor:
    """Quantized hierarchical reduce-scatter: intra ring RS then cross ring
    RS. Member ``i`` gets global chunk ``topo.chunk_index(i)``."""
    intra, cross = rings(mesh, topo, axis)
    shard = _ring_reduce_scatter(flat, intra, mode, block_size)
    return _ring_reduce_scatter(shard, cross, mode, block_size)


# ---------------------------------------------------------------------------
# Bucketed entry points (mirror comms_overlap's signatures)
# ---------------------------------------------------------------------------


def bucketed_hier_all_reduce(grads: dict, layout: BucketLayout, mesh,
                             topo: HierTopology, axis: str = "dp", *,
                             mode: str = "fp32",
                             block_size: int = DEFAULT_BLOCK_SIZE,
                             residuals=None):
    """Hierarchical ``comms_overlap.bucketed_all_reduce``: one 3-phase
    collective per bucket, the same ``(summed_tree, new_residuals)``
    contract and once-per-bucket error feedback."""
    out, new_res = [], []
    for b, flat in enumerate(layout.bucket_flat(grads)):
        res = residuals[b] if residuals is not None else None
        sent, r = _ef_flat(flat, res, mode, block_size)
        if mode == "fp32":
            out.append(hier_psum(sent, mesh, topo, axis))
        else:
            out.append(hier_quantized_all_reduce_flat(
                sent, mesh, topo, mode=mode, block_size=block_size,
                axis=axis))
        new_res.append(r)
    return layout.unbucket(out), (
        tuple(new_res) if residuals is not None else None)


def bucketed_hier_reduce_scatter(grads: dict, layout: BucketLayout, mesh,
                                 topo: HierTopology, axis: str = "dp", *,
                                 mode: str = "fp32",
                                 block_size: int = DEFAULT_BLOCK_SIZE,
                                 residuals=None):
    """Hierarchical ``comms_overlap.bucketed_reduce_scatter``: member
    ``i``'s shard is global chunk ``topo.chunk_index(i)`` of each bucket."""
    shards, new_res = [], []
    for b, flat in enumerate(layout.bucket_flat(grads)):
        res = residuals[b] if residuals is not None else None
        sent, r = _ef_flat(flat, res, mode, block_size)
        if mode == "fp32":
            shards.append(hier_psum_scatter(sent, mesh, topo, axis))
        else:
            shards.append(hier_quantized_reduce_scatter_flat(
                sent, mesh, topo, mode=mode, block_size=block_size,
                axis=axis))
        new_res.append(r)
    return tuple(shards), (tuple(new_res) if residuals is not None else None)


def hier_all_gather_buckets(shards, layout: BucketLayout, mesh,
                            topo: HierTopology, axis: str = "dp") -> dict:
    """The sharded update's param refresh under the hierarchy: the
    two-phase all-gather per bucket, then unbucket. Full precision."""
    return layout.unbucket([hier_all_gather(s, mesh, topo, axis)
                            for s in shards])


# ---------------------------------------------------------------------------
# Telemetry (benchmark.py)
# ---------------------------------------------------------------------------


def phase_wire_bytes(total_payload_bytes: float, topo: HierTopology) -> dict:
    """Per-member ring-model wire bytes of one hierarchical sync, by phase:
    intra RS moves the full payload within a slice, the cross all-reduce
    ``payload/ici`` across slices, the intra all-gather the full payload
    again."""
    p, ici, dcn = float(total_payload_bytes), topo.ici, topo.dcn
    return {
        "intra_reduce_scatter_bytes": int(p * (ici - 1) / ici),
        "cross_all_reduce_bytes": int((p / ici) * 2 * (dcn - 1) / dcn),
        "intra_all_gather_bytes": int(p * (ici - 1) / ici),
    }
