"""Process meshes and sharded proving math on ``torch.distributed``.

Port of ``vdf_tpu.parallel.mesh``.  The reference has no distributed
runtime (SURVEY.md §2.4); here the mesh is first-class.  A ``Mesh`` is one
rank's view of a 1-D group of processes, each driving one device: the
process group, its size, this process's rank in it, the rank's device and
the axis name.  It stands where the JAX package's ``jax.sharding.Mesh``
stood.  Axes:

  * ``lanes`` — data-parallel independent VDF chains (no steady-state
    communication);
  * ``shard`` — the tensor-parallel axis of the proving math: MSM points
    and R1CS matrix entries partition over it, and the partial results
    meet in one collective.

Every function runs on the rank's device with the port's kernels (K1, K2,
K3-K6 and K9 through ``msm``, K10 and K12 for the field ops and the
matvec) and torch glue, and runs its
collective even on a mesh of one rank, as ``shard_map`` does on one
device.  Contiguous blocks are split evenly: rank r of s takes items
[r n / s, (r + 1) n / s).  Every rank passes the same (replicated) inputs;
each takes its own block.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..curves.msm import msm
from ..curves.point import Curve, Point, stack_point, unstack_point
from ..fields import NLIMBS, Field
from ..minroot.vdf import State

LANES_AXIS = "lanes"
SHARD_AXIS = "shard"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of a 1-D process mesh (compared by identity:
    ``make_mesh`` returns the same object for the same request)."""

    group: object  # torch.distributed ProcessGroup; None is the default group
    size: int  # ranks in the mesh
    rank: int  # this process's rank in the mesh
    device: torch.device  # the rank's device
    axis: str = LANES_AXIS


def _dist():
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.distributed.initialize first")
    return dist


def make_mesh(n_devices: int | None = None, axis: str = LANES_AXIS) -> Mesh:
    """A mesh over the first ``n_devices`` ranks of the initialized process
    group (default: all of them).  Every rank of the group calls it (a mesh
    smaller than the group is a new process group, made collectively); a
    rank outside the mesh gets ValueError."""
    dist = _dist()
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a process group of {world}")
    mesh = _make_mesh(n, axis, dist.group.WORLD)
    if mesh.rank >= n:
        raise ValueError(f"rank {mesh.rank} is not in a mesh of the first {n} ranks")
    return mesh


@functools.lru_cache(maxsize=16)
def _make_mesh(n: int, axis: str, world) -> Mesh:
    from .distributed import rank_device

    dist = _dist()
    group = None if n == dist.get_world_size() else dist.new_group(list(range(n)))
    return Mesh(group, n, dist.get_rank(), rank_device(), axis)


def _block(mesh: Mesh, n: int) -> slice:
    return slice(mesh.rank * n // mesh.size, (mesh.rank + 1) * n // mesh.size)


def lane_sharding(mesh: Mesh, lanes: int) -> slice:
    """The rank's contiguous lanes of a batch of ``lanes``."""
    return _block(mesh, lanes)


def shard_state(state: State, mesh: Mesh) -> State:
    """The rank's lanes of a (lanes, 8) state, on the rank's device."""
    sl = lane_sharding(mesh, state.x.shape[0])
    return State(*(a[sl].to(mesh.device).contiguous() for a in state))


def sharded_eval(vdf, t: int, mesh: Mesh):
    """-> fn(state): t slow rounds (K1) on the rank's lanes of ``state``;
    returns the rank's shard of the result, as the reference's
    out-sharding leaves it.  Pure data parallelism: no collective."""

    def run(state: State) -> State:
        return vdf.eval(shard_state(state, mesh), t)

    return run


def sharded_check(vdf, t: int, mesh: Mesh):
    """-> fn(result, original): verify the rank's lanes by inverting (K2),
    count the valid ones, and sum the counts over the mesh with one
    ``all_reduce(SUM)`` of an int64 (the reference's ``psum``).  Returns
    the mesh's count of valid lanes, the same on every rank."""

    def check(result: State, original: State) -> int:
        ok = vdf.check(shard_state(result, mesh), t, shard_state(original, mesh))
        count = ok.to(torch.int64).sum().reshape(1).to(mesh.device)
        _dist().all_reduce(count, group=mesh.group)
        return int(count.item())

    return check


def sharded_matvec(field: Field, dev_mat, z: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Entry-sharded sparse matvec: each rank multiplies its contiguous
    block of the row-sorted COO entries with the port's ``DeviceMatrix``
    arithmetic (K12 on the card; the block's CSR offsets come from
    ``torch.searchsorted`` on its rows, so its first and last rows may be
    partial), giving canonical partial row vectors (num_rows, 8); the partials are
    ``all_gather``ed and field-added in rank order, so every rank holds the
    same canonical M @ z.  z is replicated.

    The reference sums its unreduced limbs with ``psum``.  That does not
    carry over: the port's limbs are 32-bit Montgomery residues, and an
    integer sum of residues is not their field sum."""
    from ..nova.r1cs_device import DeviceMatrix

    sl = _block(mesh, dev_mat.rows.shape[0])
    local = DeviceMatrix(dev_mat.rows[sl], dev_mat.cols[sl], dev_mat.vals[sl], dev_mat.num_rows)
    part = local.matvec(field, z).contiguous()
    parts = [torch.empty_like(part) for _ in range(mesh.size)]
    _dist().all_gather(parts, part, group=mesh.group)
    acc = parts[0]
    for q in parts[1:]:
        acc = field.add(acc, q)
    return acc


def _tree_sum(curve: Curve, pts: Point) -> Point:
    """Sum of a Point of (k, 8) coordinates by pairwise adds, in order."""
    while pts.x.shape[0] > 1:
        if pts.x.shape[0] % 2:
            ident = curve.identity((1,), pts.x.device)
            pts = Point(*(torch.cat([v, w]) for v, w in zip(pts, ident)))
        pts = curve.add(Point(*(v[0::2] for v in pts)), Point(*(v[1::2] for v in pts)))
    return Point(*(v[0] for v in pts))


def sharded_msm(curve: Curve, points: Point, scalars: torch.Tensor, mesh: Mesh) -> Point:
    """Mesh-sharded MSM: sum_i scalars[i] points[i].  The inputs are padded
    to a multiple of the mesh size with zero scalars (their digits land in
    bucket 0); each rank runs the port's ``msm`` on its block (K3 window
    rows, the sort, K4-K6, K9); the partial points are ``all_gather``ed (one
    point a rank) and tree-summed with the group law.  Returns one
    projective point ((8,) coordinates), the same on every rank."""
    n = points.x.shape[0]
    pad = (-n) % mesh.size
    if pad:
        scalars = torch.cat([scalars, scalars.new_zeros((pad, NLIMBS))])
        points = Point(*(torch.cat([v, v[-1:].expand(pad, NLIMBS)]) for v in points))
    sl = _block(mesh, n + pad)
    part = stack_point(msm(curve, Point(*(v[sl] for v in points)), scalars[sl])).contiguous()
    parts = [torch.empty_like(part) for _ in range(mesh.size)]
    _dist().all_gather(parts, part, group=mesh.group)
    return _tree_sum(curve, unstack_point(torch.stack(parts)))
