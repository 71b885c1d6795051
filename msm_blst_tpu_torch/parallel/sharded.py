"""Sharded MSM over torch.distributed (port of msm_blst_tpu/parallel/
sharded.py): the counterpart of the reference's thread-pool tile
decomposition (reference bindings/rust/src/lib.rs:1804-1949, 2026-2062).

One process a shard. Every function here runs on every rank of the group;
each rank holds only its own rows of the tables, and every rank returns
the same point (its Jacobian words may differ from rank to rank). Meshes
are torch DeviceMeshes with the JAX package's dimension names, "points"
and "windows"; a dimension's process group is `mesh.get_group(name)`.

* Points axis ("i"-layout plans, `shard_plan_tables`): a rank holds a
  contiguous block of the fixed points and their table rows (slot
  3*(i*h+j)+m-1 / i*h'+j: a block of points is a block of rows), recodes
  its own columns of the scalars and accumulates a private bucket array.
* Window blocks ("j"-layout plans, `shard_plan_tables_jmajor`): a rank
  holds a block of whole windows (rows 3*(j*n+i)+m-1 / j*n+i), h padded to
  a multiple of the axis with replicas of window 0's rows, which only the
  zero digits of the padded windows read (bucket 0, weight 0). It recodes
  every scalar and keeps its own windows' digits. This shards the big-n
  tables.
* The 2-D mesh ("points" x "windows", `sharded_msm_ches_2d`): the points
  axis over the tables, the windows axis over the digit stream.
* The bucket arrays meet in `ec_allreduce_xyzz`: an XOR butterfly whose
  combiner is the curve's group law (K2's dadd at the bucket width),
  log2(D) rounds of one exchange each. The integration runs on every rank.

Each `sharded_msm_*` returns a `ShardedQuery`: called on the global
int32[8, n] scalars it returns the rank's Jacobian result; its stages
(`local`, `allreduce`, `integrate`) can be run and timed apart
(`stage_ms`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..curves.ops import AffinePoint, CurveOps, JacPoint, PackedRows32, XyzzPoint
from ..device import resolve
from ..msm import engine, recode
from ..msm.engine import (MsmPlan, integrate_gapped,
                          integrate_weighted_consecutive)
from ..utils.profiling import sync

POINTS, WINDOWS = "points", "windows"


def _mesh(shape, names, device_type) -> DeviceMesh:
    """A mesh of `shape` over every rank of the default group, on
    `device_type` (None: the card's, raising without one)."""
    world = dist.get_world_size()
    size = 1
    for s in shape:
        size *= s
    if size != world:
        raise ValueError(f"a mesh of shape {shape} needs {size} ranks; the "
                         f"process group has {world}")
    return init_device_mesh(resolve(device_type).type, tuple(shape),
                            mesh_dim_names=names)


def make_points_mesh(n_devices: int | None = None,
                     device_type: str | None = None) -> DeviceMesh:
    """A 1-D mesh "points" over the default group's n_devices ranks (all of
    them by default; another count raises). device_type: "cuda" (the
    default) or "cpu"."""
    return _mesh((n_devices or dist.get_world_size(),), (POINTS,), device_type)


def make_windows_mesh(n_devices: int | None = None,
                      device_type: str | None = None) -> DeviceMesh:
    """A 1-D mesh "windows" over the default group's ranks."""
    return _mesh((n_devices or dist.get_world_size(),), (WINDOWS,),
                 device_type)


def make_2d_mesh(n_points_axis: int, n_windows_axis: int,
                 device_type: str | None = None) -> DeviceMesh:
    """A ("points", "windows") mesh over all ranks: rank p * n_windows_axis
    + w sits at (p, w), as jax.make_mesh lays out the devices."""
    return _mesh((n_points_axis, n_windows_axis), (POINTS, WINDOWS),
                 device_type)


def _axis(mesh: DeviceMesh, name: str):
    """(this rank's coordinate, the axis's size, its process group)."""
    if name not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"the mesh has no {name!r} axis "
                         f"({mesh.mesh_dim_names})")
    return (mesh.get_local_rank(name),
            mesh.size(mesh.mesh_dim_names.index(name)), mesh.get_group(name))


# ---------------------------------------------------------------------------
# the EC all-reduce
# ---------------------------------------------------------------------------


def butterfly_peers(group) -> list:
    """The global ranks this rank exchanges with, round by round: group
    rank `rank ^ step` for step = 1, 2, 4, ... below the group's size D.
    D must be a power of two (XOR partnering is a permutation only then);
    D = 1 has no round."""
    D = dist.get_world_size(group)
    if D & (D - 1):
        raise ValueError(
            f"ec_allreduce_xyzz: the group has {D} ranks; the XOR butterfly "
            "requires a power of two (use a 2-D mesh or pad the rank list)")
    me = dist.get_rank(group)
    peers, step = [], 1
    while step < D:
        peers.append(dist.get_global_rank(group, me ^ step))
        step *= 2
    return peers


def _sendrecv(buf: torch.Tensor, peer: int, group) -> torch.Tensor:
    """Send `buf` to global rank `peer` and receive its buffer of the same
    shape, one isend and one irecv in one batch. An NCCL group moves CUDA
    tensors directly. Gloo's point-to-point takes host tensors, so on a
    gloo group a CUDA buffer goes through pinned host memory both ways
    (the buffer sent and the one received)."""
    backend = str(dist.get_backend(group))
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"ec_allreduce_xyzz: backend {backend!r} is not "
                         "supported (gloo or nccl)")
    if backend == "nccl" and not buf.is_cuda:
        raise ValueError("ec_allreduce_xyzz: an NCCL group needs CUDA tensors")
    staged = backend == "gloo" and buf.is_cuda
    send = (torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
            .copy_(buf) if staged else buf)
    out = torch.empty_like(send, pin_memory=staged)
    for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, send, peer, group),
                                       dist.P2POp(dist.irecv, out, peer, group)]):
        req.wait()
    return out.to(buf.device) if staged else out


def exchange_xyzz(pts: XyzzPoint, peer: int, group) -> XyzzPoint:
    """The xyzz batch of global rank `peer` for this rank's `pts`, the four
    coordinates packed into one message."""
    got = _sendrecv(torch.stack(tuple(pts)), peer, group)
    return XyzzPoint(*got.unbind(0))


def _run(_stage: str, fn):
    return fn()


def ec_allreduce_xyzz(curve: CurveOps, pts: XyzzPoint, group,
                      stage=_run) -> XyzzPoint:
    """All-reduce a batch of xyzz points over `group` with the group law as
    combiner: in each of log2(D) rounds, one exchange with the butterfly's
    partner (exchange_xyzz) and one lane-wise dadd (K2 on the card). The
    group's backend sets the transport: on gloo, whose point-to-point
    takes host tensors, CUDA buffers are staged through pinned host memory;
    on NCCL they go directly; another backend raises. Each step runs as
    stage("exchange_ms" or "dadd_ms", step) (ShardedQuery.stage_ms times
    them)."""
    for peer in butterfly_peers(group):
        other = stage("exchange_ms", lambda: exchange_xyzz(pts, peer, group))
        pts = stage("dadd_ms", lambda: curve.xyzz_dadd(pts, other))
    return pts


STAGES = ("local_ms", "exchange_ms", "dadd_ms", "allreduce_ms",
          "integrate_ms", "total_ms")


@dataclasses.dataclass(frozen=True)
class ShardedQuery:
    """One rank's sharded query in three stages: `local(scalars)` (the
    global int32[8, n] scalars -> this rank's private bucket array),
    `allreduce(buckets)` (ec_allreduce_xyzz over `groups`, in order) and
    `integrate(buckets)` (-> Jacobian); calling it runs the three."""

    curve: CurveOps
    local: Callable
    groups: tuple
    integrate: Callable

    def allreduce(self, buckets: XyzzPoint, stage=_run) -> XyzzPoint:
        for group in self.groups:
            buckets = ec_allreduce_xyzz(self.curve, buckets, group, stage)
        return buckets

    def rounds(self) -> int:
        """The butterfly's rounds, all groups together."""
        return sum(dist.get_world_size(g).bit_length() - 1 for g in self.groups)

    def __call__(self, scalars: torch.Tensor) -> JacPoint:
        return self.integrate(self.allreduce(self.local(scalars)))

    def stage_ms(self, scalars: torch.Tensor, reps: int = 1) -> dict:
        """This rank's query stage by stage on the host's clock, each
        stage ended by a barrier of the device: the local accumulation,
        the all-reduce's exchanges (the wait for the partner included) and
        its dadds (K2 on the card), their sum, the integration, then the
        whole query run again; the median of each over `reps` runs (STAGES),
        with the butterfly's `rounds`. Every rank of the groups calls it
        together."""
        dev = scalars.device
        runs = []
        for _ in range(reps):
            row = dict.fromkeys(STAGES, 0.0)

            def timed(name, fn):
                sync(dev)
                t0 = time.perf_counter()
                out = fn()
                sync(dev)
                row[name] += (time.perf_counter() - t0) * 1e3
                return out

            b = timed("local_ms", lambda: self.local(scalars))
            b = self.allreduce(b, timed)
            row["allreduce_ms"] = row["exchange_ms"] + row["dadd_ms"]
            timed("integrate_ms", lambda: self.integrate(b))
            timed("total_ms", lambda: self(scalars))
            runs.append(row)
        out = {k: sorted(r[k] for r in runs)[len(runs) // 2] for k in STAGES}
        out["rounds"] = self.rounds()
        return out


def _gapped(plan: MsmPlan):
    curve = plan.curve
    return lambda b: curve.xyzz_to_jac(
        integrate_gapped(curve, b, plan.gap_groups))


def _weighted(plan: MsmPlan):
    curve = plan.curve
    return lambda b: curve.xyzz_to_jac(integrate_weighted_consecutive(curve, b))


def _check_n(where: str, scalars: torch.Tensor, n: int) -> None:
    if scalars.shape[1] != n:
        raise ValueError(f"{where}: the plan's shard expects the scalars of "
                         f"{n} points, got {scalars.shape[1]} (was the plan "
                         "sharded for this mesh?)")


def _packed(plan: MsmPlan) -> torch.Tensor:
    if plan.packed_table is None:
        raise ValueError("the port's sharded CHES query needs the packed "
                         "digit table (build_plan attaches it)")
    return plan.packed_table


# ---------------------------------------------------------------------------
# points axis ("i" layout)
# ---------------------------------------------------------------------------


def _require_i_layout(plan: MsmPlan, where: str) -> None:
    if plan.layout != "i":
        raise ValueError(
            f"{where}: the sharded MSM paths assume i-major table slots; "
            f"got layout={plan.layout!r}. Rebuild the plan with "
            "build_plan(..., streamed=False).")


def _n_points(plan: MsmPlan) -> int:
    """The points a plan's tables cover."""
    cfg = plan.cfg
    if plan.table3nh is not None:
        return plan.table3nh.XY.shape[0] // (3 * cfg.h)
    if plan.table_nh is not None:
        return plan.table_nh.XY.shape[0] // cfg.h_bgmw
    raise ValueError("the plan holds no CHES or BGMW table")


def shard_plan_tables(plan: MsmPlan, mesh: DeviceMesh) -> MsmPlan:
    """This rank's plan of the points axis: of the n points, the block [i0,
    i1) of its coordinate on "points" (n/D each), with rows 3h*i0 ...
    3h*i1 of the 3nh table, h'*i0 ... h'*i1 of the nh table, its points and
    their stock rows, each a copy (the full tables can be freed); the small
    tables (packed digit tables, gap constants) whole. Requires the "i"
    layout: in the "j" layout a block of rows is a block of windows."""
    if plan.layout != "i":
        raise ValueError(
            "shard_plan_tables: points-axis sharding requires the i-major "
            f"table layout; this plan has layout={plan.layout!r} (built with "
            "streamed=True). Rebuild with build_plan(..., streamed=False) "
            "for mesh sharding.")
    p, D, _ = _axis(mesh, POINTS)
    n = _n_points(plan)
    if n % D:
        raise ValueError(f"shard_plan_tables: {n} points do not split over "
                         f"{D} ranks")
    i0, i1 = p * (n // D), (p + 1) * (n // D)

    def rows(table, per_point: int):
        return None if table is None else PackedRows32(
            table.XY[per_point * i0:per_point * i1].clone())

    return dataclasses.replace(
        plan, table3nh=rows(plan.table3nh, 3 * plan.cfg.h),
        table_nh=rows(plan.table_nh, plan.cfg.h_bgmw),
        points_rows=rows(plan.points_rows, 1),
        points=None if plan.points is None else AffinePoint(
            *(x[..., i0:i1].clone() for x in plan.points)))


def _columns(where: str, scalars: torch.Tensor, p: int, D: int,
             n_loc: int) -> torch.Tensor:
    """This rank's columns [p*n_loc, (p+1)*n_loc) of the global scalars."""
    _check_n(where, scalars, n_loc * D)
    return scalars[:, p * n_loc:(p + 1) * n_loc]


def _local_ches_buckets(plan: MsmPlan, scalars: torch.Tensor,
                        bucket_impl: str = "prefix") -> XyzzPoint:
    """One shard's CHES bucket array: recode the shard's scalar columns
    (packed table) and accumulate over its own rows."""
    slots, keys, signs = engine._ches_streams(plan, scalars)
    return engine._bucket_sums_stream(plan.curve, plan.table3nh, slots, keys,
                                      signs, plan.cfg.b_size, bucket_impl)


def _local_bgmw_buckets(plan: MsmPlan, scalars: torch.Tensor,
                        bucket_impl: str = "prefix") -> XyzzPoint:
    """One shard's BGMW95 bucket array. The digits reduce the scalars mod r
    before the r - a fold (recode.bgmw_digits_device), as the
    single-device query does."""
    table, slots, keys, signs = engine._bgmw_streams(plan, scalars)
    return engine._bucket_sums_stream(plan.curve, table, slots, keys, signs,
                                      (plan.cfg.q_bgmw >> 1) + 1, bucket_impl)


def sharded_msm_ches(plan: MsmPlan, mesh: DeviceMesh,
                     bucket_impl: str = "prefix") -> ShardedQuery:
    """The points-axis CHES query of this rank's plan (shard_plan_tables):
    its columns of the scalars, its private buckets, the all-reduce over
    "points", the d-gap integration."""
    _require_i_layout(plan, "sharded_msm_ches")
    _packed(plan)
    p, D, group = _axis(mesh, POINTS)
    n_loc = _n_points(plan)

    def local(scalars):
        return _local_ches_buckets(
            plan, _columns("sharded_msm_ches", scalars, p, D, n_loc),
            bucket_impl)

    return ShardedQuery(plan.curve, local, (group,), _gapped(plan))


def sharded_msm_bgmw(plan: MsmPlan, mesh: DeviceMesh,
                     bucket_impl: str = "prefix") -> ShardedQuery:
    """The points-axis BGMW95 query of this rank's plan: its own nh table,
    or the 3nh table's m=1 rows (bgmw_stride3)."""
    _require_i_layout(plan, "sharded_msm_bgmw")
    p, D, group = _axis(mesh, POINTS)
    table, stride = engine.bgmw_table(plan)
    n_loc = table.XY.shape[0] // (stride * plan.cfg.h_bgmw)

    def local(scalars):
        return _local_bgmw_buckets(
            plan, _columns("sharded_msm_bgmw", scalars, p, D, n_loc),
            bucket_impl)

    return ShardedQuery(plan.curve, local, (group,), _weighted(plan))


# ---------------------------------------------------------------------------
# the 2-D mesh: points x windows (the Rust breakdown() analog, reference
# bindings/rust/src/lib.rs:2026-2062)
# ---------------------------------------------------------------------------


def breakdown(n_points: int, n_devices: int, h: int):
    """Pick the (points, windows) mesh shape: prefer the points axis
    (embarrassingly parallel); open the window axis when point shards would
    drop below ~256 lanes (the Rust policy's shape, lib.rs:2026-2062).
    Window padding (_pad_table_windows / _window_block) removes the old
    h % (nw*2) == 0 divisibility requirement — h=13 configs now open the
    axis too; only nw <= h is required (>=1 real window per shard)."""
    nw = 1
    np_ = n_devices
    while np_ > 1 and n_points // np_ < 256 and nw * 2 <= h:
        np_ //= 2
        nw *= 2
    return np_, nw


def sharded_msm_ches_2d(plan: MsmPlan, mesh: DeviceMesh,
                        bucket_impl: str = "prefix") -> ShardedQuery:
    """CHES over a ("points", "windows") mesh: the tables shard over
    "points" (shard_plan_tables); each rank recodes its points' scalars and
    keeps the digits of its h/W windows (CHES windows are independent
    stream elements: no doublings between them), accumulates its buckets,
    then the all-reduce over "windows" and over "points"."""
    _require_i_layout(plan, "sharded_msm_ches_2d")
    cfg = plan.cfg
    p, D, g_points = _axis(mesh, POINTS)
    w, W, g_windows = _axis(mesh, WINDOWS)
    if cfg.h % W:
        raise ValueError(f"sharded_msm_ches_2d: the windows axis ({W}) must "
                         f"divide h ({cfg.h})")
    h_loc = cfg.h // W
    j0 = w * h_loc
    n_loc = _n_points(plan)
    packed = _packed(plan)

    def local(scalars):
        cols = _columns("sharded_msm_ches_2d", scalars, p, D, n_loc)
        keys, m1, s = recode.ches_recode_device_packed(cols, cfg.c, cfg.h,
                                                       packed)
        dev = cols.device
        i_idx = torch.arange(n_loc, dtype=torch.int32, device=dev)[None, :]
        j_idx = torch.arange(j0, j0 + h_loc, dtype=torch.int32,
                             device=dev)[:, None]
        slots = engine.ches_slots(i_idx, j_idx, m1[j0:j0 + h_loc], cfg.h)
        return engine._bucket_sums_stream(
            plan.curve, plan.table3nh, slots.reshape(-1),
            keys[j0:j0 + h_loc].reshape(-1), s[j0:j0 + h_loc].reshape(-1),
            cfg.b_size, bucket_impl)

    return ShardedQuery(plan.curve, local, (g_windows, g_points),
                        _gapped(plan))


# ---------------------------------------------------------------------------
# window blocks of "j"-layout (streamed, big-n) plans: rows 3*(j*n+i)+m-1 /
# j*n+i are window-contiguous, so a block of rows is a block of whole
# windows; CHES and BGMW windows are independent digit streams, so window
# shards need only the bucket all-reduce (reference bindings/rust/src/
# lib.rs:1836-1948, 2026-2062)
# ---------------------------------------------------------------------------


def _require_j_layout(plan: MsmPlan, where: str) -> None:
    if plan.layout != "j":
        raise ValueError(
            f"{where}: window-block sharding assumes j-major (window-"
            f"contiguous) table rows; got layout={plan.layout!r}. Use the "
            "points-axis paths (shard_plan_tables + sharded_msm_*) for "
            "i-major plans, or rebuild with build_plan(..., streamed=True).")


def _window_rows(xy: torch.Tensor, rows_per_window: int, h: int, j0: int,
                 h_loc: int) -> torch.Tensor:
    """A copy of the rows of windows [j0, j0 + h_loc) of the table `xy` of
    h windows, padded with replicas of window 0's rows past window h - 1."""
    parts = []
    if j0 < h:
        parts.append(xy[j0 * rows_per_window:min(j0 + h_loc, h)
                        * rows_per_window])
    pad = j0 + h_loc - max(j0, h)
    if pad > 0:
        parts.append(xy[:rows_per_window].repeat(pad, 1))
    return torch.cat(parts)


def _pad_table_windows(table: PackedRows32, rows_per_window: int, h: int,
                       h_pad: int) -> PackedRows32:
    """The table padded from h to h_pad windows with replicas of window 0's
    rows, so the row axis splits evenly over the mesh. The replicas are
    valid curve points but only ever gathered by the padded windows' zero
    digits, whose bucket every integration weights by zero."""
    if h_pad == h:
        return table
    return PackedRows32(_window_rows(table.XY, rows_per_window, h, 0, h_pad))


def shard_plan_tables_jmajor(plan: MsmPlan, mesh: DeviceMesh) -> MsmPlan:
    """This rank's plan of the "windows" axis: of each table of h windows,
    padded to h_pad = ceil(h/D)*D (_pad_table_windows), the rows of the
    rank's block of h_pad/D windows, a copy; the small tables whole; no
    points or stock rows (the window paths do not read them)."""
    _require_j_layout(plan, "shard_plan_tables_jmajor")
    w, D, _ = _axis(mesh, WINDOWS)
    n = _n_points(plan)
    cfg = plan.cfg

    def block(table, h: int, rows_per_window: int):
        if table is None:
            return None
        h_loc = -(-h // D)
        return PackedRows32(_window_rows(table.XY, rows_per_window, h,
                                         w * h_loc, h_loc))

    return dataclasses.replace(
        plan, table3nh=block(plan.table3nh, cfg.h, 3 * n),
        table_nh=block(plan.table_nh, cfg.h_bgmw, n), points=None,
        points_rows=None)


def _window_block(arrs, j0: int, h_loc: int, h: int, h_pad: int):
    """Rows [j0, j0 + h_loc) of [h, n] digit arrays zero-padded to h_pad
    rows (a padded window's digits land in bucket 0: key 0, m = 1, sign
    +)."""
    out = []
    for a in arrs:
        if h_pad > h:
            a = torch.cat([a, a.new_zeros((h_pad - h,) + tuple(a.shape[1:]))])
        out.append(a[j0:j0 + h_loc])
    return out


def _window_shard(mesh: DeviceMesh, h: int, table, rows_per_point: int):
    """(coordinate, D, group, h_loc, h_pad, n) of a window-sharded table of
    h windows whose blocks hold rows_per_point rows a point a window."""
    w, D, group = _axis(mesh, WINDOWS)
    h_loc = -(-h // D)
    n = table.XY.shape[0] // (rows_per_point * h_loc)
    return w, D, group, h_loc, h_loc * D, n


def sharded_msm_ches_windows(plan: MsmPlan, mesh: DeviceMesh,
                             bucket_impl: str = "prefix") -> ShardedQuery:
    """CHES with the table and the digit stream sharded over "windows":
    every rank recodes all the scalars, keeps its own window block and
    accumulates its buckets over its local rows (local slot
    3*(j_loc*n + i) + m-1), then the all-reduce."""
    _require_j_layout(plan, "sharded_msm_ches_windows")
    cfg = plan.cfg
    h = cfg.h
    w, _, group, h_loc, h_pad, n = _window_shard(mesh, h, plan.table3nh, 3)
    packed = _packed(plan)

    def local(scalars):
        _check_n("sharded_msm_ches_windows", scalars, n)
        keys, m1, s = recode.ches_recode_device_packed(scalars, cfg.c, h,
                                                       packed)
        kl, ml, sl = _window_block((keys, m1, s), w * h_loc, h_loc, h, h_pad)
        dev = scalars.device
        i_idx = torch.arange(n, dtype=torch.int32, device=dev)[None, :]
        jl_idx = torch.arange(h_loc, dtype=torch.int32, device=dev)[:, None]
        slots = engine.ches_slots(i_idx, jl_idx, ml, h_loc, n, "j")
        return engine._bucket_sums_stream(
            plan.curve, plan.table3nh, slots.reshape(-1), kl.reshape(-1),
            sl.reshape(-1), cfg.b_size, bucket_impl)

    return ShardedQuery(plan.curve, local, (group,), _gapped(plan))


def sharded_msm_bgmw_windows(plan: MsmPlan, mesh: DeviceMesh,
                             bucket_impl: str = "prefix") -> ShardedQuery:
    """The BGMW95 twin of sharded_msm_ches_windows, on its own nh table or
    on the stride-3 aliased 3nh table (local slot j_loc*n + i at row
    3*(j_loc*n + i))."""
    _require_j_layout(plan, "sharded_msm_bgmw_windows")
    cfg = plan.cfg
    c, h = cfg.c_bgmw, cfg.h_bgmw
    aliased = plan.table_nh is None and plan.bgmw_stride3
    if aliased and cfg.h != h:
        raise ValueError("stride-3 aliasing requires matching radixes")
    table, stride = engine.bgmw_table(plan)
    w, _, group, h_loc, h_pad, n = _window_shard(mesh, h, table, stride)

    def local(scalars):
        _check_n("sharded_msm_bgmw_windows", scalars, n)
        absd, sign = recode.bgmw_digits_device(scalars, c, h)
        al, sl = _window_block((absd, sign), w * h_loc, h_loc, h, h_pad)
        dev = scalars.device
        i_idx = torch.arange(n, dtype=torch.int32, device=dev)[None, :]
        jl_idx = torch.arange(h_loc, dtype=torch.int32, device=dev)[:, None]
        slots = engine.bgmw_slots(i_idx, jl_idx, h_loc, n, "j") * stride
        return engine._bucket_sums_stream(
            plan.curve, table, slots.reshape(-1), al.reshape(-1),
            sl.reshape(-1), (cfg.q_bgmw >> 1) + 1, bucket_impl)

    return ShardedQuery(plan.curve, local, (group,), _weighted(plan))
