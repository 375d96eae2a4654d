"""Keyframe/map-block *state* partitioning — distributed BA that scales.

The edge-sharded path (``parallel/distributed.py``) replicates every state
array (poses, landmarks, ``hll``, the whole PCG iterate) on every device, so
per-device memory is O(whole graph) and the replicated PCG fraction bounds
scaling.  This module is the scalable design instead — the replacement, at
scale, for
the reference's whole-graph-per-request socket server
(reference remote/conn/ConnectionManagerServer.h:22-61,
remote/app/ConnectionHandler.h:14-37):

* **poses** are partitioned into contiguous keyframe blocks — device ``d``
  owns poses ``[d*Nb, (d+1)*Nb)``;
* **landmarks** (map blocks) are permuted so each device owns the landmarks
  first observed by its keyframes, padded per device to a rectangular
  ``[D, Mb]``;
* **edges** live on the device owning their observing pose;
* every device holds ONLY its block of every state array — poses,
  landmarks, ``hpp_diag``, ``hll``, gradients, PCG iterates, and the local
  preconditioner are all ``O(N/D + boundary)`` per device;
* the only cross-device traffic is **boundary exchange**: poses/landmarks
  referenced across a cut are listed once in small static registries, and
  state publication / partial-sum reduction over them is a handful of
  boundary-sized ``psum``s per operation (3 per PCG matvec) —
  never an O(N) collective.

SLAM graphs make this cheap: trajectories are chains and observations are
local, so a contiguous keyframe cut crosses few edges (the multi-loop
workload measures ~1-3% boundary at D=8).  Inner products psum scalars;
chi^2 psums once per linearization; the Galerkin coarse level is a
THREE-level hierarchy (``_coarse_build_partitioned``): each device
assembles only its row block of the coarse system and inverts its own
super-group diagonal blocks (zero-comm apply), and the only replicated
object is the super-group re-aggregation ``[dp*Nc2, dp*Nc2]`` —
O(Nc/group2), tiny — fed by one [Nc2, dp] psum per apply.  No
O(Nc)-sized replicated solve remains.

Everything funnels through ``GaussNewton`` unchanged via the
``LinearizeSolve`` interface: ``partitioned_linearize_solve(cfg, mesh)``
exposes ``prepare`` (host-side partition build + landmark permutation) and
a shard_map'd solve whose outputs are sharded exactly like its inputs, so
the outer damping loop runs on sharded global arrays under plain ``jit``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from toyslam_tpu.config import OptimizerConfig
from toyslam_tpu.models.graph import FactorGraph2D, LandmarkEdges, OdomEdges
from toyslam_tpu.ops import blockmath as bm
from toyslam_tpu.ops import edge_blocks
from toyslam_tpu.ops import schur
from toyslam_tpu.ops.schur import SolveStats

DEV_AXIS = "dev"


# ---------------------------------------------------------------------------
# plan pytree (per-device tables, leading D axis) + host-only metadata
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    """Per-device index tables for the partitioned solve.

    Every array has a leading device axis ``[D, ...]`` sharded over the
    mesh; inside shard_map each device squeezes its ``[1, ...]`` block.
    "ext" index spaces mean ``concat(local_block, boundary_buffer)``:
    poses ``[0, Nb+Bp)``, landmarks ``[0, Mb+Bl)``.
    """

    # odometry edges (local shard, padded)
    odom_i_loc: jax.Array      # i32[D,Eo] local row of pose i (always owned)
    odom_j_ext: jax.Array      # i32[D,Eo] ext index of pose j
    odom_chain_mask: jax.Array  # f32[D,Eo] 1 = consecutive j=i+1, same device
    odom_gi: jax.Array         # i32[D,Eo] global coarse-group id of pose i
    odom_gj: jax.Array         # i32[D,Eo] global coarse-group id of pose j
    # landmark edges (local shard, padded)
    lm_p_loc: jax.Array        # i32[D,El] local row of observing pose
    lm_ext: jax.Array          # i32[D,El] ext index of landmark
    lm_gp: jax.Array           # i32[D,El] global coarse-group id of pose
    # boundary-pose ownership: which registry slots this device owns
    own_bp_slot: jax.Array     # i32[D,Kp]
    own_bp_row: jax.Array      # i32[D,Kp] local pose row for each slot
    own_bp_mask: jax.Array     # f32[D,Kp]
    # boundary-landmark ownership
    own_bl_slot: jax.Array     # i32[D,Kl]
    own_bl_row: jax.Array      # i32[D,Kl]
    own_bl_mask: jax.Array     # f32[D,Kl]
    # owned landmarks whose edges are ALL local (no remote observer):
    # their coarse-fill columns are complete on this device
    lm_interior_mask: jax.Array  # f32[D,Mb]
    # static registry sizes
    n_bp: int = dataclasses.field(metadata=dict(static=True), default=0)
    n_bl: int = dataclasses.field(metadata=dict(static=True), default=0)


class PartitionMeta(NamedTuple):
    """Host-only byproducts of the partition build (not traced)."""

    n_dev: int
    nb: int                 # poses per device
    mb: int                 # landmark slots per device
    n_bp: int               # boundary-pose registry size (padded)
    n_bl: int               # boundary-landmark registry size (padded)
    old_of_new_lm: np.ndarray   # i64[D*mb] original landmark index (-1 pad)
    new_of_old_lm: np.ndarray   # i64[M] permuted landmark index
    boundary_pose_frac: float   # real boundary poses / real poses
    boundary_lm_frac: float     # real boundary landmarks / real landmarks

    def unpermute_landmarks(self, landmarks: np.ndarray,
                            num_old: int) -> np.ndarray:
        """Map optimized landmarks back to the original index order."""
        out = np.zeros((num_old,) + landmarks.shape[1:], landmarks.dtype)
        valid = self.old_of_new_lm >= 0
        out[self.old_of_new_lm[valid]] = np.asarray(landmarks)[valid]
        return out


def _idx(*parts):
    """dynamic_slice/update index tuple with literals cast to the traced
    entries' dtype: under x64 Python-int literals weak-promote to int64
    and mismatch the i32 axis indices (dynamic_slice requires one index
    dtype)."""
    dt = None
    for p in parts:
        if hasattr(p, "dtype"):
            dt = p.dtype
            break
    if dt is None:
        return parts
    return tuple(jnp.asarray(p, dt) for p in parts)


def _round_up(n: int, k: int) -> int:
    return -(-n // k) * k


def build_partition(
    graph: FactorGraph2D,
    n_dev: int,
    align: int = 64,
    coarse_group: int = 64,
) -> tuple[FactorGraph2D, PartitionMeta]:
    """Host-side partition of a (host-resident) graph into ``n_dev`` blocks.

    Returns a new FactorGraph2D whose state arrays are padded/permuted to
    rectangular per-device blocks, whose edge arrays are stacked
    ``[D, E_max, ...]`` in owner order, and whose ``plan`` is the
    :class:`PartitionPlan`, plus the host-side :class:`PartitionMeta`.
    """
    n, m = graph.num_poses, graph.num_landmarks
    align = max(align, coarse_group)
    nb = _round_up(max(1, -(-n // n_dev)), align)
    n_p = nb * n_dev

    od_i = np.asarray(graph.odom.i)
    od_j = np.asarray(graph.odom.j)
    od_mask = np.asarray(graph.odom.mask)
    lm_p = np.asarray(graph.lm_edges.pose)
    lm_l = np.asarray(graph.lm_edges.lm)
    lm_mask = np.asarray(graph.lm_edges.mask)
    real_od = od_mask > 0
    real_lm = lm_mask > 0

    owner_pose = np.minimum(np.arange(n_p) // nb, n_dev - 1)

    # --- landmark ownership: device of the first observing pose ----------
    first_edge = np.full(m, lm_l.shape[0], np.int64)
    e_idx = np.nonzero(real_lm)[0]
    np.minimum.at(first_edge, lm_l[e_idx], e_idx)
    observed = first_edge < lm_l.shape[0]
    owner_lm = np.where(
        observed,
        owner_pose[np.where(observed, lm_p[np.minimum(
            first_edge, lm_l.shape[0] - 1)], 0)],
        np.arange(m) % n_dev,  # unobserved/padding: round-robin
    )

    # --- landmark permutation into per-device contiguous blocks ----------
    dev_lists = [np.nonzero(owner_lm == d)[0] for d in range(n_dev)]
    mb = _round_up(max(max(len(l) for l in dev_lists), 1), 8)
    m_p = mb * n_dev
    old_of_new = np.full(m_p, -1, np.int64)
    for d, lst in enumerate(dev_lists):
        old_of_new[d * mb : d * mb + len(lst)] = lst
    new_of_old = np.full(m, -1, np.int64)
    valid_new = old_of_new >= 0
    new_of_old[old_of_new[valid_new]] = np.nonzero(valid_new)[0]

    def permute_lm(x, fill=0.0):
        out = np.full((m_p,) + x.shape[1:], fill, x.dtype)
        out[valid_new] = np.asarray(x)[old_of_new[valid_new]]
        return out

    landmarks = permute_lm(np.asarray(graph.landmarks))
    lm_mask_v = permute_lm(np.asarray(graph.lm_mask))
    lm_fixed_v = permute_lm(np.asarray(graph.lm_fixed))
    owner_lm_new = np.arange(m_p) // mb

    def pad_pose(x, fill=0.0):
        out = np.full((n_p,) + x.shape[1:], fill, np.asarray(x).dtype)
        out[:n] = np.asarray(x)
        return out

    poses = pad_pose(np.asarray(graph.poses))
    pose_mask_v = pad_pose(np.asarray(graph.pose_mask))
    pose_fixed_v = pad_pose(np.asarray(graph.pose_fixed))

    # --- edge -> device assignment ---------------------------------------
    dev_od = np.where(real_od, owner_pose[od_i], 0)
    lm_l_new = np.where(real_lm, new_of_old[np.where(real_lm, lm_l, 0)], 0)
    dev_lm = np.where(real_lm, owner_pose[lm_p], 0)

    # --- boundary registries ----------------------------------------------
    cross_od = real_od & (owner_pose[od_j] != dev_od)
    bp_ids = np.unique(od_j[cross_od])
    n_bp = _round_up(max(len(bp_ids), 1), 8)
    bp_slot_of = np.full(n_p, -1, np.int64)
    bp_slot_of[bp_ids] = np.arange(len(bp_ids))

    cross_lm = real_lm & (owner_lm_new[lm_l_new] != dev_lm)
    bl_ids = np.unique(lm_l_new[cross_lm])
    n_bl = _round_up(max(len(bl_ids), 1), 8)
    bl_slot_of = np.full(m_p, -1, np.int64)
    bl_slot_of[bl_ids] = np.arange(len(bl_ids))

    # --- per-device stacked edge arrays + local index tables --------------
    def stack_edges(dev_of, fields, count):
        idxs = [np.nonzero((dev_of == d) & count)[0] for d in range(n_dev)]
        cap = _round_up(max(max(len(ix) for ix in idxs), 1), 8)
        out = []
        for f in fields:
            f = np.asarray(f)
            buf = np.zeros((n_dev, cap) + f.shape[1:], f.dtype)
            for d, ix in enumerate(idxs):
                buf[d, : len(ix)] = f[ix]
            out.append(buf)
        sel_mask = np.zeros((n_dev, cap), np.float32)
        for d, ix in enumerate(idxs):
            sel_mask[d, : len(ix)] = 1.0
        return out, sel_mask, cap

    od_meas = np.asarray(graph.odom.meas)
    od_info = np.asarray(graph.odom.info)
    (s_oi, s_oj, s_om, s_oinf), od_m, eo = stack_edges(
        dev_od, [od_i, od_j, od_meas, od_info], real_od
    )
    lm_meas = np.asarray(graph.lm_edges.meas)
    lm_info = np.asarray(graph.lm_edges.info)
    (s_lp, s_ll, s_lm_, s_linf), lm_m, el = stack_edges(
        dev_lm, [lm_p, lm_l_new, lm_meas, lm_info], real_lm
    )

    dev_col = np.arange(n_dev)[:, None]
    odom_i_loc = np.where(od_m > 0, s_oi - dev_col * nb, 0).astype(np.int32)
    j_local = owner_pose[s_oj] == dev_col
    odom_j_ext = np.where(
        od_m > 0,
        np.where(j_local, s_oj - dev_col * nb, nb + bp_slot_of[s_oj]),
        0,
    ).astype(np.int32)
    odom_chain = (
        (od_m > 0) & j_local & (s_oj == s_oi + 1)
    ).astype(np.float32)
    odom_gi = np.where(od_m > 0, s_oi // coarse_group, 0).astype(np.int32)
    odom_gj = np.where(od_m > 0, s_oj // coarse_group, 0).astype(np.int32)

    lm_p_loc = np.where(lm_m > 0, s_lp - dev_col * nb, 0).astype(np.int32)
    l_local = owner_lm_new[s_ll] == dev_col
    lm_ext = np.where(
        lm_m > 0,
        np.where(l_local, s_ll - dev_col * mb, mb + bl_slot_of[s_ll]),
        0,
    ).astype(np.int32)
    lm_gp = np.where(lm_m > 0, s_lp // coarse_group, 0).astype(np.int32)

    # --- ownership tables over the registries ------------------------------
    def own_tables(ids, slot_of, owner_of, block, n_slots):
        per_dev = [
            np.nonzero(owner_of[ids] == d)[0] for d in range(n_dev)
        ]
        k = _round_up(max(max(len(x) for x in per_dev), 1), 8)
        slot = np.zeros((n_dev, k), np.int32)
        row = np.zeros((n_dev, k), np.int32)
        msk = np.zeros((n_dev, k), np.float32)
        for d, sel in enumerate(per_dev):
            ii = ids[sel]
            slot[d, : len(sel)] = slot_of[ii]
            row[d, : len(sel)] = ii - d * block
            msk[d, : len(sel)] = 1.0
        return slot, row, msk

    bp_slot, bp_row, bp_msk = own_tables(
        bp_ids, bp_slot_of, owner_pose, nb, n_bp
    )
    bl_slot, bl_row, bl_msk = own_tables(
        bl_ids, bl_slot_of, owner_lm_new, mb, n_bl
    )

    # owned landmarks with no remote observers: complete coarse-fill columns
    interior = np.ones((n_dev, mb), np.float32)
    interior[lm_mask_v.reshape(n_dev, mb) == 0] = 0.0
    if len(bl_ids):
        interior[bl_ids // mb, bl_ids % mb] = 0.0

    plan = PartitionPlan(
        odom_i_loc=odom_i_loc,
        odom_j_ext=odom_j_ext,
        odom_chain_mask=odom_chain,
        odom_gi=odom_gi,
        odom_gj=odom_gj,
        lm_p_loc=lm_p_loc,
        lm_ext=lm_ext,
        lm_gp=lm_gp,
        own_bp_slot=bp_slot,
        own_bp_row=bp_row,
        own_bp_mask=bp_msk,
        own_bl_slot=bl_slot,
        own_bl_row=bl_row,
        own_bl_mask=bl_msk,
        lm_interior_mask=interior,
        n_bp=n_bp,
        n_bl=n_bl,
    )

    # type-generic rebuild: FactorGraph3D shares every field name (plus
    # intrinsics, which dataclasses.replace preserves), and its edge
    # dataclasses share (i, j | pose, lm, meas, info, mask)
    pgraph = dataclasses.replace(
        graph,
        poses=poses,
        landmarks=landmarks,
        pose_mask=pose_mask_v,
        lm_mask=lm_mask_v,
        pose_fixed=pose_fixed_v,
        lm_fixed=lm_fixed_v,
        odom=type(graph.odom)(
            i=s_oi.astype(np.int32), j=s_oj.astype(np.int32),
            meas=s_om, info=s_oinf, mask=od_m,
        ),
        lm_edges=type(graph.lm_edges)(
            pose=s_lp.astype(np.int32), lm=s_ll.astype(np.int32),
            meas=s_lm_, info=s_linf, mask=lm_m,
        ),
        plan=plan,
    )
    n_real = int((np.asarray(graph.pose_mask) > 0).sum())
    m_real = int((np.asarray(graph.lm_mask) > 0).sum())
    meta = PartitionMeta(
        n_dev=n_dev, nb=nb, mb=mb, n_bp=n_bp, n_bl=n_bl,
        old_of_new_lm=old_of_new, new_of_old_lm=new_of_old,
        boundary_pose_frac=len(bp_ids) / max(n_real, 1),
        boundary_lm_frac=len(bl_ids) / max(m_real, 1),
    )
    return pgraph, meta


# ---------------------------------------------------------------------------
# boundary exchange primitives (inside shard_map)
# ---------------------------------------------------------------------------


def _publish(vals, slot, row, mask, size, axis):
    """Owner scatters its boundary rows into the global registry buffer and
    psums — every device ends with the complete ``[size, ...]`` buffer."""
    contrib = vals[row] * mask.reshape(mask.shape + (1,) * (vals.ndim - 1))
    buf = jax.ops.segment_sum(contrib, slot, size)
    return jax.lax.psum(buf, axis)


def _pickup(tail, slot, row, mask, nloc):
    """Owner claims its slots of a psum'd boundary partial buffer, adding
    them into its local rows."""
    vals = tail[slot] * mask.reshape(mask.shape + (1,) * (tail.ndim - 1))
    return jax.ops.segment_sum(vals, row, nloc)


# ---------------------------------------------------------------------------
# the shard_map body
# ---------------------------------------------------------------------------


class _LocalSystem(NamedTuple):
    hpp_diag: jax.Array   # [Nb,3,3] complete (owner rows)
    hpp_off: jax.Array    # [Eo,3,3] per local odom edge
    hll: jax.Array        # [Mb,2,2] complete (owner rows)
    hpl: jax.Array        # [El,3,2] per local lm edge
    bp: jax.Array         # [Nb,3]
    bl: jax.Array         # [Mb,2]
    err: jax.Array        # [] psum'd chi^2


def _is_3d(g) -> bool:
    """SE(3)/BA graphs carry camera intrinsics; the partition machinery is
    otherwise block-size generic (dp/dl read off the arrays)."""
    return hasattr(g, "intrinsics")


def _linearize_local(g, cfg: OptimizerConfig, x_ext, l_ext, pl):
    """Per-edge linearization on the extended (local + boundary) state,
    dispatching SE(2) vs SE(3) — both return the same block-field names.
    Returns ``(ata, btb, hpp_off, wr_i, wr_j, odom_err, lb)``."""
    if _is_3d(g):
        from toyslam_tpu.ops import edge_blocks3d as eb3
        from toyslam_tpu.ops import residuals3d as res3

        od = res3.eval_odom3d_edges(
            x_ext, pl.odom_i_loc, pl.odom_j_ext, g.odom.meas, g.odom.info,
            g.odom.mask, cfg.huber_delta, exact=cfg.exact_odom_jacobians,
        )
        w_od = od.w[:, None, None] * g.odom.info
        lb = eb3.reproj_edge_blocks(
            x_ext, l_ext, g.intrinsics, pl.lm_p_loc, pl.lm_ext,
            g.lm_edges.meas, g.lm_edges.info, g.lm_edges.mask,
            cfg.huber_delta,
        )
        return (
            bm.quad(od.JA, w_od), bm.quad(od.JB, w_od),
            bm.mtm(od.JA, bm.mm(w_od, od.JB)),
            bm.mtv(od.JA, bm.mv(w_od, od.r)),
            bm.mtv(od.JB, bm.mv(w_od, od.r)),
            jnp.sum(od.robust_err), lb,
        )
    lb = edge_blocks.lm_edge_blocks(
        x_ext, l_ext, pl.lm_p_loc, pl.lm_ext, g.lm_edges.meas,
        g.lm_edges.info, g.lm_edges.mask, cfg.huber_delta,
    )
    if cfg.exact_odom_jacobians:
        from toyslam_tpu.ops import residuals as res_ops

        od = res_ops.eval_odom_edges(
            x_ext, pl.odom_i_loc, pl.odom_j_ext, g.odom.meas, g.odom.info,
            g.odom.mask, cfg.huber_delta, exact=True,
        )
        w_od = od.w[:, None, None] * g.odom.info
        return (
            bm.quad(od.JA, w_od), bm.quad(od.JB, w_od),
            bm.mtm(od.JA, bm.mm(w_od, od.JB)),
            bm.mtv(od.JA, bm.mv(w_od, od.r)),
            bm.mtv(od.JB, bm.mv(w_od, od.r)),
            jnp.sum(od.robust_err), lb,
        )
    ob = edge_blocks.odom_edge_blocks(
        x_ext, pl.odom_i_loc, pl.odom_j_ext, g.odom.meas, g.odom.info,
        g.odom.mask, cfg.huber_delta,
    )
    return (
        ob.w_info, ob.w_info, -ob.w_info, -ob.wr, ob.wr,
        jnp.sum(ob.robust_err), lb,
    )


def _assemble_local(g, cfg: OptimizerConfig, axis: str,
                    pose_bnd, lm_bnd) -> _LocalSystem:
    """Linearize the local edge shard into owner-complete local blocks.

    ``pose_bnd [Bp,dp]`` / ``lm_bnd [Bl,dl]`` are the published boundary
    states; cross contributions ride the registry tails of the local
    segment sums and psum once (tuple-psum: one collective)."""
    pl: PartitionPlan = g.plan
    nb = g.poses.shape[0]
    mb = g.landmarks.shape[0]
    x_ext = jnp.concatenate([g.poses, pose_bnd], axis=0)
    l_ext = jnp.concatenate([g.landmarks, lm_bnd], axis=0)

    ata, btb, hpp_off, wr_i, wr_j, odom_err, lb = _linearize_local(
        g, cfg, x_ext, l_ext, pl
    )

    # pose-space accumulators over [Nb + Bp]: row-i terms land locally,
    # row-j terms may land on the registry tail
    hpp_acc = jax.ops.segment_sum(ata, pl.odom_i_loc, nb + pl.n_bp)
    hpp_acc = hpp_acc + jax.ops.segment_sum(
        btb, pl.odom_j_ext, nb + pl.n_bp
    )
    hpp_acc = hpp_acc.at[: nb].add(
        jax.ops.segment_sum(lb.w_ata, pl.lm_p_loc, nb)
    )
    bp_acc = jax.ops.segment_sum(wr_i, pl.odom_i_loc, nb + pl.n_bp)
    bp_acc = bp_acc + jax.ops.segment_sum(
        wr_j, pl.odom_j_ext, nb + pl.n_bp
    )
    bp_acc = bp_acc.at[: nb].add(
        jax.ops.segment_sum(lb.bp_c, pl.lm_p_loc, nb)
    )
    # landmark-space accumulators over [Mb + Bl]
    hll_acc = jax.ops.segment_sum(lb.w_btb, pl.lm_ext, mb + pl.n_bl)
    bl_acc = jax.ops.segment_sum(lb.bl_c, pl.lm_ext, mb + pl.n_bl)

    err_local = odom_err + jnp.sum(lb.robust_err)
    hpp_tail, bp_tail, hll_tail, bl_tail, err = jax.lax.psum(
        (hpp_acc[nb:], bp_acc[nb:], hll_acc[mb:], bl_acc[mb:], err_local),
        axis,
    )
    hpp_diag = hpp_acc[:nb] + _pickup(
        hpp_tail, pl.own_bp_slot, pl.own_bp_row, pl.own_bp_mask, nb
    )
    bp = bp_acc[:nb] + _pickup(
        bp_tail, pl.own_bp_slot, pl.own_bp_row, pl.own_bp_mask, nb
    )
    hll = hll_acc[:mb] + _pickup(
        hll_tail, pl.own_bl_slot, pl.own_bl_row, pl.own_bl_mask, mb
    )
    bl = bl_acc[:mb] + _pickup(
        bl_tail, pl.own_bl_slot, pl.own_bl_row, pl.own_bl_mask, mb
    )

    # gauge priors + padding regularization (local rows — owner applies)
    eye_p = jnp.eye(hpp_diag.shape[-1], dtype=hpp_diag.dtype)
    eye_l = jnp.eye(hll.shape[-1], dtype=hll.dtype)
    pose_reg = cfg.fixed_prior * g.pose_fixed + (1.0 - g.pose_mask)
    lm_reg = cfg.fixed_prior * g.lm_fixed + (1.0 - g.lm_mask)
    hpp_diag = hpp_diag + pose_reg[:, None, None] * eye_p
    hll = hll + lm_reg[:, None, None] * eye_l
    bp = bp * (1.0 - g.pose_fixed)[:, None]
    bl = bl * (1.0 - g.lm_fixed)[:, None]

    return _LocalSystem(
        hpp_diag=hpp_diag, hpp_off=hpp_off, hll=hll, hpl=lb.w_hpl,
        bp=bp, bl=bl, err=err,
    )


def _lm_leg_u(sys: _LocalSystem, pl: PartitionPlan, x, x_bnd, mb, axis,
              extra_psum=None):
    """``u = Hlp x`` complete at each landmark's owner ``[Mb, 2]``.

    ``extra_psum``: optional pytree to fold into the same psum (collective
    batching).  Returns (u, extra_psum_result)."""
    x_ext = jnp.concatenate([x, x_bnd], axis=0)
    u_acc = jax.ops.segment_sum(
        bm.mtv(sys.hpl, x_ext[pl.lm_p_loc]), pl.lm_ext, mb + pl.n_bl
    )
    if extra_psum is None:
        u_tail = jax.lax.psum(u_acc[mb:], axis)
        extra = None
    else:
        u_tail, extra = jax.lax.psum((u_acc[mb:], extra_psum), axis)
    u = u_acc[:mb] + _pickup(
        u_tail, pl.own_bl_slot, pl.own_bl_row, pl.own_bl_mask, mb
    )
    return u, extra


def _partitioned_matvec(sys: _LocalSystem, hll_inv, pl: PartitionPlan,
                        nb, mb, axis):
    """The damped Schur operator ``S @ x`` on sharded ``x [Nb, 3]``.

    3 boundary-sized psums per call: x publication, (u-tail + odom-j-tail)
    batched, v publication."""

    def matvec(x):
        x_bnd = _publish(
            x, pl.own_bp_slot, pl.own_bp_row, pl.own_bp_mask, pl.n_bp, axis
        )
        x_ext = jnp.concatenate([x, x_bnd], axis=0)
        # odom off-diagonal: row-i local, row-j through the registry tail
        yj_acc = jax.ops.segment_sum(
            bm.mtv(sys.hpp_off, x[pl.odom_i_loc]), pl.odom_j_ext,
            nb + pl.n_bp,
        )
        u, yj_tail = _lm_leg_u(
            sys, pl, x, x_bnd, mb, axis, extra_psum=yj_acc[nb:]
        )
        v = bm.mv(hll_inv, u)
        v_bnd = _publish(
            v, pl.own_bl_slot, pl.own_bl_row, pl.own_bl_mask, pl.n_bl, axis
        )
        v_ext = jnp.concatenate([v, v_bnd], axis=0)
        w = jax.ops.segment_sum(
            bm.mv(sys.hpl, v_ext[pl.lm_ext]), pl.lm_p_loc, nb
        )
        y = jax.ops.segment_sum(
            bm.mv(sys.hpp_off, x_ext[pl.odom_j_ext]), pl.odom_i_loc, nb
        )
        y = y + yj_acc[:nb] + _pickup(
            yj_tail, pl.own_bp_slot, pl.own_bp_row, pl.own_bp_mask, nb
        )
        return bm.mv(sys.hpp_diag, x) + y - w

    return matvec


def _s_diag_local(sys: _LocalSystem, hll_inv_ext, pl: PartitionPlan, nb):
    """Exact diagonal blocks of S for owned poses (all incident lm edges
    are local by construction)."""
    contrib = bm.mm(
        bm.mm(sys.hpl, hll_inv_ext[pl.lm_ext]),
        jnp.swapaxes(sys.hpl, -1, -2),
    )
    return sys.hpp_diag - jax.ops.segment_sum(contrib, pl.lm_p_loc, nb)


def _eq_inv_dense(mat: jax.Array) -> jax.Array:
    """Jacobi-equilibrated dense inverse (batched over leading dims) —
    the 1e6 gauge prior otherwise costs the f32 inverse its digits."""
    s = jax.lax.rsqrt(jnp.maximum(
        jnp.diagonal(mat, axis1=-2, axis2=-1), 1e-30
    ))
    a = mat * s[..., :, None] * s[..., None, :]
    inv = jnp.linalg.inv(a)
    return inv * s[..., :, None] * s[..., None, :]


def _coarse_build_partitioned(
    sys: _LocalSystem, hll_inv, hll_inv_bnd, pl: PartitionPlan,
    nb, mb, group, group2, n_dev, axis,
):
    """Three-level SHARDED Galerkin coarse hierarchy.

    Assembling the full ``[dp*Nc, dp*Nc]`` Galerkin system on EVERY
    device and solving it replicated per PCG iteration would make that
    replicated share bound the scaling.  Here the coarse system is never
    solved replicated; instead each
    device assembles only ITS ROW BLOCK ``S_c[mine, :]`` (memory and work
    O(Nc^2/D)) and the correction splits into

      level 2 — batched dense inverses of the super-group diagonal blocks
                of S_c (``group2`` coarse groups per super-group): apply is
                a batched block matvec on device-local data, ZERO
                communication, work O(Nc/D) per device;
      level 3 — a Galerkin re-aggregation over super-groups: the
                ``[dp*Nc2, dp*Nc2]`` system (Nc2 = Nc/group2, tiny) is the
                only replicated object; its apply is one small matvec fed
                by one [Nc2, dp]-sized psum.

    Both levels are fixed SPD linear operators, so the additive 3-level
    preconditioner keeps PCG's theory intact; the trade is a few extra PCG
    iterations for removing every O(Nc)-or-larger replicated solve.

    Row-block assembly notes:
      * odometry (g_i row) terms and the transpose terms of locally-owned
        g_j land directly in the local rows; CROSS-device transpose terms
        ride a [Nc, Nc] grid psum restricted to cross edges (few — the
        keyframe cut crosses ~1-3% of edges);
      * landmark fill: interior landmarks (all observers local) contribute
        ``V_int V_int^T`` locally; boundary-landmark U columns are
        completed by one psum — INCLUDING the owner's own observations —
        and each device then takes its
        row slice of the exact ``V_bnd V_bnd^T`` product, so nothing is
        owner-masked or double counted.

    Returns ``(dinv [nc2b, g2*dp, g2*dp], c3inv [dp*Nc2, dp*Nc2])``.
    Component-major ordering (row = a*width + position) throughout,
    matching schur.build_coarse_precond.
    """
    dp = sys.hpp_diag.shape[-1]
    dl = hll_inv.shape[-1]
    ncb = nb // group
    nc = ncb * n_dev
    # largest divisor of ncb not exceeding group2 (static): keeps any
    # ncb valid without host-side coordination
    g2 = next(g for g in range(min(group2, ncb), 0, -1) if ncb % g == 0)
    nc2b = ncb // g2
    nc2 = nc2b * n_dev
    d = jax.lax.axis_index(axis)
    row0 = d * ncb

    gid_local = jnp.arange(nb, dtype=jnp.int32) // group
    g_glob = row0 + gid_local

    # --- R^T Hpp R rows (block layout [ncb*nc, dp, dp]) ----------------
    gi_l = pl.odom_gi - row0          # i-side pose is always owned
    rows = jax.ops.segment_sum(
        sys.hpp_diag, gid_local * nc + g_glob, ncb * nc
    )
    rows = rows + jax.ops.segment_sum(
        sys.hpp_off, gi_l * nc + pl.odom_gj, ncb * nc
    )
    off_t = jnp.swapaxes(sys.hpp_off, -1, -2)
    j_owned = (pl.odom_gj >= row0) & (pl.odom_gj < row0 + ncb)
    rows = rows + jax.ops.segment_sum(
        off_t * j_owned[:, None, None].astype(off_t.dtype),
        jnp.where(j_owned, pl.odom_gj - row0, 0) * nc + pl.odom_gi,
        ncb * nc,
    )
    # cross edges: the (g_j row, g_i col) transpose block belongs to a
    # remote row — deliver through a global grid psum (zero except at the
    # few cross pairs; padded edges carry zero blocks)
    cross_grid = jax.ops.segment_sum(
        off_t * (~j_owned)[:, None, None].astype(off_t.dtype),
        pl.odom_gj * nc + pl.odom_gi, nc * nc,
    )

    # --- landmark U planes over local columns [mb + Bl] ----------------
    vals = sys.hpl.reshape(-1, dp * dl)
    gp_l = pl.lm_gp - row0            # observing pose is always owned
    ids = gp_l * (mb + pl.n_bl) + pl.lm_ext
    planes = [
        jax.ops.segment_sum(
            vals[:, k], ids, ncb * (mb + pl.n_bl)
        ).reshape(ncb, mb + pl.n_bl)
        for k in range(dp * dl)
    ]
    # boundary columns with GLOBAL rows: my local rows embedded at row0,
    # PLUS the owner's own-column contributions scattered onto their
    # registry slots so the psum'd column is complete
    bnd_local = jnp.stack([p[:, mb:] for p in planes])   # [dp*dl, ncb, Bl]
    own_cols = jnp.stack([
        jax.ops.segment_sum(
            (p[:, pl.own_bl_row] * pl.own_bl_mask[None, :]).T,
            pl.own_bl_slot, pl.n_bl,
        ).T
        for p in planes
    ])                                                    # [dp*dl, ncb, Bl]
    bnd_embed = jnp.zeros((dp * dl, nc, pl.n_bl), bnd_local.dtype)
    bnd_embed = jax.lax.dynamic_update_slice(
        bnd_embed, bnd_local + own_cols, _idx(0, row0, 0)
    )
    cross_grid, bnd_planes = jax.lax.psum((cross_grid, bnd_embed), axis)

    # --- fill terms -----------------------------------------------------
    el_own = schur._chol_small(hll_inv)                   # [mb, dl, dl]
    w_int = pl.lm_interior_mask[None, :]
    vf_int = jnp.concatenate([
        jnp.concatenate([
            sum(
                planes[a * dl + b][:, :mb] * w_int
                * el_own[:, b, b2][None, :]
                for b in range(dl)
            )
            for b2 in range(dl)
        ], axis=1)
        for a in range(dp)
    ], axis=0)                                    # [dp*ncb, dl*mb]
    fill_int = jnp.dot(vf_int, vf_int.T,
                       precision=jax.lax.Precision.HIGHEST)

    el_bnd = schur._chol_small(hll_inv_bnd)       # [Bl, dl, dl]
    vf_bnd_all = jnp.concatenate([
        jnp.concatenate([
            sum(
                bnd_planes[a * dl + b] * el_bnd[:, b, b2][None, :]
                for b in range(dl)
            )
            for b2 in range(dl)
        ], axis=1)
        for a in range(dp)
    ], axis=0)                                    # [dp*nc, dl*Bl]
    vf_bnd_mine = jax.lax.dynamic_slice(
        vf_bnd_all.reshape(dp, nc, -1), _idx(0, row0, 0),
        (dp, ncb, vf_bnd_all.shape[-1]),
    ).reshape(dp * ncb, -1)
    fill_bnd = jnp.dot(vf_bnd_mine, vf_bnd_all.T,
                       precision=jax.lax.Precision.HIGHEST)

    # --- assemble the comp-major row block [dp, ncb, dp, nc] -----------
    rows4 = rows.reshape(ncb, nc, dp, dp).transpose(2, 0, 3, 1)
    cross_mine = jax.lax.dynamic_slice(
        cross_grid.reshape(nc, nc, dp, dp), _idx(row0, 0, 0, 0),
        (ncb, nc, dp, dp),
    ).transpose(2, 0, 3, 1)
    rows4 = rows4 + cross_mine
    rows4 = rows4 - fill_bnd.reshape(dp, ncb, dp, nc)
    fill_int_embed = jnp.zeros_like(rows4)
    fill_int_embed = jax.lax.dynamic_update_slice(
        fill_int_embed, fill_int.reshape(dp, ncb, dp, ncb),
        _idx(0, 0, 0, row0),
    )
    rows4 = rows4 - fill_int_embed

    # --- level 2: super-group diagonal blocks, batched inverse ----------
    diag4 = jax.lax.dynamic_slice(
        rows4, _idx(0, 0, 0, row0), (dp, ncb, dp, ncb)
    )
    d6 = diag4.reshape(dp, nc2b, g2, dp, nc2b, g2)
    blocks = jnp.diagonal(d6, axis1=1, axis2=4)   # [dp, g2, dp, g2, nc2b]
    blocks = blocks.transpose(4, 0, 1, 2, 3).reshape(
        nc2b, dp * g2, dp * g2
    )
    bidx = jnp.arange(dp * g2)
    blocks = blocks.at[:, bidx, bidx].add(
        1e-4 * blocks[:, bidx, bidx]
    )
    dinv = _eq_inv_dense(blocks)

    # --- level 3: super-group Galerkin, replicated but tiny -------------
    r3 = rows4.reshape(dp, nc2b, g2, dp, nc).sum(axis=2)
    r3 = r3.reshape(dp, nc2b, dp, nc2, g2).sum(axis=4)    # [dp,nc2b,dp,nc2]
    c3 = jnp.zeros((dp, nc2, dp, nc2), r3.dtype)
    c3 = jax.lax.dynamic_update_slice(c3, r3, _idx(0, d * nc2b, 0, 0))
    c3 = jax.lax.psum(c3, axis)
    c3 = c3.reshape(dp * nc2, dp * nc2)
    didx = jnp.arange(dp * nc2)
    c3 = c3.at[didx, didx].add(1e-4 * c3[didx, didx])
    c3inv = _eq_inv_dense(c3)
    return dinv, c3inv


def _coarse_apply_partitioned(pre, group, group2, r, nb, n_dev, axis):
    """3-level coarse correction on the sharded residual ``r [Nb, dp]``:
    level 2 is a zero-communication batched block matvec on owned
    super-groups; level 3 psums one tiny ``[Nc2, dp]`` coarse residual and
    applies the replicated ``[dp*Nc2]`` explicit inverse."""
    dinv, c3inv = pre
    dp = r.shape[-1]
    ncb = nb // group
    g2 = dinv.shape[-1] // dp
    nc2b = ncb // g2
    nc2 = nc2b * n_dev
    d = jax.lax.axis_index(axis)

    rc = r.reshape(ncb, group, dp).sum(axis=1)            # [ncb, dp]
    # level 2: comp-major within block (row = a*g2 + t)
    rc2 = rc.reshape(nc2b, g2, dp).transpose(0, 2, 1).reshape(
        nc2b, dp * g2
    )
    z2 = jnp.einsum("bij,bj->bi", dinv, rc2,
                    precision=jax.lax.Precision.HIGHEST)
    z2 = z2.reshape(nc2b, dp, g2).transpose(0, 2, 1).reshape(ncb, dp)

    # level 3
    rc3_local = rc.reshape(nc2b, g2, dp).sum(axis=1)      # [nc2b, dp]
    rc3 = jnp.zeros((nc2, dp), r.dtype)
    rc3 = jax.lax.dynamic_update_slice(rc3, rc3_local, _idx(d * nc2b, 0))
    rc3 = jax.lax.psum(rc3, axis)
    zc3 = jnp.dot(c3inv, rc3.T.reshape(-1),
                  precision=jax.lax.Precision.HIGHEST)
    z3 = zc3.reshape(dp, nc2).T                           # [nc2, dp]
    z3_local = jax.lax.dynamic_slice(z3, _idx(d * nc2b, 0), (nc2b, dp))
    z3_fine = jnp.broadcast_to(
        z3_local.reshape(nc2b, 1, dp), (nc2b, g2, dp)
    ).reshape(ncb, dp)

    zc = z2 + z3_fine                                     # [ncb, dp]
    return jnp.broadcast_to(
        zc.reshape(ncb, 1, dp), (ncb, group, dp)
    ).reshape(nb, dp)


def _build_local_precond(cfg, sys, s_diag, pl, nb, axis):
    """Local preconditioner on the device's own block (cross-device chain
    couplings are dropped — the coarse level owns global modes)."""
    kind, _, _ = cfg.pcg_precond.partition("+")
    if kind in ("tridiag", "chunk"):
        keep = pl.odom_chain_mask
        upper = jax.ops.segment_sum(
            sys.hpp_off * keep[:, None, None], pl.odom_i_loc, nb
        )
        if kind == "tridiag":
            return schur.build_tridiag_precond(s_diag, upper)
        return schur.build_chunk_precond(s_diag, upper, cfg.pcg_chunk)
    return schur.inv_blocks(s_diag)


def _local_precond_apply(cfg, local):
    kind, _, _ = cfg.pcg_precond.partition("+")
    if kind == "tridiag":
        return lambda r: schur.tridiag_apply(local, r)
    if kind == "chunk":
        return lambda r: schur.chunk_apply(local, r)
    return lambda r: bm.mv(local, r)


def partitioned_linearize_solve(
    cfg: OptimizerConfig, mesh: Mesh, axis: str = DEV_AXIS
):
    """A LinearizeSolve over keyframe/map-block partitioned state.

    Plugs into ``GaussNewton(config, solve=...)``: ``prepare(graph)`` runs
    the host-side partition build (once per structure); ``solve`` is the
    shard_map'd linearize+Schur+PCG whose state never leaves its owner
    device.  After ``prepare``, ``solve.meta`` holds the
    :class:`PartitionMeta` (landmark permutation, boundary fractions).
    """
    n_dev = mesh.shape[axis]
    align = max(cfg.pcg_chunk, cfg.pcg_coarse_group)
    use_coarse = cfg.pcg_precond.endswith("+coarse")

    def body(g: FactorGraph2D, lam: jax.Array):
        # States shard by block ([N',3] -> [Nb,3]); the stacked per-device
        # tables shard their leading D axis ([D,...] -> [1,...]) — squeeze
        # exactly those.
        g = dataclasses.replace(
            g,
            odom=jax.tree.map(lambda a: a[0], g.odom),
            lm_edges=jax.tree.map(lambda a: a[0], g.lm_edges),
            plan=jax.tree.map(lambda a: a[0], g.plan),
        )
        pl: PartitionPlan = g.plan
        nb = g.poses.shape[0]
        mb = g.landmarks.shape[0]

        # publish boundary STATES once per linearization (one tuple-psum)
        pose_pub = jax.ops.segment_sum(
            g.poses[pl.own_bp_row] * pl.own_bp_mask[:, None],
            pl.own_bp_slot, pl.n_bp,
        )
        lm_pub = jax.ops.segment_sum(
            g.landmarks[pl.own_bl_row] * pl.own_bl_mask[:, None],
            pl.own_bl_slot, pl.n_bl,
        )
        pose_bnd, lm_bnd = jax.lax.psum((pose_pub, lm_pub), axis)

        sys = _assemble_local(g, cfg, axis, pose_bnd, lm_bnd)
        # schur.damp reads block sizes off the arrays and _replaces by
        # field name, so it works on _LocalSystem directly
        d = schur.damp(sys, lam)
        hll_inv = schur.inv_blocks(d.hll)
        # publish boundary hll_inv for s_diag + back-substitution gathers
        hll_inv_bnd = _publish(
            hll_inv, pl.own_bl_slot, pl.own_bl_row, pl.own_bl_mask,
            pl.n_bl, axis,
        )
        hll_inv_ext = jnp.concatenate([hll_inv, hll_inv_bnd], axis=0)

        # rhs = -bp + Hpl Hll^-1 bl   (v-leg: publish owner v, gather)
        v0 = bm.mv(hll_inv, d.bl)
        v0_bnd = _publish(
            v0, pl.own_bl_slot, pl.own_bl_row, pl.own_bl_mask, pl.n_bl,
            axis,
        )
        v0_ext = jnp.concatenate([v0, v0_bnd], axis=0)
        rhs = -d.bp + jax.ops.segment_sum(
            bm.mv(d.hpl, v0_ext[pl.lm_ext]), pl.lm_p_loc, nb
        )

        matvec = _partitioned_matvec(d, hll_inv, pl, nb, mb, axis)
        s_diag = _s_diag_local(d, hll_inv_ext, pl, nb)
        local = _build_local_precond(cfg, d, s_diag, pl, nb, axis)
        local_apply = _local_precond_apply(cfg, local)
        if use_coarse:
            pre_c = _coarse_build_partitioned(
                d, hll_inv, hll_inv_bnd, pl, nb, mb,
                cfg.pcg_coarse_group, cfg.pcg_coarse_group2, n_dev, axis,
            )
            precond_apply = lambda r: local_apply(r) + (  # noqa: E731
                _coarse_apply_partitioned(
                    pre_c, cfg.pcg_coarse_group, cfg.pcg_coarse_group2,
                    r, nb, n_dev, axis,
                )
            )
        else:
            precond_apply = local_apply

        res = schur.pcg(
            matvec=matvec,
            precond_apply=precond_apply,
            rhs=rhs,
            tol=cfg.pcg_tol,
            max_iters=cfg.pcg_max_iters,
            restart_every=cfg.pcg_restart_every,
            dot_axis_name=axis,
            unroll=cfg.pcg_unroll,
        )
        dx_p = res.x

        # back-substitution: dx_l = Hll^-1 (-bl - Hlp dx_p)
        x_bnd = _publish(
            dx_p, pl.own_bp_slot, pl.own_bp_row, pl.own_bp_mask, pl.n_bp,
            axis,
        )
        u, _ = _lm_leg_u(d, pl, dx_p, x_bnd, mb, axis)
        dx_l = bm.mv(hll_inv, -d.bl - u)

        return (
            dx_p, dx_l, sys.err,
            SolveStats(pcg_iters=res.iterations,
                       pcg_residual=res.residual_norm),
        )

    # every array in the partitioned graph is sharded along axis 0
    # (states by block, stacked per-device tables by their leading D axis)
    # EXCEPT the camera intrinsics of SE(3) graphs, which replicate
    out_specs = (P(axis), P(axis), P(),
                 SolveStats(pcg_iters=P(), pcg_residual=P()))
    check_vma = True

    def solve(graph: FactorGraph2D, lam: jax.Array):
        specs = jax.tree.map(lambda _: P(axis), graph)
        if _is_3d(graph):
            specs = dataclasses.replace(specs, intrinsics=P())
        sharded = shard_map(
            body, mesh=mesh, in_specs=(specs, P()),
            out_specs=out_specs, check_vma=check_vma,
        )
        return sharded(graph, lam)

    def prepare(graph: FactorGraph2D) -> FactorGraph2D:
        if isinstance(graph.plan, PartitionPlan):
            return graph
        pgraph, meta = build_partition(
            dataclasses.replace(graph, plan=None), n_dev, align=align,
            coarse_group=cfg.pcg_coarse_group,
        )
        solve.meta = meta
        return pgraph

    solve.prepare = prepare
    solve.meta = None
    return solve
