"""Detection clustering: CFAR hit blobs -> object-level measurements.

A single physical target lights up a *blob* of adjacent range-Doppler
cells (mainlobe width, window sidelobes, sub-bin straddling), so the
top-K cell list usually contains several detections per object.  This
module groups hit cells into connected components (8-connectivity;
the Doppler axis wraps because velocity aliases, range does not) and
folds each component into one object measurement: power-weighted
centroid, total power, cell count and bounding extent.

The reference pipeline stops at per-cell peaks
(/root/reference/acceleration.cu:518-523 reports the single argmax
bin); grouping is the step real object-detection stacks insert between
CFAR and tracking (peak grouping / DBSCAN in TI's mmWave SDK terms).

Accelerator formulation: connected-component labeling is irregular,
pointer-chasing work on a CPU; here it is an iterative 3x3 min-label
propagation on the full map — each sweep is a separable box-min (two
Doppler rolls + two range shifts), pure vector work with static shapes,
iterated to fixpoint under ``lax.while_loop``.  The trip count is the
largest component's L-inf geodesic diameter (a handful of sweeps for
physical blobs), not the worst case of a serial union-find.  Labels are
canonical (minimum flat cell index of the component), so the golden
twin (``golden.cluster_hits``) matches bit-for-bit.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mmradar.config import RadarConfig


class ClusterResult(NamedTuple):
    """Per-detection cluster assignment + per-cluster object stats.

    All arrays share the detection list's (..., K) shape.  Stats are
    duplicated onto every member of a cluster (slot k describes the
    cluster det k belongs to); ``cluster_id`` names the representative.
    """

    cluster_id: jnp.ndarray    # int32 (..., K): index (into the K list) of
    #   the strongest detection of this detection's component; -1 invalid
    num_clusters: jnp.ndarray  # int32 (...,): distinct components among
    #   the valid detections
    cells: jnp.ndarray         # int32 (..., K): component size in cells
    total_power: jnp.ndarray   # float32 (..., K): sum of member-cell power
    centroid_range_m: jnp.ndarray      # float32 (..., K) power-weighted
    centroid_velocity_mps: jnp.ndarray  # float32 (..., K) (wrap-aware)
    extent_doppler_bins: jnp.ndarray   # int32 (..., K) bounding height
    extent_range_bins: jnp.ndarray     # int32 (..., K) bounding width


def representatives(valid, cluster_id):
    """Boolean (..., K) mask: detection k is its component's
    representative (the strongest member — ``cluster_id`` names itself).

    THE definition of "one output per object"; `cli track --cluster`
    and the eval harness must agree with the clustering op, so all
    three call this.  Works on NumPy and JAX arrays alike (the
    comparison promotes to the input's namespace).
    """
    import numpy as np

    k = valid.shape[-1]
    return valid & (cluster_id == np.arange(k, dtype=np.int32))


def _shift_range(a: jnp.ndarray, s: int, fill) -> jnp.ndarray:
    """Shift along the last (range) axis WITHOUT wrap, filling with
    ``fill`` (range bins are physical distances; bin R-1 is not adjacent
    to bin 0)."""
    pad = jnp.full(a.shape[:-1] + (abs(s),), fill, a.dtype)
    if s > 0:
        return jnp.concatenate([pad, a[..., :-s]], axis=-1)
    return jnp.concatenate([a[..., -s:], pad], axis=-1)


def label_hits(hits: jnp.ndarray) -> jnp.ndarray:
    """Connected-component labels of a hit map.

    Args:
      hits: bool (..., D, R).  8-connectivity; Doppler (axis -2) wraps,
        range (axis -1) does not.

    Returns:
      int32 labels, same shape: the component's minimum flat cell index
      (d*R + r) for hit cells, -1 for non-hits.  Canonical, so twins can
      compare exactly (``golden.cluster_hits``).
    """
    d_size, r_size = hits.shape[-2], hits.shape[-1]
    big = jnp.int32(d_size * r_size)
    idx = jnp.arange(d_size * r_size, dtype=jnp.int32).reshape(
        d_size, r_size
    )
    init = jnp.where(hits, idx, big)

    def sweep(lab):
        # separable 3x3 box-min: min over the Doppler window (wrapping
        # rolls), then over the range window (edge-filled shifts)
        v = jnp.minimum(
            lab,
            jnp.minimum(
                jnp.roll(lab, 1, axis=-2), jnp.roll(lab, -1, axis=-2)
            ),
        )
        h = jnp.minimum(
            v,
            jnp.minimum(
                _shift_range(v, 1, big), _shift_range(v, -1, big)
            ),
        )
        return jnp.where(hits, h, big)

    def cond(state):
        return state[1]

    def body(state):
        lab, _ = state
        nxt = sweep(lab)
        return nxt, jnp.any(nxt != lab)

    labels, _ = jax.lax.while_loop(cond, body, (init, jnp.bool_(True)))
    return jnp.where(hits, labels, jnp.int32(-1))


def cluster_detections(
    power: jnp.ndarray,
    hits: jnp.ndarray,
    d_bin: jnp.ndarray,
    r_bin: jnp.ndarray,
    valid: jnp.ndarray,
    cfg: RadarConfig,
) -> ClusterResult:
    """Group the top-K detections by hit-map component and measure each
    component as one object.

    Args:
      power: float32 (..., D, R) integrated RD power map.
      hits: bool (..., D, R) CFAR decisions.
      d_bin, r_bin: int32 (..., K) detection cells (power-sorted, as
        produced by ``topk_cells`` — slot order determines which member
        represents a cluster: the first, i.e. strongest).
      valid: bool (..., K).

    The Doppler centroid and extent are wrap-aware: member offsets are
    measured modulo D around the detection's own cell, so a blob
    straddling the +/-v_max seam is one object with a correct centroid,
    not two half-objects.
    """
    d_size, r_size = power.shape[-2], power.shape[-1]
    k = d_bin.shape[-1]
    labels = label_hits(hits)
    lead = labels.shape[:-2]

    flat_labels = labels.reshape(lead + (d_size * r_size,))
    det_lab = jnp.take_along_axis(
        flat_labels, d_bin * r_size + r_bin, axis=-1
    )
    # invalid slots get distinct negative sentinels so they never match
    # each other (or a real label)
    det_lab = jnp.where(
        valid, det_lab, -2 - jnp.arange(k, dtype=jnp.int32)
    )

    # representative = first (strongest) detection with the same label
    same = det_lab[..., :, None] == det_lab[..., None, :]
    both = valid[..., :, None] & valid[..., None, :]
    first = jnp.argmax(same & both, axis=-1).astype(jnp.int32)
    cluster_id = jnp.where(valid, first, jnp.int32(-1))
    is_rep = representatives(valid, cluster_id)
    num_clusters = jnp.sum(is_rep, axis=-1).astype(jnp.int32)

    d_idx = jnp.arange(d_size, dtype=jnp.int32)[:, None]
    r_idx = jnp.arange(r_size, dtype=jnp.int32)[None, :]
    half = d_size // 2

    stats = []
    for kk in range(k):  # K is static and small; each pass is one fused
        # masked reduction over the map, so peak memory stays O(map)
        lab_k = det_lab[..., kk]
        mask = (labels == lab_k[..., None, None]) & valid[
            ..., kk, None, None
        ]
        w = jnp.where(mask, power, 0.0)
        total = jnp.sum(w, axis=(-2, -1))
        cells = jnp.sum(mask, axis=(-2, -1)).astype(jnp.int32)
        # Doppler offsets centered on the detection cell, modulo D:
        # a seam-straddling blob stays contiguous in ds-space
        ds = jnp.mod(
            d_idx - d_bin[..., kk, None, None] + half, d_size
        )
        denom = jnp.maximum(total, jnp.float32(1e-30))
        cd = jnp.sum(w * ds, axis=(-2, -1)) / denom
        cr = jnp.sum(w * r_idx, axis=(-2, -1)) / denom
        d_c = d_bin[..., kk].astype(jnp.float32) + (cd - half)
        ds_hit = jnp.where(mask, ds, d_size)
        ext_d = (
            jnp.max(jnp.where(mask, ds, -1), axis=(-2, -1))
            - jnp.min(ds_hit, axis=(-2, -1))
            + 1
        )
        r_hit = jnp.where(mask, r_idx, r_size)
        ext_r = (
            jnp.max(jnp.where(mask, r_idx, -1), axis=(-2, -1))
            - jnp.min(r_hit, axis=(-2, -1))
            + 1
        )
        stats.append((total, cells, d_c, cr, ext_d, ext_r))

    total, cells, d_c, r_c, ext_d, ext_r = (
        jnp.stack(t, axis=-1) for t in zip(*stats)
    )
    from mmradar.models.rd_pipeline import cell_physics

    c_range, c_vel = cell_physics(d_c, r_c, cfg)
    zero_f = jnp.float32(0.0)
    zero_i = jnp.int32(0)
    return ClusterResult(
        cluster_id=cluster_id,
        num_clusters=num_clusters,
        cells=jnp.where(valid, cells, zero_i).astype(jnp.int32),
        total_power=jnp.where(valid, total, zero_f),
        centroid_range_m=jnp.where(valid, c_range, zero_f),
        centroid_velocity_mps=jnp.where(valid, c_vel, zero_f),
        extent_doppler_bins=jnp.where(valid, ext_d, zero_i).astype(
            jnp.int32
        ),
        extent_range_bins=jnp.where(valid, ext_r, zero_i).astype(
            jnp.int32
        ),
    )
