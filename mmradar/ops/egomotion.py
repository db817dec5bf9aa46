"""Instantaneous ego-motion (platform velocity) from one frame's detections.

A radar on a moving platform sees every STATIC scatterer at azimuth
``az`` with radial velocity ``vr = -(vx sin az + vy cos az)`` — one
sinusoid in (az, vr) whose two coefficients are the platform velocity
(vx lateral, vy forward).  Fitting it per frame gives (a) the ego
velocity with no odometry input, (b) a static/moving label per
detection, and (c) ground-frame target velocities (the measured vr plus
the ego projection) — the classic single-sensor instantaneous
ego-motion method (Kellner et al.), here as a batched, jittable
iteratively-reweighted least-squares fit with Cauchy weights and a
final hard inlier gate (see the golden twin's docstring for why soft
weights: a hard gate after the mover-contaminated initial fit can shed
every static point).

Shapes are static (the fit runs on the pipeline's fixed-K detection
lists with a validity mask), the solve is a closed-form 2x2, and the
IRLS iteration count is a compile-time constant — the whole estimator
is a handful of masked reductions, so XLA fuses it into the detection
tail for free.

Float64 golden twin: :func:`mmradar.golden.estimate_ego_motion`.
Reference contrast: the reference pipeline ends at a single per-frame
distance (acceleration.cu:523) and has no platform-motion story.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp


class EgoMotion(NamedTuple):
    """Per-frame ego-motion fit (leading axes = frames)."""

    velocity: jnp.ndarray   # float32 (..., 2) = (vx lateral, vy forward)
    is_static: jnp.ndarray  # bool (..., K) detection consistent with the fit
    ok: jnp.ndarray         # bool (...) fit non-degenerate (>= 3 inliers,
    #                         azimuth spread sufficient for a 2-DoF solve)
    n_inliers: jnp.ndarray  # int32 (...)


_DET_EPS = 1e-9  # golden.estimate_ego_motion's singularity gate


@functools.partial(jax.jit, static_argnames=("n_iters",))
def estimate_ego_motion(
    azimuth_deg: jnp.ndarray,
    radial_velocity: jnp.ndarray,
    valid: jnp.ndarray,
    n_iters: int = 5,
    inlier_mps: float = 0.5,
) -> EgoMotion:
    """Batched IRLS ego-velocity fit over per-frame detection lists.

    Args:
      azimuth_deg: float (..., K) detection azimuths
        (``RDResult.azimuth_deg``).
      radial_velocity: float (..., K) measured radial velocities,
        positive = receding (``RDResult.velocity_mps``).
      valid: bool (..., K) usable-detection mask (``RDResult.valid``).
      n_iters: IRLS iterations (static; unrolled).
      inlier_mps: residual gate defining the static-scatterer set —
        leave headroom above the Doppler bin quantum (~0.24 m/s at the
        default geometry).

    Returns:
      :class:`EgoMotion`; degenerate frames get zero velocity,
      all-False ``is_static`` and ``ok`` False, matching the golden.
    """
    az = jnp.deg2rad(azimuth_deg.astype(jnp.float32))
    s, c = jnp.sin(az), jnp.cos(az)
    b = -radial_velocity.astype(jnp.float32)
    base = valid
    n_base = jnp.sum(base, axis=-1)
    w = base.astype(jnp.float32)
    vx = vy = jnp.zeros(az.shape[:-1], jnp.float32)
    good = jnp.zeros(az.shape[:-1], bool)
    resid = b
    for _ in range(max(1, int(n_iters))):
        a00 = jnp.sum(w * s * s, axis=-1)
        a01 = jnp.sum(w * s * c, axis=-1)
        a11 = jnp.sum(w * c * c, axis=-1)
        r0 = jnp.sum(w * s * b, axis=-1)
        r1 = jnp.sum(w * c * b, axis=-1)
        det = a00 * a11 - a01 * a01
        good = (n_base >= 3) & (det >= _DET_EPS)
        inv = 1.0 / jnp.where(good, det, 1.0)
        vx = jnp.where(good, (a11 * r0 - a01 * r1) * inv, 0.0)
        vy = jnp.where(good, (a00 * r1 - a01 * r0) * inv, 0.0)
        resid = b - (vx[..., None] * s + vy[..., None] * c)
        # Cauchy reweight over the BASE set (soft: a detection shed by
        # the mover-contaminated initial fit re-enters as the fit lands);
        # a frame gone degenerate keeps w = 0 and stays degenerate
        w = jnp.where(base & good[..., None],
                      1.0 / (1.0 + (resid / inlier_mps) ** 2), 0.0)
    static = (jnp.abs(resid) <= inlier_mps) & base & good[..., None]
    n_in = jnp.sum(static, axis=-1).astype(jnp.int32)
    ok = good & (n_in >= 3)
    static = static & ok[..., None]
    v = jnp.stack([vx, vy], axis=-1) * ok[..., None]
    return EgoMotion(v, static, ok, jnp.where(ok, n_in, 0))


def ego_compensated_velocity(
    azimuth_deg: jnp.ndarray,
    radial_velocity: jnp.ndarray,
    v_ego: jnp.ndarray,
) -> jnp.ndarray:
    """Ground-frame radial velocity: measured vr plus the ego projection
    ``vx sin az + vy cos az`` — ~zero for static scatterers when
    ``v_ego`` comes from :func:`estimate_ego_motion`.

    Args:
      azimuth_deg / radial_velocity: (..., K).
      v_ego: (..., 2), broadcast over the detection axis.
    """
    az = jnp.deg2rad(azimuth_deg.astype(jnp.float32))
    return (radial_velocity
            + v_ego[..., 0:1] * jnp.sin(az) + v_ego[..., 1:2] * jnp.cos(az))


# Host-side rigid-body combine over MULTIPLE sensors' fits (two-radar
# yaw-rate observability; a 2S x 3 least squares on scalars — no jnp
# twin needed).  Re-exported here so the ego-motion API has one home.
from mmradar.golden import (  # noqa: E402,F401
    estimate_ego_motion_yaw,
    mount_rotation,
)
