"""2D CFAR detectors (XLA formulation).

The reference detects with a bare argmax (single-target assumption,
acceleration.cu:522); CA-CFAR is the multi-target extension called for by
the north star.  Convention matches ``mmradar.golden.ca_cfar_2d``:
wrap-around padding on the Doppler axis (circular after fftshift),
reflect (default) or wrap padding on the range axis (range is NOT
circular — ``cfg.cfar_range_mode``), threshold alpha = N * (pfa^{-1/N} - 1).

CA expresses the guard/training window as two box sums via
``lax.reduce_window`` — fully fused and batched.  GO/SO use banded box
matrices, OS a sort of the training ring (threshold map) or a one-pass
count (hit map only, :func:`os_cfar_hits`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from mmradar.config import RadarConfig, DEFAULT_CONFIG


def _box_sum(
    power: jnp.ndarray, half_d: int, half_r: int, range_mode: str = "reflect"
) -> jnp.ndarray:
    """Sum over a (2*half_d+1, 2*half_r+1) window; Doppler wraps, range
    edge handling per ``range_mode`` ('reflect' or 'wrap')."""
    lead = [(0, 0)] * (power.ndim - 2)
    padded = jnp.pad(power, lead + [(half_d, half_d), (0, 0)], mode="wrap")
    padded = jnp.pad(
        padded, lead + [(0, 0), (half_r, half_r)], mode=range_mode
    )
    window = (1,) * (power.ndim - 2) + (2 * half_d + 1, 2 * half_r + 1)
    return jax.lax.reduce_window(
        padded,
        jnp.zeros((), power.dtype),
        jax.lax.add,
        window_dimensions=window,
        window_strides=(1,) * power.ndim,
        padding="VALID",
    )


def cfar_alpha(
    guard: tuple[int, int],
    train: tuple[int, int],
    pfa: float,
    n_pulses: int = 1,
) -> tuple[float, int]:
    """CA-CFAR threshold multiplier for the target ``pfa``.

    ``n_pulses = 1`` (per-frame maps): exponential cells, the closed
    form ``alpha = n (pfa^{-1/n} - 1)``.

    ``n_pulses = N > 1`` (non-coherently integrated maps,
    ``RDPipeline.detect_integrated``): the summed cells are Erlang-N and
    the training sum is Gamma(nN), for which

        Pfa(t) = sum_{k=0}^{N-1} C(nN+k-1, k) t^k / (1+t)^{nN+k}

    (threshold = t * training_sum; reduces to the closed form at N=1).
    Solved for t by bisection — keeping the single-pulse alpha on an
    integrated map throws most of the integration gain away: the
    threshold sits ~alpha above the (also N-scaled) noise mean, a
    deterministic gap variance averaging cannot cross, and measured Pd
    barely moved (0.28 -> 0.38 at the knee) until the alpha was
    re-solved for Erlang cells.

    Returns ``(alpha, n_train)`` with ``alpha = t * n_train`` (every
    consumer divides by ``n_train`` again — the historical
    parametrization).
    """
    gd, gr = guard
    td, tr = train
    wd, wr = gd + td, gr + tr
    n_train = (2 * wd + 1) * (2 * wr + 1) - (2 * gd + 1) * (2 * gr + 1)
    if n_pulses <= 1:
        return n_train * (pfa ** (-1.0 / n_train) - 1.0), n_train
    from math import exp, lgamma, log, log1p

    nn = n_train * n_pulses

    def pfa_of(t: float) -> float:
        lt, l1t = log(t), log1p(t)
        return sum(
            exp(lgamma(nn + k) - lgamma(k + 1) - lgamma(nn)
                + k * lt - (nn + k) * l1t)
            for k in range(n_pulses)
        )

    lo, hi = 1e-9, 10.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if pfa_of(mid) > pfa:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi) * n_train, n_train


# ---------------------------------------------------------------------------
# box sums as banded matrices
#
# A wrap/reflect box sum along one axis is a linear map with a constant
# banded 0/1/2 matrix, so a 2D box sum is Td @ p @ Sr^T.  The GO/SO
# half-window sums use this form (go_so_band_matrices).


@functools.lru_cache(maxsize=None)
def band_wrap_asym(n: int, lo: int, hi: int):
    """Circulant box matrix for offsets ``lo..hi`` inclusive:
    B[i, j] = multiplicity of column j in the window at i under wrap
    padding.  Multiplicity, not a 0/1 mask: when the window spans the
    axis wrap padding counts cells more than once, exactly like
    ``jnp.pad(mode='wrap')`` + ``reduce_window``.  An empty offset range
    (hi < lo) yields the zero matrix."""
    import numpy as np

    m = np.zeros((n, n), np.float32)
    for o in range(lo, hi + 1):
        for i in range(n):
            m[i, (i + o) % n] += 1.0
    return m


@functools.lru_cache(maxsize=None)
def band_reflect_asym(n: int, lo: int, hi: int):
    """Reflect-padded box matrix for offsets ``lo..hi`` inclusive
    (numpy 'reflect': edge not repeated; multi-bounce for windows wider
    than the axis, period 2n-2)."""
    import numpy as np

    if n == 1:
        return np.full((1, 1), float(max(0, hi - lo + 1)), np.float32)
    m = np.zeros((n, n), np.float32)
    period = 2 * n - 2
    for i in range(n):
        for p in range(i + lo, i + hi + 1):
            q = p % period
            if q >= n:
                q = period - q
            m[i, q] += 1.0
    return m


def band_wrap(n: int, w: int):
    """Symmetric circulant box matrix (offsets -w..w)."""
    return band_wrap_asym(n, -w, w)


def os_ring_params(cfg: RadarConfig):
    """(offsets, n_train, k, alpha) shared by every OS-CFAR twin.

    One definition of the training-ring order (guard excluded, decimated
    by ``cfg.cfar_os_stride``), the rank (half-away-from-zero rounding of
    ``k_frac * n``, matching the C++ llround) and the Rohling alpha — the
    sort form, the counting form and the golden model must agree
    bit-for-bit on all three, so they all consume this.
    """
    import math

    from mmradar.golden import os_cfar_alpha

    gd, gr = cfg.cfar_guard
    td, tr = cfg.cfar_train
    wd, wr = gd + td, gr + tr
    offsets = [
        (dd, dr)
        for dd in range(-wd, wd + 1)
        for dr in range(-wr, wr + 1)
        if not (abs(dd) <= gd and abs(dr) <= gr)
    ][:: cfg.cfar_os_stride]
    n_train = len(offsets)
    k = max(1, min(n_train, int(math.floor(cfg.cfar_os_k_frac * n_train + 0.5))))
    alpha = float(os_cfar_alpha(n_train, k, cfg.cfar_pfa,
                                cfg.cfar_pulses_effective))
    return offsets, n_train, k, alpha


def ca_cfar_2d(
    power: jnp.ndarray,
    cfg: RadarConfig = DEFAULT_CONFIG,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """CA-CFAR detection map.

    Args:
      power: float32 (..., doppler, range) non-negative power map.

    Returns:
      (hits bool (..., d, r), threshold float32 (..., d, r)).
    """
    gd, gr = cfg.cfar_guard
    td, tr = cfg.cfar_train
    alpha, n_train = cfar_alpha(cfg.cfar_guard, cfg.cfar_train,
                                cfg.cfar_pfa, cfg.cfar_pulses_effective)
    mode = cfg.cfar_range_mode
    total = _box_sum(power, gd + td, gr + tr, mode)
    inner = _box_sum(power, gd, gr, mode)
    noise = (total - inner) * jnp.asarray(1.0 / n_train, power.dtype)
    threshold = jnp.asarray(alpha, power.dtype) * noise
    return power > threshold, threshold


def os_cfar_2d(
    power: jnp.ndarray,
    cfg: RadarConfig = DEFAULT_CONFIG,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """2D ordered-statistic CFAR (twin of golden.os_cfar_2d).

    threshold = alpha_os * (k-th smallest training cell): robust where
    CA-CFAR's mean is biased — clutter edges and multiple targets inside
    the training ring.  The training ring is gathered as static slices of
    the padded map and sorted along the stacked axis; the per-frame
    temporary is n_train * D * R * 4 B (~16 MB at defaults), so frames
    are processed through ``lax.map`` rather than one broadcast sort.
    This is the form that yields the threshold MAP; the detection
    pipelines need only the hits and take :func:`os_cfar_hits` instead
    (``cfar_detect(hits_only=True)``).  ``cfg.cfar_os_stride`` decimates
    the ring.

    Args:
      power: float32 (..., doppler, range).

    Returns:
      (hits bool, threshold float32), shapes of ``power``.
    """
    gd, gr = cfg.cfar_guard
    td, tr = cfg.cfar_train
    wd, wr = gd + td, gr + tr
    d_sz, r_sz = power.shape[-2], power.shape[-1]

    offsets, n_train, k, alpha_f = os_ring_params(cfg)
    alpha = jnp.float32(alpha_f)

    def one_map(p: jnp.ndarray) -> jnp.ndarray:
        padded = jnp.pad(p, [(wd, wd), (0, 0)], mode="wrap")
        padded = jnp.pad(padded, [(0, 0), (wr, wr)], mode=cfg.cfar_range_mode)
        ring = jnp.stack(
            [
                jax.lax.dynamic_slice(
                    padded, (wd + dd, wr + dr), (d_sz, r_sz)
                )
                for dd, dr in offsets
            ],
            axis=-1,
        )
        kth = jnp.sort(ring, axis=-1)[..., k - 1]
        return alpha * kth

    lead = power.shape[:-2]
    flat = power.reshape((-1, d_sz, r_sz))
    threshold = jax.lax.map(one_map, flat).reshape(lead + (d_sz, r_sz))
    return power > threshold, threshold


def os_cfar_hits(
    power: jnp.ndarray,
    cfg: RadarConfig = DEFAULT_CONFIG,
) -> jnp.ndarray:
    """2D OS-CFAR hit map by counting, without the threshold map.

    Bit-identical to ``os_cfar_2d(power, cfg)[0]``.  The decision

        hit  <=>  p > RN(alpha * T_k)
             <=>  count_j( RN(alpha * v_j) < p ) >= k

    holds EXACTLY, float rounding included: v -> RN(alpha*v) is monotone
    non-decreasing (RN is monotone, alpha > 0), so the k-th smallest of
    the scaled ring IS RN(alpha * T_k), and for any sorted w,
    ``count(w < p) >= k  <=>  w_(k) < p``.  A cell whose power exactly
    equals RN(alpha * T_k) counts fewer than k strict inequalities,
    matching the strict ``power > threshold`` gate.

    The count accumulates ring offset by ring offset against static
    slices of the alpha-scaled padded map (one compare + one add per
    cell and offset, batched over frames) — no ring tensor and no sort.

    Args:
      power: float32 (..., doppler, range).

    Returns:
      hits bool, shape of ``power``.
    """
    gd, gr = cfg.cfar_guard
    td, tr = cfg.cfar_train
    wd, wr = gd + td, gr + tr
    d_sz, r_sz = power.shape[-2], power.shape[-1]
    offsets, _, k, alpha = os_ring_params(cfg)

    lead = [(0, 0)] * (power.ndim - 2)
    padded = jnp.pad(power, lead + [(wd, wd), (0, 0)], mode="wrap")
    padded = jnp.pad(padded, lead + [(0, 0), (wr, wr)],
                     mode=cfg.cfar_range_mode)
    scaled = jnp.float32(alpha) * padded
    cnt = jnp.zeros(power.shape, jnp.int32)
    for dd, dr in offsets:
        w = scaled[..., wd + dd : wd + dd + d_sz, wr + dr : wr + dr + r_sz]
        cnt = cnt + (w < power).astype(jnp.int32)
    return cnt >= k


def go_so_params(cfg: RadarConfig, kind: str) -> tuple[int, float]:
    """(n_half, t) shared by every GO/SO twin: cells per half window and
    the Gandhi-Kassam threshold multiplier (applied to the half SUM).
    One definition so the XLA path and the golden model cannot drift."""
    from mmradar.golden import go_so_cfar_alpha

    gd, gr = cfg.cfar_guard
    td, tr = cfg.cfar_train
    wd, wr = gd + td, gr + tr
    n_half = (2 * wd + 1) * wr - (2 * gd + 1) * gr
    if n_half <= 0:
        raise ValueError(
            f"{kind.upper()}CA-CFAR needs range training cells: "
            f"cfar_train[1] > 0 (got train={cfg.cfar_train})"
        )
    return n_half, float(go_so_cfar_alpha(n_half, cfg.cfar_pfa, kind,
                                          cfg.cfar_pulses_effective))


def go_so_band_matrices(cfg: RadarConfig, d_size: int, r_size: int):
    """(Td, Gd, AL, ALg, BL, BLg) f32 matrices for the GO/SO half-window
    sums: lead = Td@p@AL^T - Gd@p@ALg^T, lag mirrored."""
    gd, gr = cfg.cfar_guard
    td, tr = cfg.cfar_train
    wd, wr = gd + td, gr + tr
    mk_r = (band_wrap_asym if cfg.cfar_range_mode == "wrap"
            else band_reflect_asym)
    return (
        band_wrap(d_size, wd),
        band_wrap(d_size, gd),
        mk_r(r_size, 1, wr),
        mk_r(r_size, 1, gr),
        mk_r(r_size, -wr, -1),
        mk_r(r_size, -gr, -1),
    )


def go_so_cfar_2d(
    power: jnp.ndarray,
    cfg: RadarConfig = DEFAULT_CONFIG,
    kind: str = "go",
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """2D greatest-of (GOCA) / smallest-of (SOCA) cell-averaging CFAR
    (twin of ``golden.go_so_cfar_2d``; see there for the half-window
    contract — leading/lagging range halves, dr == 0 column excluded).

    The asymmetric half-window sums are banded matrices, so each half is
    ``Td @ p @ A^T - Gd @ p @ Ag^T`` — six HIGHEST-precision (full f32)
    matmuls per map, then an elementwise max/min.  GO resists clutter edges crossing the
    window in range; SO resists a second target in one half.
    """
    d_sz, r_sz = power.shape[-2], power.shape[-1]
    _, t_f = go_so_params(cfg, kind)
    td_m, gd_m, al, alg, bl, blg = (
        jnp.asarray(m) for m in go_so_band_matrices(cfg, d_sz, r_sz)
    )
    t = jnp.asarray(t_f, power.dtype)

    hp = jax.lax.Precision.HIGHEST  # exact f32: (lead-guard) cancels
    pd_t = jnp.einsum("ij,...jk->...ik", td_m, power, precision=hp)
    pd_g = jnp.einsum("ij,...jk->...ik", gd_m, power, precision=hp)
    lead = (jnp.einsum("...ik,lk->...il", pd_t, al, precision=hp)
            - jnp.einsum("...ik,lk->...il", pd_g, alg, precision=hp))
    lag = (jnp.einsum("...ik,lk->...il", pd_t, bl, precision=hp)
           - jnp.einsum("...ik,lk->...il", pd_g, blg, precision=hp))
    noise = jnp.maximum(lead, lag) if kind == "go" else jnp.minimum(
        lead, lag
    )
    threshold = t * noise
    return power > threshold, threshold


def cfar_detect(
    power: jnp.ndarray,
    cfg: RadarConfig = DEFAULT_CONFIG,
    hits_only: bool = False,
) -> tuple[jnp.ndarray, jnp.ndarray | None]:
    """Single dispatch point for the CFAR family on ``cfg.cfar_kind``
    ('ca'/'os'/'goca'/'soca').

    Both the local pipeline and the shard_map pipeline route through this,
    so kind validation and dispatch live in exactly one place.

    ``hits_only=True`` declares the caller discards the threshold map
    (every detection pipeline does — they unpack ``hits, _``).  For OS
    that selects the one-pass counting form (:func:`os_cfar_hits`) and
    returns ``(hits, None)``.  Other kinds produce the threshold as a
    byproduct and ignore the flag.
    """
    if cfg.cfar_kind == "os":
        if hits_only:
            return os_cfar_hits(power, cfg), None
        return os_cfar_2d(power, cfg)
    if cfg.cfar_kind in ("goca", "soca"):
        return go_so_cfar_2d(power, cfg, kind=cfg.cfar_kind[:2])
    return ca_cfar_2d(power, cfg)
