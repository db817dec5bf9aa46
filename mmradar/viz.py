"""Matplotlib visualization for radar products.

Engineering plots for captures, detections, and tracks.  Conventions:
magnitude maps use a single perceptually-uniform sequential colormap,
detections overlay as outlined markers (identity never by color alone),
one axis per chart, categorical series colors in fixed order.

Headless-safe: uses the Agg backend unless one is already selected.
"""

from __future__ import annotations

import numpy as np

import os

import matplotlib

# Headless fallback only: never override an interactive session's backend.
if os.environ.get("DISPLAY") is None and os.environ.get(
    "MPLBACKEND"
) is None and "agg" not in matplotlib.get_backend().lower():
    try:
        matplotlib.use("Agg")
    except Exception:
        pass

import matplotlib.pyplot as plt

from mmradar.config import RadarConfig, DEFAULT_CONFIG

# fixed categorical order for track series
_SERIES = ["#4477aa", "#ee6677", "#228833", "#ccbb44", "#66ccee", "#aa3377"]


def plot_range_profile(
    spectrum: np.ndarray,
    cfg: RadarConfig = DEFAULT_CONFIG,
    peak_bin: int | None = None,
    path: str | None = None,
):
    """Range spectrum magnitude over the scan window, axis in meters."""
    mag = np.abs(np.asarray(spectrum))[: cfg.scan_bins]
    ranges = np.array(
        [cfg.bin_to_physical_distance(i) for i in range(cfg.scan_bins)]
    )
    fig, ax = plt.subplots(figsize=(8, 3.2), constrained_layout=True)
    ax.plot(ranges, mag, lw=1.2, color=_SERIES[0])
    if peak_bin is not None:
        ax.plot(
            ranges[peak_bin], mag[peak_bin], "o", ms=7,
            mfc="none", mec=_SERIES[1], mew=1.6,
            label=f"peak: {ranges[peak_bin]:.2f} m",
        )
        ax.legend(frameon=False)
    ax.set_xlabel("range (m)")
    ax.set_ylabel("|X|")
    ax.grid(alpha=0.25, lw=0.5)
    ax.spines[["top", "right"]].set_visible(False)
    if path:
        fig.savefig(path, dpi=120)
        plt.close(fig)
    return fig


def plot_range_doppler(
    power: np.ndarray,
    cfg: RadarConfig = DEFAULT_CONFIG,
    detections: list[dict] | None = None,
    path: str | None = None,
    db: bool = True,
):
    """RD power map with physical axes and optional detection overlay.

    Args:
      power: (doppler, range) non-negative power.
      detections: dicts with range_m / velocity_mps (e.g. from
        tracker.detections_from_result).
    """
    p = np.asarray(power, np.float64)
    img = 10.0 * np.log10(np.maximum(p, p.max() * 1e-8)) if db else p
    d, r = p.shape
    v_max = (d // 2) / (d * cfg.slow_time_interval_s) * cfg.wavelength_m / 2
    r_max = cfg.sample_rate_hz * 3.0e8 / (2 * cfg.slope_hz_per_s)  # full axis
    r_max = r_max * (r - 1) / r
    fig, ax = plt.subplots(figsize=(7, 4.6), constrained_layout=True)
    im = ax.imshow(
        img,
        origin="lower",
        aspect="auto",
        extent=[0, r_max, -v_max, v_max],
        cmap="magma",
        interpolation="nearest",
    )
    fig.colorbar(im, ax=ax, label="power (dB)" if db else "power")
    if detections:
        ax.plot(
            [det["range_m"] for det in detections],
            [det["velocity_mps"] for det in detections],
            "o", ms=9, mfc="none", mec="#66ccee", mew=1.8,
            label="CFAR detections",
        )
        # object boxes when the dicts carry cluster fields (detect
        # --cluster records): ONE rectangle per cluster_id (member slots
        # repeat the stats with last-ulp and Doppler-alias differences,
        # so value-keying would duplicate boxes), sized by the
        # component's bounding extent around its centroid.  Dicts
        # without a cluster_id fall back to keying on the ROUNDED
        # centroid+extent — quantized past the member slots' last-ulp
        # spread, with velocity folded modulo the unambiguous Doppler
        # span so alias-shifted member copies still collapse to one box.
        # full unambiguous velocity span (Doppler bin width * bins)
        v_span = cfg.wavelength_m / 2 / cfg.slow_time_interval_s
        boxes = {}
        for det in detections:
            if "cluster_extent_bins" in det:
                key = det.get("cluster_id")
                if key is None:
                    key = (round(det["cluster_range_m"], 6),
                           round(det["cluster_velocity_mps"] % v_span, 6),
                           tuple(det["cluster_extent_bins"]))
                boxes.setdefault(
                    key,
                    (det["cluster_range_m"], det["cluster_velocity_mps"],
                     tuple(det["cluster_extent_bins"])),
                )
        if boxes:
            from matplotlib.patches import Rectangle

            r_bin_m = r_max / (r - 1)
            v_bin = cfg.wavelength_m / 2 / (d * cfg.slow_time_interval_s)
            for cr, cv, (ext_d, ext_r) in boxes.values():
                w, h = ext_r * r_bin_m, ext_d * v_bin
                ax.add_patch(Rectangle(
                    (cr - w / 2, cv - h / 2), w, h,
                    fill=False, edgecolor="#88ddaa", linewidth=1.2,
                ))
        ax.legend(frameon=False, loc="upper right", labelcolor="white")
    ax.set_xlabel("range (m)")
    ax.set_ylabel("radial velocity (m/s)")
    if path:
        fig.savefig(path, dpi=120)
        plt.close(fig)
    return fig


def plot_micro_doppler(
    spec,
    cfg: RadarConfig = DEFAULT_CONFIG,
    hop_frames: int = 1,
    path: str | None = None,
    db: bool = True,
):
    """Micro-Doppler spectrogram: time (windows) x radial velocity.

    ``spec`` is the (n_windows, n_fft) power from
    ``ops.mdoppler.micro_doppler_spectrogram`` (Doppler axis fftshifted).
    """
    from mmradar.golden import micro_doppler_velocity_axis

    s = np.asarray(spec, np.float64)
    n_win, n_fft = s.shape
    v = micro_doppler_velocity_axis(n_fft, cfg)
    dt = hop_frames * cfg.num_chirps * cfg.chirp_interval_s
    img = 10 * np.log10(np.maximum(s, 1e-20)) if db else s
    fig, ax = plt.subplots(figsize=(8, 4), constrained_layout=True)
    im = ax.imshow(
        img.T,
        origin="lower",
        aspect="auto",
        extent=[0, n_win * dt * 1e3, v[0], v[-1]],
        cmap="magma",
        interpolation="nearest",
    )
    fig.colorbar(im, ax=ax, label="power (dB)" if db else "power")
    ax.set_xlabel("time (ms)")
    ax.set_ylabel("radial velocity (m/s)")
    if path:
        fig.savefig(path, dpi=120)
        plt.close(fig)
    return fig


def plot_range_azimuth(
    pmap,
    cfg: RadarConfig = DEFAULT_CONFIG,
    path: str | None = None,
    db: bool = True,
    angles_deg=None,
):
    """Range-azimuth heatmap with physical axes.

    ``pmap`` is the (num_angle_bins, range_fft) power from
    ``ops.aoa.range_azimuth_from_shorts`` (angle axis fftshifted; the
    sin-space bins map nonuniformly to degrees, so the plot uses
    pcolormesh with the true per-bin coordinates) — or a Capon map,
    whose uniform grid the caller passes via ``angles_deg``.
    """
    from mmradar.golden import angle_bin_to_deg

    p = np.asarray(pmap, np.float64)
    a, r = p.shape
    img = 10.0 * np.log10(np.maximum(p, p.max() * 1e-8)) if db else p
    deg = (np.asarray(angles_deg) if angles_deg is not None
           else angle_bin_to_deg(np.arange(a), a, cfg))
    r_max = cfg.sample_rate_hz * 3.0e8 / (2 * cfg.slope_hz_per_s)
    rng = np.arange(r) * r_max / r
    fig, ax = plt.subplots(figsize=(7, 4.6), constrained_layout=True)
    im = ax.pcolormesh(rng, deg, img, cmap="magma", shading="nearest")
    fig.colorbar(im, ax=ax, label="power (dB)" if db else "power")
    ax.set_xlabel("range (m)")
    ax.set_ylabel("azimuth (deg)")
    if path:
        fig.savefig(path, dpi=120)
        plt.close(fig)
    return fig


def plot_angle_doppler(
    pmap,
    cfg: RadarConfig = DEFAULT_CONFIG,
    path: str | None = None,
    db: bool = True,
):
    """Angle-Doppler heatmap at a range gate with physical axes.

    ``pmap`` is the (doppler_fft, num_angle_bins) power from
    ``ops.aoa.angle_doppler_from_shorts`` (both axes fftshifted; the
    sin-space angle bins map nonuniformly to degrees, so pcolormesh with
    the true per-bin coordinates, like :func:`plot_range_azimuth`)."""
    from mmradar.golden import angle_bin_to_deg

    p = np.asarray(pmap, np.float64)
    d, a = p.shape
    img = 10.0 * np.log10(np.maximum(p, p.max() * 1e-8)) if db else p
    deg = angle_bin_to_deg(np.arange(a), a, cfg)
    v_max = cfg.wavelength_m / (4.0 * cfg.slow_time_interval_s)
    vel = (np.arange(d) - d // 2) * (2.0 * v_max / d)
    fig, ax = plt.subplots(figsize=(7, 4.6), constrained_layout=True)
    im = ax.pcolormesh(deg, vel, img, cmap="magma", shading="nearest")
    fig.colorbar(im, ax=ax, label="power (dB)" if db else "power")
    ax.set_xlabel("azimuth (deg)")
    ax.set_ylabel("radial velocity (m/s)")
    if path:
        fig.savefig(path, dpi=120)
        plt.close(fig)
    return fig


def plot_rti(
    m,
    cfg: RadarConfig = DEFAULT_CONFIG,
    path: str | None = None,
    db: bool = True,
):
    """Range-time intensity waterfall: frames (time) x range.

    ``m`` is the (frames, range_fft) Doppler-integrated power from
    ``cli rti``."""
    m = np.asarray(m, np.float64)
    n_f, r = m.shape
    img = 10.0 * np.log10(np.maximum(m, m.max() * 1e-8)) if db else m
    r_max = cfg.sample_rate_hz * 3.0e8 / (2 * cfg.slope_hz_per_s)
    dt = cfg.num_chirps * cfg.chirp_interval_s
    fig, ax = plt.subplots(figsize=(7, 4.2), constrained_layout=True)
    im = ax.imshow(
        img,
        origin="lower",
        aspect="auto",
        extent=[0, r_max, 0, n_f * dt * 1e3],
        cmap="magma",
        interpolation="nearest",
    )
    fig.colorbar(im, ax=ax, label="power (dB)" if db else "power")
    ax.set_xlabel("range (m)")
    ax.set_ylabel("time (ms)")
    if path:
        fig.savefig(path, dpi=120)
        plt.close(fig)
    return fig


def plot_point_cloud(
    rows,
    cfg: RadarConfig = DEFAULT_CONFIG,
    path: str | None = None,
):
    """Top-down (x: cross-range, y: boresight) scatter of exported point
    rows (``utils.points.FIELDS`` order), colored by radial velocity.

    The bird's-eye view downstream perception consumes; pairs with
    ``detect --points``.
    """
    rows = list(rows)
    fig, ax = plt.subplots(figsize=(5.2, 5.2), constrained_layout=True)
    if rows:
        arr = np.asarray([[r[1], r[2], r[4]] for r in rows], np.float64)
        vmax = max(1e-6, float(np.abs(arr[:, 2]).max()))
        sc = ax.scatter(arr[:, 0], arr[:, 1], c=arr[:, 2], cmap="coolwarm",
                        vmin=-vmax, vmax=vmax, s=14, lw=0)
        fig.colorbar(sc, ax=ax, label="radial velocity (m/s)", shrink=0.8)
    lim = cfg.max_range_m
    ax.set_xlim(-lim, lim)
    ax.set_ylim(0.0, lim)
    ax.set_aspect("equal")
    ax.set_xlabel("cross-range x (m)")
    ax.set_ylabel("boresight y (m)")
    ax.grid(alpha=0.25, lw=0.5)
    ax.spines[["top", "right"]].set_visible(False)
    if path:
        fig.savefig(path, dpi=120)
        plt.close(fig)
    return fig


def plot_bev(
    x_w,
    y_w,
    is_static,
    v_ground,
    pose,
    cfg: RadarConfig = DEFAULT_CONFIG,
    path: str | None = None,
):
    """World-frame bird's-eye view: accumulated detections + platform
    trajectory (``cli bev``).  Static world in gray, movers colored by
    ground-frame radial velocity, the dead-reckoned platform path as a
    line from the origin."""
    x_w = np.asarray(x_w, np.float64)
    y_w = np.asarray(y_w, np.float64)
    st = np.asarray(is_static, bool)
    vg = np.asarray(v_ground, np.float64)
    pose = np.asarray(pose, np.float64)
    fig, ax = plt.subplots(figsize=(5.6, 5.6), constrained_layout=True)
    if st.any():
        ax.scatter(x_w[st], y_w[st], c="#9a9a9a", s=12, lw=0,
                   label="static world")
    mv = ~st
    if mv.any():
        vmax = max(1e-6, float(np.abs(vg[mv]).max()))
        sc = ax.scatter(x_w[mv], y_w[mv], c=vg[mv], cmap="coolwarm",
                        vmin=-vmax, vmax=vmax, s=16, lw=0, label="movers")
        fig.colorbar(sc, ax=ax, label="ground radial velocity (m/s)",
                     shrink=0.8)
    ax.plot(pose[:, 0], pose[:, 1], "-", color=_SERIES[0], lw=1.4,
            label="platform path")
    ax.plot([0.0], [0.0], "^", color=_SERIES[0], ms=8)
    ax.set_xlabel("world x (m)")
    ax.set_ylabel("world y (m)")
    ax.set_aspect("equal")
    ax.grid(alpha=0.25, lw=0.5)
    ax.legend(frameon=False, fontsize=8)
    ax.spines[["top", "right"]].set_visible(False)
    if path:
        fig.savefig(path, dpi=120)
        plt.close(fig)
    return fig


def plot_tracks(
    tracker,
    cfg: RadarConfig = DEFAULT_CONFIG,
    path: str | None = None,
):
    """Track range histories over time, one fixed-order color per track."""
    fig, ax = plt.subplots(figsize=(8, 3.6), constrained_layout=True)
    dt = cfg.num_chirps * cfg.chirp_interval_s
    confirmed = [t for t in tracker.tracks if t.confirmed]
    for i, tr in enumerate(confirmed):
        hist = np.array([h[0] for h in tr.history])
        t_axis = np.arange(len(hist)) * dt * 1e3
        color = _SERIES[i % len(_SERIES)]
        ax.plot(t_axis, hist, lw=1.6, color=color)
        ax.annotate(
            f"track {tr.track_id}", (t_axis[-1], hist[-1]),
            textcoords="offset points", xytext=(4, 0), fontsize=8,
        )
    ax.set_xlabel("time (ms)")
    ax.set_ylabel("range (m)")
    ax.grid(alpha=0.25, lw=0.5)
    ax.spines[["top", "right"]].set_visible(False)
    if path:
        fig.savefig(path, dpi=120)
        plt.close(fig)
    return fig
