"""ctypes bindings to the native C++ golden model (cpp/golden.cc).

Builds the shared library on demand via ``make`` (g++ is part of the
toolchain; pybind11 is not available, so the C ABI + ctypes is the
binding layer).  All functions accept/return NumPy arrays.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

from mmradar.config import RadarConfig, DEFAULT_CONFIG

_CPP_DIR = Path(__file__).resolve().parent.parent / "cpp"
_LIB_PATH = _CPP_DIR / "build" / "libradar_golden.so"


class _CRadarParams(ctypes.Structure):
    _fields_ = [
        ("num_samples", ctypes.c_int),
        ("num_chirps", ctypes.c_int),
        ("num_rx", ctypes.c_int),
        ("sample_rate_hz", ctypes.c_double),
        ("slope_hz_per_s", ctypes.c_double),
        ("scan_fraction", ctypes.c_double),
    ]


class _CRangeDetection(ctypes.Structure):
    _fields_ = [
        ("peak_bin", ctypes.c_int),
        ("rescaled_bin", ctypes.c_int),
        ("distance_m", ctypes.c_double),
        ("magnitude", ctypes.c_double),
    ]


def _params(cfg: RadarConfig) -> _CRadarParams:
    return _CRadarParams(
        num_samples=cfg.num_samples,
        num_chirps=cfg.num_chirps,
        num_rx=cfg.num_rx,
        sample_rate_hz=cfg.sample_rate_hz,
        slope_hz_per_s=cfg.slope_hz_per_s,
        scan_fraction=cfg.scan_fraction,
    )


def build_library(force: bool = False) -> Path:
    """Build cpp/build/libradar_golden.so via make.

    Always invokes make: the Makefile tracks golden.cc/golden.h deps, so an
    up-to-date build is a no-op, while short-circuiting on the .so's mere
    existence would load a stale library after a C ABI change (symbol
    errors at best, shifted-argument corruption at worst).
    """
    del force  # kept for API compatibility; make decides staleness
    subprocess.run(
        ["make", "-C", str(_CPP_DIR)],
        check=True,
        capture_output=True,
        text=True,
    )
    return _LIB_PATH


_lib = None


def load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        lib.radar_decode_frame.argtypes = [
            ctypes.POINTER(_CRadarParams),
            ctypes.POINTER(ctypes.c_int16),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.radar_fft.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int,
        ]
        lib.radar_find_abs_max.restype = ctypes.c_int
        lib.radar_detect_frame.argtypes = [
            ctypes.POINTER(_CRadarParams),
            ctypes.POINTER(ctypes.c_int16),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(_CRangeDetection),
        ]
        lib.radar_base_frame.argtypes = lib.radar_detect_frame.argtypes[:4]
        lib.radar_process_capture.argtypes = [
            ctypes.POINTER(_CRadarParams),
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int,
        ]
        lib.radar_process_capture.restype = ctypes.c_int
        dp = ctypes.POINTER(ctypes.c_double)
        lib.radar_range_doppler.argtypes = [
            dp, dp, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, dp, dp,
        ]
        lib.radar_ca_cfar.argtypes = [
            dp, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int,
            ctypes.c_int, dp, ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.radar_os_cfar.argtypes = [
            dp, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, dp,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.radar_os_cfar_alpha.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int,
        ]
        lib.radar_os_cfar_alpha.restype = ctypes.c_double
        lib.radar_go_so_cfar.argtypes = [
            dp, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, dp,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.radar_go_so_cfar_alpha.argtypes = [
            ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_int,
        ]
        lib.radar_go_so_cfar_alpha.restype = ctypes.c_double
        lib.radar_ca_cfar_alpha_integrated.argtypes = [
            ctypes.c_int, ctypes.c_double, ctypes.c_int,
        ]
        lib.radar_ca_cfar_alpha_integrated.restype = ctypes.c_double
        lib.radar_clutter_map_alpha.argtypes = [
            ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_int,
        ]
        lib.radar_clutter_map_alpha.restype = ctypes.c_double
        lib.radar_clutter_map_cfar.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_double),
        ]
        _lib = lib
    return _lib


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _sptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))


def decode_frame(shorts: np.ndarray, cfg: RadarConfig = DEFAULT_CONFIG):
    """Native decode: returns complex128 (rx, chirps, samples) cube."""
    lib = load()
    shorts = np.ascontiguousarray(shorts, dtype=np.int16)
    n = cfg.num_rx * cfg.num_chirps * cfg.num_samples
    re = np.empty(n, np.float64)
    im = np.empty(n, np.float64)
    p = _params(cfg)
    lib.radar_decode_frame(ctypes.byref(p), _sptr(shorts), _dptr(re), _dptr(im))
    cube = (re + 1j * im).reshape(cfg.num_rx, cfg.num_chirps, cfg.num_samples)
    return cube


def fft(x: np.ndarray) -> np.ndarray:
    """Native in-place radix-2 FFT (returns a new array)."""
    lib = load()
    x = np.asarray(x, np.complex128)
    n = len(x)
    if n == 0 or n & (n - 1):
        raise ValueError(f"size must be a power of two, got {n}")
    re = np.ascontiguousarray(x.real)
    im = np.ascontiguousarray(x.imag)
    lib.radar_fft(_dptr(re), _dptr(im), len(x))
    return re + 1j * im


def detect_frame(
    frame_shorts: np.ndarray,
    base_rx0: np.ndarray,
    cfg: RadarConfig = DEFAULT_CONFIG,
):
    """Native per-frame detection.  base_rx0: complex (rx_samples,)."""
    lib = load()
    frame = np.ascontiguousarray(frame_shorts, dtype=np.int16)
    bre = np.ascontiguousarray(base_rx0.real, np.float64)
    bim = np.ascontiguousarray(base_rx0.imag, np.float64)
    out = _CRangeDetection()
    p = _params(cfg)
    lib.radar_detect_frame(
        ctypes.byref(p), _sptr(frame), _dptr(bre), _dptr(bim), ctypes.byref(out)
    )
    return out


def base_frame(frame0_shorts: np.ndarray, cfg: RadarConfig = DEFAULT_CONFIG):
    lib = load()
    frame = np.ascontiguousarray(frame0_shorts, dtype=np.int16)
    re = np.empty(cfg.rx_samples, np.float64)
    im = np.empty(cfg.rx_samples, np.float64)
    p = _params(cfg)
    lib.radar_base_frame(ctypes.byref(p), _sptr(frame), _dptr(re), _dptr(im))
    return re + 1j * im


# window-kind -> C enum for radar_range_doppler (cpp/golden.h); 0/1 keep
# the historical rect/hann bool meaning.
_WINDOW_ENUM = {
    "rect": 0, "hann": 1, "hamming": 2, "blackman": 3, "blackmanharris": 4,
}


def range_doppler_map(
    channel: np.ndarray,
    cfg: RadarConfig = DEFAULT_CONFIG,
    window: bool | str = True,
) -> np.ndarray:
    """Native RD map for one channel: complex (chirps, samples) ->
    complex (doppler_fft, range_fft), Doppler fftshifted.

    ``window`` follows the package-wide convention (ops/window.py):
    False for none, True for the config's kind (cfg.window_kind), or an
    explicit kind string; the C++ twin computes the cosine-sum taps
    itself (an independent implementation, not Python-fed)."""
    lib = load()
    x = np.asarray(channel, np.complex128)
    c, s = x.shape
    re = np.ascontiguousarray(x.real)
    im = np.ascontiguousarray(x.imag)
    d, r = cfg.doppler_fft_size, cfg.range_fft_size
    out_re = np.empty((d, r), np.float64)
    out_im = np.empty((d, r), np.float64)
    # falsy -> rect, kind string -> itself, any other truthy -> the
    # config's kind (same effective behavior as the golden twin's
    # `if window:` gate for bools; tolerant of 0/1/np.bool_ flags)
    kind = "rect" if not window else (
        window if isinstance(window, str) else cfg.window_kind
    )
    if kind not in _WINDOW_ENUM:
        # same error class as the golden twin (golden.window_fn), so
        # CLI-style `except ValueError` input handling covers both
        raise ValueError(
            f"window kind must be one of {sorted(_WINDOW_ENUM)}, "
            f"not {kind!r}"
        )
    lib.radar_range_doppler(
        _dptr(re), _dptr(im), c, s, d, r, _WINDOW_ENUM[kind],
        _dptr(out_re), _dptr(out_im),
    )
    return out_re + 1j * out_im


def ca_cfar_2d(
    power: np.ndarray, cfg: RadarConfig = DEFAULT_CONFIG
) -> tuple[np.ndarray, np.ndarray]:
    """Native 2D CA-CFAR: (hits bool, threshold) for a (d, r) power map."""
    import ctypes as ct

    lib = load()
    p = np.ascontiguousarray(power, np.float64)
    d, r = p.shape
    thresh = np.empty((d, r), np.float64)
    hits = np.empty((d, r), np.uint8)
    lib.radar_ca_cfar(
        _dptr(p), d, r, cfg.cfar_guard[0], cfg.cfar_guard[1],
        cfg.cfar_train[0], cfg.cfar_train[1], cfg.cfar_pfa,
        cfg.cfar_pulses_effective,
        1 if cfg.cfar_range_mode == "reflect" else 0, _dptr(thresh),
        hits.ctypes.data_as(ct.POINTER(ct.c_uint8)),
    )
    return hits.astype(bool), thresh


def os_cfar_2d(
    power: np.ndarray, cfg: RadarConfig = DEFAULT_CONFIG
) -> tuple[np.ndarray, np.ndarray]:
    """Native ordered-statistic CFAR (twin of golden.os_cfar_2d)."""
    import ctypes as ct

    lib = load()
    p = np.ascontiguousarray(power, np.float64)
    d, r = p.shape
    thresh = np.empty((d, r), np.float64)
    hits = np.empty((d, r), np.uint8)
    lib.radar_os_cfar(
        _dptr(p), d, r, cfg.cfar_guard[0], cfg.cfar_guard[1],
        cfg.cfar_train[0], cfg.cfar_train[1], cfg.cfar_pfa,
        cfg.cfar_os_k_frac, cfg.cfar_os_stride, cfg.cfar_pulses_effective,
        1 if cfg.cfar_range_mode == "reflect" else 0, _dptr(thresh),
        hits.ctypes.data_as(ct.POINTER(ct.c_uint8)),
    )
    return hits.astype(bool), thresh


def ca_cfar_alpha_integrated(
    n_train: int, pfa: float, n_pulses: int
) -> float:
    """Native Erlang-matched CA-CFAR threshold ratio (twin of
    golden.ca_cfar_alpha_integrated — same bisection in double)."""
    return float(load().radar_ca_cfar_alpha_integrated(
        int(n_train), float(pfa), int(n_pulses)
    ))


def clutter_map_alpha(pfa: float, beta: float, block: int = 1,
                      n_pulses: int = 1) -> float:
    """Native clutter-map threshold multiplier (twin of
    golden.clutter_map_alpha — same bisection + MGF-derivative series
    in double)."""
    a = float(load().radar_clutter_map_alpha(
        float(pfa), float(beta), int(block), int(n_pulses)))
    if a < 0:
        raise ValueError("invalid clutter-map parameters")
    return a


def clutter_map_cfar(
    power: np.ndarray,
    pfa: float,
    beta: float = 0.25,
    m0: np.ndarray | None = None,
    block: int = 16,
    n_pulses: int = 1,
) -> tuple[np.ndarray, np.ndarray]:
    """Native clutter-map (Nitzberg) CFAR (twin of
    golden.clutter_map_cfar: block-updated per-cell recursive
    background, decisions against the pre-update map)."""
    import ctypes as ct

    lib = load()
    p = np.ascontiguousarray(power, np.float64)
    f, d, r = p.shape
    hits = np.empty((f, d, r), np.uint8)
    m_out = np.empty((d, r), np.float64)
    m0_arr = (np.ascontiguousarray(m0, np.float64)
              if m0 is not None else None)
    lib.radar_clutter_map_cfar(
        _dptr(p), f, d, r, float(pfa), float(beta), int(block),
        int(n_pulses),
        _dptr(m0_arr) if m0_arr is not None
        else ct.cast(None, ct.POINTER(ct.c_double)),
        hits.ctypes.data_as(ct.POINTER(ct.c_uint8)), _dptr(m_out),
    )
    return hits.astype(bool), m_out


def go_so_cfar_2d(
    power: np.ndarray, cfg: RadarConfig = DEFAULT_CONFIG, kind: str = "go"
) -> tuple[np.ndarray, np.ndarray]:
    """Native GO/SO-CFAR (twin of golden.go_so_cfar_2d)."""
    import ctypes as ct

    lib = load()
    p = np.ascontiguousarray(power, np.float64)
    d, r = p.shape
    thresh = np.empty((d, r), np.float64)
    hits = np.empty((d, r), np.uint8)
    lib.radar_go_so_cfar(
        _dptr(p), d, r, cfg.cfar_guard[0], cfg.cfar_guard[1],
        cfg.cfar_train[0], cfg.cfar_train[1], cfg.cfar_pfa,
        0 if kind == "go" else 1, cfg.cfar_pulses_effective,
        1 if cfg.cfar_range_mode == "reflect" else 0, _dptr(thresh),
        hits.ctypes.data_as(ct.POINTER(ct.c_uint8)),
    )
    return hits.astype(bool), thresh


def process_capture(
    path: str | os.PathLike,
    cfg: RadarConfig = DEFAULT_CONFIG,
    max_frames: int = -1,
):
    """Native streaming benchmark.  Returns (distances, timings dict)."""
    lib = load()
    # the distances buffer is caller-sized: always pass its capacity as the
    # C-side frame cap so the loop can never write past the allocation
    cap = 1 << 20 if max_frames < 0 else max_frames
    dists = np.zeros(cap, np.float64)
    t = np.zeros(4, np.float64)
    p = _params(cfg)
    n = lib.radar_process_capture(
        ctypes.byref(p), str(path).encode(), _dptr(t), _dptr(dists), cap
    )
    if n < 0:
        raise IOError(f"cannot process capture {path}")
    return dists[:n], {
        "total": t[0],
        "fft": t[1],
        "preprocess": t[2],
        "findmax": t[3],
        "frames": n,
    }
