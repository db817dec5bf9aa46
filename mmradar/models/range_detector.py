"""Reference-parity single-target range detector.

Replaces the reference's whole per-frame GPU orchestration
(``cudaProcessing``, acceleration.cu:417-572: 6 cudaMallocs, 4 PCIe
crossings, 17 kernel launches per frame) with ONE jitted, frame-batched
array program:

    int16 view -> complex64 -> transpose -> rx0 - base -> pad 16,384
    -> XLA FFT -> fused |X|^2 argmax -> distance scalars

The base frame is computed once and stays resident in HBM (the reference
re-uploads it every frame, acceleration.cu:475).  Only (bin, distance,
magnitude) scalars per frame ever leave the device.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from mmradar.config import RadarConfig, DEFAULT_CONFIG
from mmradar.models.impls import resolve_impl
from mmradar.ops.decode import decode_to_cube, rx0_slice
from mmradar.ops.detect import PeakDetection, peak_detect
from mmradar.ops.preproc import clutter_subtract_pad
from mmradar.ops.rangefft import range_fft


@dataclasses.dataclass(frozen=True)
class RangeDetector:
    """Frame-batched parity pipeline.

    Usage::

        det = RangeDetector(cfg)
        base = det.prepare_base(frames[0])      # frame 0 = empty scene
        out = det.detect(frames[1:], base)       # PeakDetection, batched

    Frozen + hashed by value (``self`` is a jit static argument): equal
    configs share one compiled program; mutation raises.

    Attributes:
      detect_impl: 'auto'/'xla' (|X|^2, scan-window mask and argmax as
        one XLA reduction fusion, ``ops.detect.peak_detect``).
    """

    cfg: RadarConfig = DEFAULT_CONFIG
    detect_impl: str = "auto"

    def __post_init__(self):
        resolve_impl("detect_impl", self.detect_impl)

    # -- base frame ------------------------------------------------------
    def prepare_base(self, frame0_shorts: jnp.ndarray) -> jnp.ndarray:
        """Decode frame 0 and keep its RX0 slice on-device
        (cudaBenchMarking.cpp:242-250)."""
        return self._prepare_base_jit(frame0_shorts)

    @partial(jax.jit, static_argnums=0)
    def _prepare_base_jit(self, frame0_shorts: jnp.ndarray) -> jnp.ndarray:
        return rx0_slice(decode_to_cube(frame0_shorts, self.cfg), self.cfg)

    # -- individual stages (for stage-level verification and the
    # reference-format 4-bucket timing report) ----------------------------
    @partial(jax.jit, static_argnums=0)
    def preprocess(self, shorts: jnp.ndarray, base_rx0: jnp.ndarray) -> jnp.ndarray:
        """decode -> rx0 -> clutter subtract -> pad ("Reshape + Extension")."""
        cube = decode_to_cube(shorts, self.cfg)
        return clutter_subtract_pad(rx0_slice(cube, self.cfg), base_rx0, self.cfg)

    @partial(jax.jit, static_argnums=0)
    def fft_stage(self, padded: jnp.ndarray) -> jnp.ndarray:
        return range_fft(padded, self.cfg)

    @partial(jax.jit, static_argnums=0)
    def detect_stage(self, spectrum: jnp.ndarray) -> PeakDetection:
        return peak_detect(spectrum, self.cfg)

    @partial(jax.jit, static_argnums=0)
    def spectrum(self, shorts: jnp.ndarray, base_rx0: jnp.ndarray) -> jnp.ndarray:
        """Range spectrum, complex64 (..., fft_size)."""
        cube = decode_to_cube(shorts, self.cfg)
        padded = clutter_subtract_pad(rx0_slice(cube, self.cfg), base_rx0, self.cfg)
        return range_fft(padded, self.cfg)

    # -- full detection ---------------------------------------------------
    @partial(jax.jit, static_argnums=0)
    def detect(self, shorts: jnp.ndarray, base_rx0: jnp.ndarray) -> PeakDetection:
        """Detect on a batch of raw frames.

        Args:
          shorts: int16 (batch, shorts_per_frame) — or unbatched (S,).
          base_rx0: complex64 (rx_samples,) from :meth:`prepare_base`.
        """
        return peak_detect(self.spectrum(shorts, base_rx0), self.cfg)

    # -- convenience: whole-capture run ------------------------------------
    def detect_capture(self, frames_shorts) -> PeakDetection:
        """Frame 0 is the base; detect frames 1..N-1 in one batch."""
        frames = jnp.asarray(frames_shorts)
        base = self.prepare_base(frames[0])
        return self.detect(frames[1:], base)

    # -- multi-chip data parallelism ----------------------------------------
    def detect_sharded(self, shorts, base_rx0, mesh) -> PeakDetection:
        """Pure-DP multi-chip detection: frames sharded over the mesh's
        'data' axis, base replicated.  Frames are independent, so XLA
        auto-partitions the jitted program with zero collectives — the
        sharding IS the parallelism (SURVEY.md §2.2 row 1)."""
        from jax.sharding import NamedSharding, PartitionSpec as P

        s = jax.device_put(
            jnp.asarray(shorts), NamedSharding(mesh, P("data", None))
        )
        b = jax.device_put(base_rx0, NamedSharding(mesh, P()))
        return self.detect(s, b)
