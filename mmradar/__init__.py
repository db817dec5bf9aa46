"""mmradar — mmWave FMCW radar object detection on GPUs with JAX.

A ground-up JAX/XLA rebuild of the capabilities of
``codingMMax/CUDA-based-mmWave-Radar-Object-Detection-Acceleration``
(reference mounted at /root/reference):

* TI DCA1000-style binary ADC capture ingest (reference
  cudaBenchMarking.cpp:121-188) — ``mmradar.io``
* decode / reshape / clutter-removal / zero-pad preprocessing
  (reference acceleration.cu:91-166) — ``mmradar.ops.decode``,
  ``mmradar.ops.preproc``
* 16K-point range FFT + peak-scan single-target range estimation
  (reference acceleration.cu:181-247, 391-407) — ``mmradar.ops.rangefft``,
  ``mmradar.ops.detect``
* extended pipeline: range-Doppler maps, CA-CFAR detection, angle of
  arrival (angle-FFT + Capon) — ``mmradar.ops.doppler/cfar/aoa``
* frame-batched, jitted end-to-end pipelines — ``mmradar.models``
* multi-device sharding + double-buffered host->device streaming —
  ``mmradar.parallel``

The float64 golden model lives in ``mmradar.golden`` (NumPy) with a
native C++ twin under ``cpp/`` (the reference's host path is C++).
"""

from mmradar.config import RadarConfig, DEFAULT_CONFIG

__version__ = "0.1.0"

__all__ = ["RadarConfig", "DEFAULT_CONFIG", "__version__"]
