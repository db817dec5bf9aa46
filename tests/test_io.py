"""IO layer: on-disk layout contract, encode/decode round trip, file IO."""

import numpy as np
import pytest

from mmradar.io.capture import (
    decode_frame,
    encode_frame,
    frames_in_file,
    iter_frames,
    read_capture,
    write_capture,
)
from mmradar.io.synthetic import SceneTarget, synthesize_capture


def test_decode_layout_matches_reference_contract(cfg):
    """Bit-level check of the (I0,I1,Q0,Q1) interleave + chirp-major layout
    (reference acceleration.cu:91-150)."""
    rng = np.random.default_rng(0)
    shorts = rng.integers(-1000, 1000, cfg.shorts_per_frame, dtype=np.int16)
    cube = decode_frame(shorts, cfg)
    assert cube.shape == (cfg.num_rx, cfg.num_chirps, cfg.num_samples)

    # scalar reference decoder, straight from the survey contract
    cplx = np.empty(cfg.samples_per_frame, dtype=np.complex128)
    for k in range(cfg.samples_per_frame // 2):
        s = shorts[4 * k : 4 * k + 4].astype(np.float64)
        cplx[2 * k] = s[0] + 1j * s[2]
        cplx[2 * k + 1] = s[1] + 1j * s[3]
    for r in range(cfg.num_rx):
        for c in range(0, cfg.num_chirps, 17):
            for smp in range(0, cfg.num_samples, 13):
                src = c * cfg.num_rx * cfg.num_samples + r * cfg.num_samples + smp
                assert cube[r, c, smp] == cplx[src]


def test_encode_decode_roundtrip(cfg):
    rng = np.random.default_rng(1)
    cube = (
        rng.integers(-30000, 30000, (cfg.num_rx, cfg.num_chirps, cfg.num_samples))
        + 1j * rng.integers(-30000, 30000, (cfg.num_rx, cfg.num_chirps, cfg.num_samples))
    ).astype(np.complex128)
    shorts = encode_frame(cube, cfg)
    assert shorts.dtype == np.int16
    np.testing.assert_array_equal(decode_frame(shorts, cfg), cube)


def test_encode_rejects_overflow(cfg):
    cube = np.full((cfg.num_rx, cfg.num_chirps, cfg.num_samples), 40000 + 0j)
    with pytest.raises(ValueError):
        encode_frame(cube, cfg)


def test_batched_decode_matches_single(cfg, capture):
    batched = decode_frame(capture, cfg)
    for i in range(capture.shape[0]):
        np.testing.assert_array_equal(batched[i], decode_frame(capture[i], cfg))


def test_file_roundtrip(tmp_path, cfg, capture):
    path = tmp_path / "synth.bin"
    write_capture(path, capture, cfg)
    assert path.stat().st_size == capture.shape[0] * cfg.bytes_per_frame
    assert frames_in_file(path, cfg) == capture.shape[0]
    np.testing.assert_array_equal(read_capture(path, cfg), capture)
    streamed = list(iter_frames(path, cfg))
    assert len(streamed) == capture.shape[0]
    np.testing.assert_array_equal(np.stack(streamed), capture)


def test_malformed_file_rejected(tmp_path, cfg):
    """The reference silently truncates partial frames; we fail fast."""
    path = tmp_path / "bad.bin"
    path.write_bytes(b"\x00" * (cfg.bytes_per_frame + 7))
    with pytest.raises(ValueError):
        frames_in_file(path, cfg)


def test_synthetic_base_frame_has_no_targets(cfg):
    shorts = synthesize_capture(
        [SceneTarget(range_m=5.0, amplitude=3000.0)], 3, cfg, noise_std=0.0, seed=7
    )
    f0 = decode_frame(shorts[0], cfg)
    f1 = decode_frame(shorts[1], cfg)
    # frame 0 is clutter-only; frame 1 carries the target on top
    assert np.abs(f1 - f0).max() > 1000.0
    # clutter is frame-invariant: frame0 == the clutter component of frame1
    # only where the target doesn't dominate; just check f0 magnitude is
    # bounded by clutter amplitude
    assert np.abs(f0).max() <= 300.0 * np.sqrt(2) + 1
