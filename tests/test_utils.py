"""Timing + records utilities."""

import io
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mmradar.utils.records import DetectionRecord, JsonlWriter, last_frame_index
from mmradar.utils.timing import StageTimings, Timer, fence, time_fn


def test_timer_monotonic():
    t = Timer()
    time.sleep(0.01)
    a = t.elapsed()
    assert a >= 0.01
    t.reset()
    assert t.elapsed() < a


def test_stage_timings_report():
    st = StageTimings(preprocess=0.1, fft=0.2, detect=0.05, total=0.4, frames=10)
    assert st.fps == 25.0
    assert st.per_frame_ms("fft") == 20.0
    rep = st.report()
    assert "Total FFT time" in rep and "FPS" in rep


@pytest.mark.parametrize("dtype", ["complex64", "int32"])
def test_fence_waits_on_complex_and_int_leaves(dtype):
    """fence is jax.block_until_ready: complex and integer leaves are
    fenced as they are (no reduction, no dtype restriction), alongside
    host values."""
    leaf = (jnp.arange(6) * (1 + 2j if dtype == "complex64" else 1)
            ).astype(dtype).reshape(2, 3)
    out = jax.jit(lambda x: x * 2)(leaf)
    assert fence({"dev": out, "host": 3.0, "np": np.ones(2)}) is None
    assert out.is_ready()
    np.testing.assert_array_equal(np.asarray(out), 2 * np.asarray(leaf))


def test_fence_handles_mixed_trees():
    tree = {
        "c": jnp.ones((4,), jnp.complex64),
        "i": jnp.arange(3, dtype=jnp.int32),
        "b": jnp.array([True, False]),
        "f": jnp.ones((2, 2)),
    }
    fence(tree)  # must not raise


def test_time_fn_returns_positive():
    f = lambda x: jnp.sum(x * 2)
    dt = time_fn(f, jnp.ones((128,)), iters=3, warmup=1)
    assert dt > 0


def test_records_roundtrip(tmp_path):
    buf = io.StringIO()
    w = JsonlWriter(buf)
    w.write_all(
        [
            DetectionRecord(frame=1, peak_bin=10, distance_m=1.5, magnitude=2.0),
            DetectionRecord(
                frame=2, peak_bin=11, distance_m=1.6, magnitude=2.1,
                detections=[{"range_m": 1.6}],
            ),
        ]
    )
    lines = buf.getvalue().splitlines()
    assert json.loads(lines[0]) == {
        "frame": 1, "peak_bin": 10, "distance_m": 1.5, "magnitude": 2.0
    }
    assert json.loads(lines[1])["detections"] == [{"range_m": 1.6}]

    p = tmp_path / "r.jsonl"
    p.write_text("\n".join(lines) + "\n")
    assert last_frame_index(p) == 2
    assert last_frame_index(tmp_path / "missing.jsonl") == -1
