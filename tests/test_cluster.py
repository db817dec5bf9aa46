"""Detection clustering: the device min-propagation labeler vs the golden
BFS, wrap semantics, object stats, and the detect_objects surface."""

import jax.numpy as jnp
import numpy as np
import pytest

from mmradar import golden
from mmradar.config import RadarConfig
from mmradar.io.synthetic import SceneTarget, synthesize_capture
from mmradar.models.rd_pipeline import RDPipeline
from mmradar.ops.cluster import cluster_detections, label_hits


def _random_hits(shape, density, seed):
    rng = np.random.default_rng(seed)
    return rng.random(shape) < density


class TestLabelHits:
    @pytest.mark.parametrize("density", [0.02, 0.1, 0.4])
    def test_matches_golden_bfs(self, density):
        hits = _random_hits((3, 32, 48), density, seed=int(density * 100))
        got = np.asarray(label_hits(jnp.asarray(hits)))
        want = golden.cluster_hits(hits)
        np.testing.assert_array_equal(got, want)

    def test_matches_scipy_when_no_wrap(self):
        """Independent oracle: scipy 8-connected labeling agrees once
        both are mapped to canonical (min-flat-index) labels, on a map
        whose Doppler seam rows are empty so wrap cannot matter."""
        scipy_ndimage = pytest.importorskip("scipy.ndimage")
        hits = _random_hits((24, 40), 0.25, seed=7)
        hits[0, :] = False
        hits[-1, :] = False
        got = np.asarray(label_hits(jnp.asarray(hits)))
        lab, n = scipy_ndimage.label(hits, structure=np.ones((3, 3)))
        want = np.full(hits.shape, -1, np.int32)
        flat = np.arange(hits.size).reshape(hits.shape)
        for c in range(1, n + 1):
            m = lab == c
            want[m] = flat[m].min()
        np.testing.assert_array_equal(got, want)

    def test_doppler_wraps_range_does_not(self):
        hits = np.zeros((8, 8), bool)
        hits[7, 3] = hits[0, 3] = True   # adjacent across the Doppler seam
        hits[2, 0] = hits[2, 7] = True   # NOT adjacent across range edges
        got = np.asarray(label_hits(jnp.asarray(hits)))
        assert got[7, 3] == got[0, 3] == 3  # min flat index = 0*8+3
        assert got[2, 0] != got[2, 7]
        np.testing.assert_array_equal(got, golden.cluster_hits(hits))

    def test_snake_component_converges(self):
        """A long winding component exercises many propagation sweeps."""
        hits = np.zeros((16, 64), bool)
        for i in range(0, 16, 2):
            hits[i, :] = True
            if i + 1 < 16:
                hits[i + 1, -1 if (i // 2) % 2 == 0 else 0] = True
        got = np.asarray(label_hits(jnp.asarray(hits)))
        np.testing.assert_array_equal(got, golden.cluster_hits(hits))
        assert len(np.unique(got[hits])) == 1


class TestClusterDetections:
    def _cfg(self):
        return RadarConfig()

    def test_hand_built_blob_stats(self):
        cfg = self._cfg()
        d_sz, r_sz = cfg.doppler_fft_size, cfg.range_fft_size
        power = np.zeros((1, d_sz, r_sz), np.float32)
        hits = np.zeros((1, d_sz, r_sz), bool)
        # one 2x3 blob: rows 10-11, cols 20-22, known weights
        w = np.array([[1.0, 2.0, 3.0], [4.0, 6.0, 4.0]], np.float32)
        power[0, 10:12, 20:23] = w
        hits[0, 10:12, 20:23] = True
        # detections: the two strongest cells of the blob + invalid pad
        d_bin = jnp.asarray([[11, 11, 0, 0]], jnp.int32)
        r_bin = jnp.asarray([[21, 20, 0, 0]], jnp.int32)
        valid = jnp.asarray([[True, True, False, False]])
        out = cluster_detections(
            jnp.asarray(power), jnp.asarray(hits), d_bin, r_bin, valid, cfg
        )
        np.testing.assert_array_equal(
            np.asarray(out.cluster_id), [[0, 0, -1, -1]]
        )
        assert int(out.num_clusters[0]) == 1
        np.testing.assert_array_equal(np.asarray(out.cells)[0, :2], [6, 6])
        np.testing.assert_allclose(
            np.asarray(out.total_power)[0, :2], w.sum(), rtol=1e-6
        )
        np.testing.assert_array_equal(
            np.asarray(out.extent_doppler_bins)[0, :2], [2, 2]
        )
        np.testing.assert_array_equal(
            np.asarray(out.extent_range_bins)[0, :2], [3, 3]
        )
        # centroid in bin space vs the physics mapping of the hand value
        dw = (w * np.array([[10], [11]])).sum() / w.sum()
        rw = (w * np.array([20, 21, 22])).sum() / w.sum()
        from mmradar.models.rd_pipeline import cell_physics

        want_r, want_v = cell_physics(
            jnp.float32(dw), jnp.float32(rw), cfg
        )
        np.testing.assert_allclose(
            np.asarray(out.centroid_range_m)[0, 0], float(want_r),
            rtol=1e-5,
        )
        np.testing.assert_allclose(
            np.asarray(out.centroid_velocity_mps)[0, 0], float(want_v),
            rtol=1e-5,
        )
        # invalid slots are zeroed
        np.testing.assert_array_equal(np.asarray(out.cells)[0, 2:], 0)

    def test_wrap_straddling_blob_centroid(self):
        """A blob across the Doppler seam is ONE cluster whose centroid
        stays at the seam (|v| ~ v_max), not averaged toward zero."""
        cfg = self._cfg()
        d_sz, r_sz = cfg.doppler_fft_size, cfg.range_fft_size
        power = np.zeros((1, d_sz, r_sz), np.float32)
        hits = np.zeros((1, d_sz, r_sz), bool)
        power[0, d_sz - 1, 30] = 5.0
        power[0, 0, 30] = 5.0
        hits[0, d_sz - 1, 30] = hits[0, 0, 30] = True
        d_bin = jnp.asarray([[d_sz - 1, 0]], jnp.int32)
        r_bin = jnp.asarray([[30, 30]], jnp.int32)
        valid = jnp.asarray([[True, True]])
        out = cluster_detections(
            jnp.asarray(power), jnp.asarray(hits), d_bin, r_bin, valid, cfg
        )
        assert int(out.num_clusters[0]) == 1
        np.testing.assert_array_equal(np.asarray(out.cells)[0], [2, 2])
        np.testing.assert_array_equal(
            np.asarray(out.extent_doppler_bins)[0], [2, 2]
        )
        # centroid Doppler bin is d_sz-0.5 (equivalently -0.5): the
        # velocity magnitude is ~v_max, far from the naive mean's ~0
        v = float(np.asarray(out.centroid_velocity_mps)[0, 0])
        v_max = cfg.wavelength_m / (4.0 * cfg.slow_time_interval_s)
        assert abs(abs(v) - v_max) < 0.05 * v_max

    def test_separate_blobs_separate_clusters(self):
        cfg = self._cfg()
        d_sz, r_sz = cfg.doppler_fft_size, cfg.range_fft_size
        power = np.zeros((2, d_sz, r_sz), np.float32)
        hits = np.zeros((2, d_sz, r_sz), bool)
        for b in range(2):
            power[b, 5, 10] = 9.0
            power[b, 40, 70] = 4.0
            hits[b, 5, 10] = hits[b, 40, 70] = True
        d_bin = jnp.asarray([[5, 40], [5, 40]], jnp.int32)
        r_bin = jnp.asarray([[10, 70], [10, 70]], jnp.int32)
        valid = jnp.ones((2, 2), bool)
        out = cluster_detections(
            jnp.asarray(power), jnp.asarray(hits), d_bin, r_bin,
            jnp.asarray(valid), cfg,
        )
        np.testing.assert_array_equal(
            np.asarray(out.cluster_id), [[0, 1], [0, 1]]
        )
        np.testing.assert_array_equal(np.asarray(out.num_clusters), [2, 2])


class TestDetectObjects:
    def test_pipeline_two_targets(self):
        cfg = RadarConfig()
        targets = [
            SceneTarget(range_m=3.0, velocity_mps=2.0, azimuth_deg=20.0,
                        amplitude=3000.0),
            SceneTarget(range_m=9.0, velocity_mps=-4.0, azimuth_deg=-30.0,
                        amplitude=2000.0),
        ]
        cap = synthesize_capture(targets, 3, cfg, noise_std=2.0, seed=3)
        pipe = RDPipeline(cfg, max_detections=16)
        base = pipe.prepare_base(jnp.asarray(cap[0]))
        out, cl = pipe.detect_objects(jnp.asarray(cap[1:]), base)
        det = np.asarray(out.valid)
        assert det.any()
        n_cl = np.asarray(cl.num_clusters)
        # clustering can only merge detections, never split them
        assert (n_cl <= np.asarray(out.num_hits).clip(max=16)).all()
        assert (n_cl >= 1).all()
        # representative centroids sit near the true target ranges
        for b in range(det.shape[0]):
            reps = [
                k for k in range(det.shape[1])
                if det[b, k] and int(cl.cluster_id[b, k]) == k
            ]
            cents = sorted(
                float(cl.centroid_range_m[b, k]) for k in reps
            )
            assert any(abs(c - 3.0) < 0.6 for c in cents)
            assert any(abs(c - 9.0) < 0.6 for c in cents)
        # every valid detection points at a valid representative
        cid = np.asarray(cl.cluster_id)
        for b in range(det.shape[0]):
            for k in range(det.shape[1]):
                if det[b, k]:
                    assert det[b, cid[b, k]]
                    assert cid[b, cid[b, k]] == cid[b, k]

    def test_detect_objects_detections_match_detect(self):
        """detect_objects' RDResult must equal detect()'s on the same
        maps impl (clustering is a pure addition, not a fork)."""
        cfg = RadarConfig()
        cap = synthesize_capture(
            [SceneTarget(range_m=5.0, velocity_mps=1.0, amplitude=2500.0)],
            3, cfg, noise_std=2.0, seed=5,
        )
        pipe = RDPipeline(cfg, max_detections=8, rd_impl="fft")
        base = pipe.prepare_base(jnp.asarray(cap[0]))
        want = pipe.detect(jnp.asarray(cap[1:]), base)
        got, _ = pipe.detect_objects(jnp.asarray(cap[1:]), base)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
