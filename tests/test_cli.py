"""CLI round-trip tests: generate -> detect -> verify -> bench."""

import json

import numpy as np

import pytest

from mmradar import cli


@pytest.fixture(scope="module")
def cap_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "cap.bin"
    rc = cli.main(
        ["generate", str(path), "--frames", "6", "--target", "4.0,1.5,10",
         "--seed", "3"]
    )
    assert rc == 0
    return path


def test_generate_creates_valid_capture(cap_path, cfg):
    from mmradar.io.capture import frames_in_file

    assert frames_in_file(cap_path, cfg) == 6


def test_detect_writes_jsonl(cap_path, tmp_path):
    out = tmp_path / "dets.jsonl"
    rc = cli.main(["detect", str(cap_path), "--out", str(out), "--full"])
    assert rc == 0
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert len(lines) == 5
    assert lines[0]["frame"] == 1
    assert "distance_m" in lines[0]
    assert isinstance(lines[0]["detections"], list)
    # the 4 m target should appear among the CFAR detections
    assert any(
        abs(d["range_m"] - 4.0) < 1.0
        for rec in lines for d in rec["detections"]
    )


def test_verify_passes(cap_path, capsys):
    rc = cli.main(["verify", str(cap_path)])
    assert rc == 0
    assert "5 ok, 0 failed" in capsys.readouterr().out


def test_bench_device_mode(cap_path, capsys):
    rc = cli.main(["bench", str(cap_path), "--batch", "4"])
    assert rc == 0
    assert "FPS" in capsys.readouterr().out


def test_bench_native_mode(cap_path, capsys):
    rc = cli.main(["bench", str(cap_path), "--native"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "native golden model" in out
    assert "Total FFT time" in out


def test_bench_stages_mode(cap_path, capsys):
    rc = cli.main(["bench", str(cap_path), "--batch", "4", "--stages"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Total FFT time" in out
    assert "Reshape + Extension" in out
    assert "findMax" in out


def test_bench_profile_export(cap_path, tmp_path, capsys):
    prof = tmp_path / "trace"
    rc = cli.main(["bench", str(cap_path), "--batch", "4",
                   "--profile", str(prof)])
    assert rc == 0
    assert prof.exists() and any(prof.rglob("*"))


def test_detect_resume(cap_path, tmp_path):
    out = tmp_path / "resume.jsonl"
    # first pass: write everything, then truncate to 2 records
    rc = cli.main(["detect", str(cap_path), "--out", str(out)])
    assert rc == 0
    lines = out.read_text().splitlines()
    full = list(lines)
    out.write_text("\n".join(lines[:2]) + "\n")
    # resume appends frames 3..5 only
    rc = cli.main(["detect", str(cap_path), "--out", str(out), "--resume"])
    assert rc == 0
    resumed = out.read_text().splitlines()
    assert len(resumed) == len(full)
    assert [json.loads(x)["frame"] for x in resumed] == [1, 2, 3, 4, 5]
    # resuming again is a no-op
    rc = cli.main(["detect", str(cap_path), "--out", str(out), "--resume"])
    assert rc == 0
    assert out.read_text().splitlines() == resumed


def test_track_command(cap_path, capsys):
    rc = cli.main(["track", str(cap_path)])
    assert rc == 0
    out = capsys.readouterr().out
    recs = [json.loads(x) for x in out.splitlines() if x and not x.startswith("#")]
    assert recs
    assert any(abs(r["range_m"] - 4.0) < 1.0 for r in recs)


def test_detect_cluster_fields(cap_path, tmp_path):
    out = tmp_path / "dets.jsonl"
    rc = cli.main(["detect", str(cap_path), "--out", str(out), "--full",
                   "--cluster"])
    assert rc == 0
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    dets = [d for rec in lines for d in rec["detections"]]
    assert dets
    for d in dets:
        assert d["cluster_id"] >= 0
        assert d["cluster_cells"] >= 1
        assert len(d["cluster_extent_bins"]) == 2
    # the 4 m target's cluster centroid sits near the truth
    assert any(abs(d["cluster_range_m"] - 4.0) < 1.0 for d in dets)


def test_detect_cluster_requires_full(cap_path, capsys):
    rc = cli.main(["detect", str(cap_path), "--cluster"])
    assert rc == 2
    assert "--cluster requires --full" in capsys.readouterr().err


def test_track_cluster_dedupes(cap_path, capsys):
    """--cluster: still exactly one confirmed track on the single-target
    capture (duplicate same-blob measurements are suppressed upstream)."""
    rc = cli.main(["track", str(cap_path), "--cluster"])
    assert rc == 0
    out = capsys.readouterr().out
    recs = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    assert len(recs) == 1
    assert abs(recs[0]["range_m"] - 4.0) < 1.0


def test_bench_compare_one_shot(cap_path, capsys):
    """--compare = the reference main() with the verification loop ENABLED
    (cudaBenchMarking.cpp:397-449; loop disabled at :410-419): one
    invocation, both timing tables, per-frame gate, exit code."""
    rc = cli.main(["bench", str(cap_path), "--compare", "--per-frame"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "CPU Timing (native golden model)" in out
    assert "Device Timing" in out
    assert "verification: 5/5 frames within 1e-3 relative" in out
    assert "frame[1] native" in out  # the per-frame line


def test_track_refine_capon(cap_path, capsys):
    """--refine capon: track azimuth comes from the MVDR estimate and
    stays on target; the EKF consumes it with tightened sigma."""
    rc = cli.main(["track", str(cap_path), "--refine", "capon",
                   "--tracker", "ekf"])
    assert rc == 0
    out = capsys.readouterr().out
    recs = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    assert len(recs) == 1
    assert abs(recs[0]["azimuth_deg"] - 10.0) <= 2.0


def test_serve_refine_flag_parses():
    """--refine is accepted by serve (socket-free smoke: bad arg rejected)."""
    with pytest.raises(SystemExit):
        cli.main(["serve", "--port", "1", "--refine", "bogus"])


def test_refine_improves_offgrid_azimuth(cfg):
    """On an off-grid target the Capon azimuth beats the raw angle-FFT
    GRID estimate (angle_bin) and stays within 2 degrees of truth (the
    round-1 ROADMAP 'track-level fusion of refined angles' item, now
    CLI-reachable via --refine).  The pipeline's default azimuth_deg
    already sharpens the grid with sub-bin interpolation — on a clean
    single target that is the better point estimate; Capon's value is
    resolution under interference, so the CLI treats it as an opt-in."""
    import numpy as np
    import jax.numpy as jnp

    from mmradar.io.synthetic import SceneTarget, synthesize_capture
    from mmradar.models.rd_pipeline import RDPipeline

    true_az = 17.3
    shorts = synthesize_capture(
        [SceneTarget(range_m=6.0, velocity_mps=1.0, azimuth_deg=true_az,
                     amplitude=2500.0)],
        5, cfg, noise_std=2.0, seed=77,
    )
    pipe = RDPipeline(cfg, max_detections=4)
    base = pipe.prepare_base(jnp.asarray(shorts[0]))
    out = pipe.detect(jnp.asarray(shorts[1:]), base)
    capon = np.asarray(pipe.capon_refine(
        jnp.asarray(shorts[1:]), base, out.doppler_bin, out.range_bin
    ))
    n = cfg.num_angle_bins
    grid_az = np.rad2deg(np.arcsin(np.clip(
        (np.asarray(out.angle_bin, np.float32) - n // 2)
        / (n * cfg.rx_spacing_wavelengths), -1.0, 1.0,
    )))
    valid = np.asarray(out.valid)
    power = np.asarray(out.power)
    err_grid, err_capon = [], []
    for f in range(valid.shape[0]):
        best = int(np.argmax(np.where(valid[f], power[f], -np.inf)))
        err_grid.append(abs(grid_az[f, best] - true_az))
        err_capon.append(abs(capon[f, best] - true_az))
    assert np.mean(err_capon) <= np.mean(err_grid) + 1e-6
    assert np.mean(err_capon) <= 2.0


def test_bench_full_stages(cap_path, capsys):
    """--full --stages: the pinned front-end's maps vs the detection tail
    decomposition, named by the front-end that ran."""
    rc = cli.main(["bench", str(cap_path), "--batch", "4", "--full",
                   "--stages", "--rd-impl", "fused"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Front-end maps rd_impl='fused'" in out
    assert "Detection tail" in out


def test_bench_full_stages_resolution_note(cap_path, capsys):
    """auto resolves to fft: the stages report names the front-end that
    detect() actually runs."""
    rc = cli.main(["bench", str(cap_path), "--batch", "4", "--full",
                   "--stages"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Front-end maps rd_impl='fft'" in out


def test_cli_info(capsys):
    import json as _json

    rc = cli.main(["info"])
    assert rc in (0, None)
    doc = _json.loads(capsys.readouterr().out)
    assert abs(doc["range"]["resolution_m"] - 0.3915) < 1e-3
    assert abs(doc["velocity"]["unambiguous_span_mps"][1] - 15.22) < 0.05
    assert doc["array"]["virtual_elements"] == 4
    assert doc["data"]["bytes_per_frame"] == 204800
    # TDM halves the span note appears at num_tx 2
    rc = cli.main(["info", "--num-tx", "2"])
    doc2 = _json.loads(capsys.readouterr().out)
    assert doc2["velocity"]["tdm_note"]
    assert abs(doc2["velocity"]["unambiguous_span_mps"][1] - 15.22 / 2) < 0.05


def test_cli_rti(cap_path, tmp_path, capsys):
    import json as _json

    out = tmp_path / "rti.npy"
    png = tmp_path / "rti.png"
    rc = cli.main(["rti", str(cap_path), "--out", str(out),
                   "--plot", str(png)])
    assert rc in (0, None)
    rec = _json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["event"] == "rti"
    m = np.load(out)
    assert m.shape == (rec["frames"], rec["range_bins"])
    assert png.exists()
    # the cap_path scene's target sits at 4 m
    assert abs(rec["peak_range_m"] - 4.0) < 1.0


def test_cli_track_out_and_plot(cap_path, tmp_path, capsys):
    import json as _json

    out = tmp_path / "tracks.jsonl"
    png = tmp_path / "tracks.png"
    rc = cli.main(["track", str(cap_path), "--out", str(out),
                   "--plot", str(png)])
    assert rc in (0, None)
    capsys.readouterr()
    recs = [_json.loads(l) for l in out.read_text().splitlines()]
    assert len(recs) == 1  # the cap_path scene's single target
    for r in recs:
        assert len(r["history"]) == r["hits"]
        assert all(len(h) == 3 for h in r["history"])
    assert png.exists()


def test_serve_integrate_flag_guards():
    """serve --integrate rejects per-frame re-estimation combos and the
    clutter-map detector (socket-free: the guards run before any bind)."""
    from mmradar import cli as _cli

    for combo in (["--refine", "capon"], ["--cmap"],
                  ["--disambiguate", "--num-tx", "2"]):
        rc = _cli.main(["serve", "--port", "1", "--integrate", "4",
                        *combo])
        assert rc == 2
