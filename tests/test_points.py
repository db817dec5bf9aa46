"""Point-cloud export (utils/points.py, detect --points)."""

import numpy as np
import pytest

from mmradar.utils.points import (
    detections_to_xyz,
    write_point_cloud,
)


def test_xyz_math():
    x, y, z = detections_to_xyz(10.0, 0.0)
    assert abs(x) < 1e-12 and abs(y - 10.0) < 1e-12 and z == 0.0
    x, y, z = detections_to_xyz(10.0, 90.0)
    assert abs(x - 10.0) < 1e-9 and abs(y) < 1e-9
    x, y, z = detections_to_xyz(10.0, 0.0, 30.0)
    assert abs(z - 5.0) < 1e-9 and abs(y - 10.0 * np.cos(np.pi / 6)) < 1e-9


def test_csv_and_ply(tmp_path):
    rows = [(1, 1.0, 2.0, 0.0, -3.0, 4e8), (2, -1.5, 9.0, 0.1, 0.5, 1e7)]
    csv = tmp_path / "pts.csv"
    assert write_point_cloud(str(csv), rows) == 2
    lines = csv.read_text().splitlines()
    assert lines[0].startswith("frame,x_m,y_m,z_m")
    assert len(lines) == 3
    ply = tmp_path / "pts.ply"
    assert write_point_cloud(str(ply), rows) == 2
    text = ply.read_text().splitlines()
    assert text[0] == "ply"
    assert "element vertex 2" in text[2]
    assert text[-1].endswith(" 2")  # frame attribute of the last vertex


def test_cli_detect_points(tmp_path, cfg, capture):
    from mmradar import cli
    from mmradar.io.capture import write_capture

    cap = tmp_path / "cap.bin"
    write_capture(str(cap), capture[:4])
    pts = tmp_path / "cloud.csv"
    rc = cli.main(["detect", str(cap), "--full", "--out",
                   str(tmp_path / "d.jsonl"), "--points", str(pts)])
    assert rc == 0
    lines = pts.read_text().splitlines()[1:]
    assert lines
    vals = [tuple(float(v) for v in l.split(",")) for l in lines]
    # conftest targets: 3 m @ 20 deg and 8 m @ -35 deg
    want_x, want_y, _ = detections_to_xyz(3.0, 20.0)
    assert any(abs(v[1] - want_x) < 0.6 and abs(v[2] - want_y) < 0.6
               for v in vals)

    # --points without --full refuses like --cluster does
    rc = cli.main(["detect", str(cap), "--points", str(pts)])
    assert rc == 2


def test_cli_detect_elevation_points(tmp_path, capsys):
    """generate --elevated-tx + detect --refine 2d: elevation lands in
    the records and in the point cloud's z (the full 3D product)."""
    import json

    from mmradar import cli

    cap = tmp_path / "elev.bin"
    rc = cli.main([
        "generate", str(cap), "--frames", "3", "--num-tx", "2",
        "--elevated-tx", "--noise", "2.0",
        "--target", "6.0,1.0,0,3000,10",
    ])
    assert rc == 0
    out = tmp_path / "d.jsonl"
    pts = tmp_path / "cloud.csv"
    rc = cli.main([
        "detect", str(cap), "--full", "--num-tx", "2", "--elevated-tx",
        "--refine", "2d", "--out", str(out), "--points", str(pts),
    ])
    assert rc == 0
    recs = [json.loads(l) for l in out.read_text().splitlines()]
    dets = [d for r in recs for d in r.get("detections", [])
            if abs(d["range_m"] - 6.0) < 1.0]
    assert dets
    # 0.5-wavelength elevation baseline: coarse, gate generously
    assert any(abs(d["elevation_deg"] - 10.0) < 8.0 for d in dets)
    vals = [l.split(",") for l in pts.read_text().splitlines()[1:]]
    zs = [float(v[3]) for v in vals
          if abs(float(v[2]) - 6.0) < 1.5]  # boresight y ~ range here
    assert zs and any(z > 0.2 for z in zs)  # r sin(10 deg) ~ 1.04 m

    # --refine without --full fails fast
    rc = cli.main(["detect", str(cap), "--refine", "capon"])
    assert rc == 2

    # --elevated-tx without a second TX is a config error
    with pytest.raises(ValueError, match="num-tx"):
        cli.main(["detect", str(cap), "--full", "--elevated-tx"])


def test_plot_point_cloud(tmp_path):
    from mmradar.config import RadarConfig
    from mmradar.viz import plot_point_cloud

    rows = [(1, 1.0, 3.0, 0.0, -2.0, 1e8), (1, -2.0, 8.0, 0.0, 4.0, 2e8)]
    out = tmp_path / "cloud.png"
    plot_point_cloud(rows, RadarConfig(), path=str(out))
    assert out.stat().st_size > 2000
    # empty rows still render an (empty) scene
    plot_point_cloud([], RadarConfig(), path=str(tmp_path / "empty.png"))
