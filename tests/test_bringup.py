"""GPU bring-up plumbing that the CPU can check: removed implementation
names raise, the compile-cache placement, and chip_smoke.py's refusal to
run without a GPU and its last line."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from mmradar.config import RadarConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rd_pipeline(**kw):
    from mmradar.models.rd_pipeline import RDPipeline

    return RDPipeline(RadarConfig(), **kw)


def _range_detector(**kw):
    from mmradar.models.range_detector import RangeDetector

    return RangeDetector(RadarConfig(), **kw)


def _distributed(**kw):
    from mmradar.parallel.distributed import DistributedRDPipeline
    from mmradar.parallel.mesh import build_mesh

    return DistributedRDPipeline(mesh=build_mesh(n_devices=2, num_rx=4),
                                 cfg=RadarConfig(), **kw)


REMOVED = (
    [(_rd_pipeline, "rd_impl", v) for v in (
        "mega", "mega-interpret", "mega-maps", "mega-maps-interpret",
        "fused-pallas")]
    + [(_rd_pipeline, "cfar_impl", v) for v in ("pallas", "pallas-interpret")]
    + [(_rd_pipeline, "topk_impl", v) for v in ("pallas", "pallas-interpret")]
    + [(_range_detector, "detect_impl", v)
       for v in ("pallas", "pallas-interpret")]
    + [(_distributed, "rd_impl", "mega")]
)


@pytest.mark.parametrize(
    "make,field,value", REMOVED,
    ids=[f"{m.__name__[1:]}-{f}-{v}" for m, f, v in REMOVED])
def test_removed_implementation_raises(make, field, value):
    """An explicit pin of a removed implementation raises ValueError
    naming it, at construction — never a silent fallback."""
    with pytest.raises(ValueError, match=f"{field}='{value}'"):
        make(**{field: value})


def test_compile_cache_honours_env_var(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: that directory, and no config is
    touched (JAX reads the variable itself)."""
    import jax

    from mmradar.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_checkout_path(monkeypatch):
    """Unset: one fixed path inside the checkout, git-ignored, the same
    in every process (the path is part of the cache key)."""
    import jax

    from mmradar.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(REPO, ".jax_cache")
    assert compile_cache.compile_cache_dir({}) == want
    before = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_refuses_cpu_backend():
    """On a CPU backend chip_smoke.py fails at once: non-zero exit, no
    ok line."""
    p = _run_smoke(REPO)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "no GPU" in p.stderr


def test_chip_smoke_fails_without_the_repo(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo
    it cannot import the package: non-zero exit, no ok line."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    p = _run_smoke(tmp_path)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_chip_smoke_ok_line_format():
    """The last line is exactly the contract's JSON object."""
    sys.path.insert(0, REPO)
    import chip_smoke

    class Dev:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    line = chip_smoke.ok_line([Dev()])
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(line)["device"]["count"] == 1
    assert json.loads(chip_smoke.ok_line([Dev()] * 4))["device"]["count"] == 4


def test_replay_never_initializes_a_backend(tmp_path):
    """`cli replay` (the sensor side of `serve`) stays off JAX's
    backends, so serve + replay keep to one JAX process per card."""
    from mmradar.io.capture import write_capture
    from mmradar.io.synthetic import synthesize_capture

    cap = tmp_path / "cap.bin"
    write_capture(str(cap), synthesize_capture([], 2, RadarConfig(),
                                               seed=0))
    code = (
        "import sys; from mmradar import cli; "
        f"rc = cli.main(['replay', {str(cap)!r}, '--port', '9', "
        "'--fps', '0']); "
        "from jax._src import xla_bridge; "
        "sys.exit(rc or int(xla_bridge.backends_are_initialized()) * 7)"
    )
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"),
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
