"""chip_smoke.py on the CPU: it refuses to report a result without a GPU,
and its phase functions run and check correctly at tiny sizes."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _run_alone(tmp_path, with_repo: bool):
    """Run chip_smoke.py on this CPU-only machine, either from the
    repository or from a directory that holds nothing else."""
    script = os.path.join(REPO, "chip_smoke.py")
    if not with_repo:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = str(tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], capture_output=True,
                          text=True, timeout=300, cwd=tmp_path, env=env)


@pytest.mark.parametrize("with_repo", [True, False])
def test_smoke_fails_without_gpu(tmp_path, with_repo):
    proc = _run_alone(tmp_path, with_repo)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_require_gpu_refuses_cpu_devices():
    with pytest.raises(RuntimeError, match="GPU"):
        chip_smoke.require_gpu(1)


def test_result_line_names_the_device():
    class Dev:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    line = json.loads(chip_smoke.result_line([Dev()], 1))
    assert line == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


def test_served_path_tiny(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = chip_smoke.served_path((8, 4, 4))
    assert out["elasticity_dof"] == 3 * 9 * 5 * 5
    assert len(out["seconds"]) == 5


@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_flagship_and_precision_tiny(tmp_path, monkeypatch, precision):
    from pde_solver.config import config_overrides

    monkeypatch.chdir(tmp_path)
    with config_overrides(precision=precision, mg_threshold=1000,
                          host_direct_threshold=0):
        sysm = chip_smoke.flagship((16, 8, 8))
    assert chip_smoke.stencil_precision(sysm) <= 1e-6


@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_parity_tiny(tmp_path, monkeypatch, precision):
    from pde_solver.config import config_overrides

    monkeypatch.chdir(tmp_path)
    with config_overrides(precision=precision, mg_threshold=1000,
                          host_direct_threshold=0):
        assert chip_smoke.parity((16, 8, 8)) <= chip_smoke.PARITY_TOL


@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_heat_parity_tiny(tmp_path, monkeypatch, precision):
    from pde_solver.config import config_overrides

    monkeypatch.chdir(tmp_path)
    with config_overrides(precision=precision, host_direct_threshold=0):
        assert chip_smoke.heat_parity(6, 4) <= chip_smoke.PARITY_TOL


def test_df32_precision_cpu():
    chip_smoke.df32_precision(n=20_000, cells=(8, 4, 4))


@pytest.mark.gpu
def test_precision_phases_on_gpu(gpu):
    """Phase 6 at a small size on the card: XLA's f32 apply and the pair
    arithmetic as the GPU compiler builds them."""
    from benchmarks.spmv_bench import flagship_system

    chip_smoke.df32_precision(n=100_000, cells=(32, 16, 16))
    assert chip_smoke.stencil_precision(flagship_system((32, 16, 16))) <= 1e-6


def test_reference_cantilever_layout():
    """The surrogate's x-fastest node order maps onto the [x, y, z] grid:
    the clamped x=0 face is zero and the tip deflects downward."""
    u = chip_smoke.reference_cantilever((4, 2, 2))
    assert u.shape == (5, 3, 3, 3)
    assert np.all(u[0] == 0.0)
    assert np.all(u[-1, :, :, 2] < 0.0)


def test_sharded_phases_tiny(tmp_path, monkeypatch):
    """The --four-cards phases on virtual CPU devices: sharded MG-PCG (in
    float64) and the sharded transient against one device."""
    from pde_solver.config import config_overrides

    monkeypatch.chdir(tmp_path)
    with config_overrides(precision="mixed", mg_threshold=1000,
                          host_direct_threshold=0):
        assert chip_smoke.sharded_flagship((16, 8, 8)) <= 1e-6
        assert chip_smoke.sharded_transient(8, 3) <= 1e-6
