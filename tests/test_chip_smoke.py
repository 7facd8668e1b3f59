"""chip_smoke.py and bench.py: the phase functions at tiny size on the CPU
device, their refusal to run without a GPU, and the GPU-only run (marked
``gpu``, skipped elsewhere)."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import safeincave_tpu as sc
from safeincave_tpu.mesh.reorder import reordered_grid

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench  # noqa: E402
import chip_smoke  # noqa: E402


def _box(nx=3, nz=3):
    return sc.GridBox(Lx=600.0, Ly=600.0, Lz=800.0, nx=nx, ny=nx, nz=nz)


def _ok(out):
    return all(r["ok"] for r in out)


def test_kernels_phase_tiny(capsys):
    band, _, _ = reordered_grid(_box(nz=4), method="band")
    out = chip_smoke.phase_kernels(meshes=[("band-box", band)],
                                   box=_box(nx=4), timing=False)
    assert out["band-box"]["dofs"] == 3 * band.n_nodes
    assert out["box"]["dia_offsets"] <= 27
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"phase": "kernels"' in line and '"ok": false' not in line


def test_mechanics_phase_tiny():
    out = chip_smoke.phase_mechanics(grid=_box(), n_steps=2)
    assert len(out["fp_iters_per_step"]) == 2
    assert out["smoke_ms_per_step"] > 0


def test_tm_phase_tiny():
    out = chip_smoke.phase_tm(grid=_box(), n_steps=2)
    assert len(out["heat_cg_iters_per_step"]) == 2


def test_four_phase_tiny_on_virtual_devices():
    out = chip_smoke.phase_four(grid=_box(), n_devices=4, n_steps=1)
    assert out["devices"] == 4
    assert 0 < out["halo_rows_per_device_per_matvec"] < out["nodes"]


def test_four_phase_refuses_too_few_devices():
    with pytest.raises(chip_smoke.PhaseFailed, match="needs 64 devices"):
        chip_smoke.phase_four(grid=_box(), n_devices=64)


def test_failed_check_fails_the_phase():
    checks = chip_smoke.Checks()
    checks.add("fine", 1e-13, 1e-12)
    checks.raise_if_failed("p")
    checks.add("too big", 2e-12, 1e-12)
    checks.add("nan", float("nan"), 1.0)
    with pytest.raises(chip_smoke.PhaseFailed, match="too big.*nan"):
        checks.raise_if_failed("p")


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_cpu(where, tmp_path):
    cwd = ROOT
    if where == "alone":
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    r = _run(["chip_smoke.py"], cwd)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"ok"' not in r.stdout


def test_bench_refuses_cpu():
    r = _run(["bench.py"], ROOT)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert r.stdout == ""


@pytest.mark.parametrize("kind", ["NVIDIA H100 80GB HBM3",
                                  "NVIDIA H100 PCIe"])
def test_peaks_table_has_h100(kind):
    peaks = bench.device_peaks(kind)
    assert peaks["hbm_gbps"] >= 2000.0
    assert peaks["f32_tflops"] > peaks["f64_tflops"] > 0


def test_peaks_table_rejects_unknown_device():
    with pytest.raises(KeyError, match="no published peaks"):
        bench.device_peaks("cpu")


def test_matvec_bytes_counts_elements_and_nodes():
    assert bench.matvec_bytes(10, 4, 4) == 73 * 4 * 10 + 24 * 4


@pytest.mark.gpu
def test_gpu_kernels_at_fixture_size():
    """The kernels phase at the real fixture sizes, on the card."""
    out = chip_smoke.phase_kernels()
    assert out["cavern_proxy_600"]["nodes"] == 3360
    assert out["cumsum_f32_timing"]["device_us"] > 0


@pytest.mark.gpu
def test_gpu_mechanics_against_cpu_reference():
    out = chip_smoke.phase_mechanics()
    assert out["settings"]["fp32_phase"]
    assert np.all(np.asarray(out["fp_iters_per_step"]) > 0)
