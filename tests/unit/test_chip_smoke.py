"""chip_smoke.py off the GPU: it must fail without printing its result
line, parse --devices, and format the result line as the contract says."""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _run(script: str, cwd: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, script], capture_output=True, text=True, timeout=300,
        cwd=cwd, env=env,
    )


def test_fails_without_gpu_and_prints_no_result():
    out = _run(os.path.join(REPO, "chip_smoke.py"), REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "not 'gpu'" in out.stdout


def test_fails_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("argv,devices", [([], 1), (["--devices", "1"], 1),
                                          (["--devices", "4"], 4)])
def test_devices_option(argv, devices):
    assert chip_smoke.parse_args(argv).devices == devices


@pytest.mark.parametrize("bad", ["2", "8", "x"])
def test_devices_option_rejects_other_counts(bad):
    with pytest.raises(SystemExit):
        chip_smoke.parse_args(["--devices", bad])


@pytest.mark.parametrize("count", [1, 4])
def test_result_line_shape(count):
    line = chip_smoke.result_line("gpu", "NVIDIA H100 80GB HBM3", count)
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count},
    }


def test_check_raises_smoke_failure():
    chip_smoke.check(True, "fine")
    with pytest.raises(chip_smoke.SmokeFailure, match="boom"):
        chip_smoke.check(False, "boom")
