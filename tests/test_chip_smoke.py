"""CPU-checkable parts of chip_smoke.py and the device helpers it uses."""

import json
import os
import sys

import jax
import numpy as np
import pytest

import visual_odometry_ros_tpu  # noqa: F401  (installs the precision pin)
from visual_odometry_ros_tpu import device as D

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402


def test_device_guard_raises_on_cpu():
    assert jax.default_backend() == "cpu"
    with pytest.raises(D.NoGPUError, match="no GPU found"):
        D.require_gpu()


def test_last_line_is_the_contract_json():
    line = chip_smoke.last_line({"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1, "x": 2})
    assert line == '{"ok": true, "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}'
    assert json.loads(line)["device"]["count"] == 1
    assert "\n" not in line


def test_cache_dir_honours_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(D.ENV_VAR, str(tmp_path))
    assert D.compile_cache_dir() == str(tmp_path)
    assert D.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_dir_defaults_to_fixed_repo_path(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv(D.ENV_VAR, raising=False)
    path = D.compile_cache_dir()
    assert path == os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(D.__file__))), ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == before


def test_precision_pin_in_effect():
    assert jax.config.jax_default_matmul_precision == "float32"


def test_device_info_names_the_backend():
    info = D.device_info()
    assert info == {"platform": "cpu", "kind": jax.devices()[0].device_kind, "count": len(jax.devices())}


@pytest.mark.gpu
def test_precision_phase_on_gpu(gpu_device):
    """The f32 matmul on the card matches float64 to 1e-5 (no TF32)."""
    with jax.default_device(gpu_device):
        chip_smoke.precision_phase()
