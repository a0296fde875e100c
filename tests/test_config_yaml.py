"""The OpenCV-YAML reader against PyYAML on every reference config file."""

import glob
import os
import re

import numpy as np
import pytest

from visual_odometry_ros_tpu.config import load_yaml, parse_opencv_yaml

ROOT = os.path.join(os.path.dirname(__file__), "..")
CONFIGS = sorted(
    os.path.relpath(p, ROOT) for p in glob.glob(os.path.join(ROOT, "config", "**", "*.yaml"), recursive=True)
)


def test_config_inventory():
    assert len(CONFIGS) == 24


@pytest.mark.parametrize("rel", CONFIGS)
def test_reader_matches_pyyaml(rel):
    yaml = pytest.importorskip("yaml")
    with open(os.path.join(ROOT, rel)) as f:
        text = f.read()
    # PyYAML needs the OpenCV directive and matrix tag stripped.
    ref = yaml.safe_load(re.sub(r"^%YAML:[\d.]+\s*", "", text).replace("!!opencv-matrix", ""))
    got = parse_opencv_yaml(text)
    assert got == ref
    assert {k: type(v) for k, v in got.items()} == {k: type(v) for k, v in ref.items()}


def test_multiline_matrix_and_errors():
    text = "%YAML:1.0\n# c\nT_lr: !!opencv-matrix\n  rows: 2\n  cols: 2\n  dt: f\n  data: [1, 0.5,\n         -2e-3, 4]\nx.y: 3 # trailing\n"
    got = parse_opencv_yaml(text)
    assert got == {"T_lr": {"rows": 2, "cols": 2, "dt": "f", "data": [1, 0.5, -2e-3, 4]}, "x.y": 3}
    with pytest.raises(ValueError, match="unterminated"):
        parse_opencv_yaml("T: !!opencv-matrix\n  data: [1, 2,\n")
    with pytest.raises(ValueError, match="outside"):
        parse_opencv_yaml("  rows: 4\n")


def test_load_stereo_kitti_config():
    cfg = load_yaml(os.path.join(ROOT, "config", "stereo", "kitti_00_stereo.yaml"))
    assert (cfg.cam.width, cfg.cam.height) == (1241, 376)
    assert cfg.extractor.n_features == 1024
    assert cfg.tracker.max_level == 4 and cfg.tracker.window_size == 21
    assert cfg.keyframe.n_max_keyframes_in_window == 9
    np.testing.assert_allclose(cfg.T_lr[0, 3], 0.5371657)
