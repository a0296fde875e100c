"""Typed configuration tree + YAML loading.

One config system covering the reference's two-tier parameter surface
(SURVEY.md §5 'Config / flag system'):
  - camera intrinsics/distortion (+T_lr for stereo) and all algorithm
    thresholds, using the same YAML key names as the reference's
    cv::FileStorage files (config/stereo/kitti_00_stereo.yaml:1-83,
    config/mono/kitti_00.yaml:1-67; loaders mono_vo.cpp:137-225,
    stereo_vo.cpp:122-273)
  - defaults mirroring the reference AlgorithmParameters structs
    (mono_vo.h:74-115, stereo_vo.h:61-103)

Static capacities (feature slots, window size, landmark arena) are part of the
config because they fix jit shapes.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np


@dataclass
class CameraConfig:
    fx: float = 718.856
    fy: float = 718.856
    cx: float = 607.1928
    cy: float = 185.2157
    k1: float = 0.0
    k2: float = 0.0
    k3: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    width: int = 1241
    height: int = 376

    @property
    def dist(self):
        return np.array([self.k1, self.k2, self.p1, self.p2, self.k3], np.float32)


@dataclass
class TrackerConfig:
    thres_error: float = 60.0  # feature_tracker.thres_error
    thres_bidirection: float = 0.5  # feature_tracker.thres_bidirection
    thres_sampson: float = 60.0  # feature_tracker.thres_sampson (px^2 gate)
    window_size: int = 21  # feature_tracker.window_size (odd)
    max_level: int = 4  # feature_tracker.max_level (pyramid levels)
    max_iter: int = 20
    eps: float = 0.03
    min_eig: float = 1e-4
    # Convergence-bounded iteration budgets (r4 VERDICT #2). All tracking
    # passes in the steady step are prior-seeded (pose-projected landmarks,
    # previous disparity, the forward track's own answer), so:
    #   coarse_iter — non-finest pyramid levels, where the seed error is
    #     <= prior_err / 2^lvl px (sub-pixel by level 1-2);
    #   epi_iter    — rectified-stereo 1-D epipolar refinement (scalar
    #     normal equation, converges in ~3-5 steps);
    #   scale_iter  — trackWithScale refinement, seeded at the converged
    #     forward-KLT answer (reference uses 30 from a cold seed,
    #     feature_tracker.cpp:236-504).
    coarse_iter: int = 6
    epi_iter: int = 8
    scale_iter: int = 12


@dataclass
class ExtractorConfig:
    n_features: int = 1024  # static track capacity (feature_extractor.n_features)
    n_bins_u: int = 24
    n_bins_v: int = 12
    thres_fastscore: float = 15.0
    radius: float = 5.0  # kept for parity; bucketing enforces spacing
    score_min: float = 50.0  # Harris response floor for new features
    # Replenishment trigger (r4 VERDICT #2): detection + disparity-prior +
    # stereo-match + verify + descriptor births cost ~5x the rest of the
    # steady step combined; running them every frame was ~80% of frame time.
    # They now run only when live tracks fall below this fraction of
    # capacity, on keyframe frames, and during bootstrap/recovery.
    replenish_min_ratio: float = 0.75


@dataclass
class MotionEstimatorConfig:
    thres_1p_error: float = 120.0
    use_1point_gate: bool = False  # apply the 1-point circular-arc inlier gate (planar rigs)
    thres_5p_error: float = 1.5  # px, essential inlier gate
    thres_poseba_error: float = 3.0  # px, pose-only BA inlier gate
    pose_ba_iters: int = 50
    huber_delta: float = 0.5
    # Pose acceptance: absolute inlier floor (reference mono_vo.cpp:864-866
    # requires >=10 points) + a low ratio floor; the reference itself fails
    # pose-only BA only on NaN (motion_estimator.cpp:857,1084).
    min_inlier_ratio: float = 0.25
    min_inliers: int = 10
    # Motion-sanity gate vs the constant-velocity prior: reject a solved
    # step beyond max(mult x previous step, absolute floor) in translation
    # or rotation. Protects against wrong-but-self-consistent solves from a
    # poisoned map (r2 death-spiral defect #1).
    sanity_step_mult: float = 4.0
    max_step_abs: float = 3.0  # meters/frame
    max_rot_abs_deg: float = 10.0  # degrees/frame
    # Tracking-loss recovery: after this many consecutive failed poses, try
    # PnP relocalization against surviving landmarks, else re-bootstrap the
    # track/landmark set at the prior-propagated pose.
    recover_after: int = 3
    lba_iters: int = 10  # local BA LM iterations (reference hardcodes 10)
    lba_huber: float = 1.0


@dataclass
class KeyframeConfig:
    thres_overlap_ratio: float = 0.7  # keyframe_update.thres_overlap_ratio / alive_ratio
    thres_translation: float = 4.0  # meters (keyframe_update.thres_trans)
    thres_rotation: float = 10.0  # degrees
    n_max_keyframes_in_window: int = 9
    n_fix: int = 2


@dataclass
class MapConfig:
    thres_parallax: float = 1.0  # degrees (map_update.thres_parallax)
    landmark_capacity: int = 4096
    min_depth: float = 0.5
    max_depth: float = 200.0
    init_depth: float = 10.0  # depth-filter seed prior mean (world units)
    df_converge_ratio: float = 100.0  # seed accepted when std < range/ratio
    df_min_inlier_prob: float = 0.5  # Beta inlier probability floor for promotion


@dataclass
class VOConfig:
    flagDoUndistortion: bool = False
    cam: CameraConfig = field(default_factory=CameraConfig)
    cam_right: CameraConfig = field(default_factory=CameraConfig)
    T_lr: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=np.float32))
    tracker: TrackerConfig = field(default_factory=TrackerConfig)
    extractor: ExtractorConfig = field(default_factory=ExtractorConfig)
    motion: MotionEstimatorConfig = field(default_factory=MotionEstimatorConfig)
    keyframe: KeyframeConfig = field(default_factory=KeyframeConfig)
    map: MapConfig = field(default_factory=MapConfig)


def _scalar(text: str):
    """int, float or (unquoted) string, as a YAML 1.1 reader types the
    reference files' scalars."""
    text = text.strip()
    for conv in (int, float):
        try:
            return conv(text)
        except ValueError:
            pass
    return text.strip("'\"")


def parse_opencv_yaml(text: str) -> dict:
    """Parse the flat OpenCV-YAML subset the reference configs use.

    Grammar: an optional `%YAML:x.y` header, `#` comment lines, top-level
    `key: scalar` lines, and `key: !!opencv-matrix` blocks whose indented
    `rows`/`cols`/`dt`/`data` fields nest under the key; `data: [...]` may
    span lines. Returns {key: scalar | {field: scalar | list}}.
    """
    out: dict = {}
    block = None  # dict of the open !!opencv-matrix block
    pending = None  # (dict, key, text) of a `[...]` list not yet closed
    for n, raw in enumerate(text.splitlines(), 1):
        line = raw.split("#", 1)[0].rstrip()
        if pending is not None:
            pending = (pending[0], pending[1], pending[2] + " " + line.strip())
        elif not line.strip() or line.startswith("%YAML"):
            continue
        elif ":" not in line:
            raise ValueError(f"line {n}: expected 'key: value', got {raw!r}")
        else:
            key, val = (t.strip() for t in line.split(":", 1))
            indented = line[0].isspace()
            if not indented:
                block = None
            elif block is None:
                raise ValueError(f"line {n}: indented line outside an !!opencv-matrix block")
            target = block if indented else out
            if val == "!!opencv-matrix":
                block = target[key] = {}
            elif val.startswith("["):
                pending = (target, key, val)
            else:
                target[key] = _scalar(val)
        if pending is not None and pending[2].endswith("]"):
            d, key, acc = pending
            d[key] = [_scalar(v) for v in acc[1:-1].split(",") if v.strip()]
            pending = None
    if pending is not None:
        raise ValueError(f"unterminated list for key {pending[1]!r}")
    return out


def _get(d: dict, key: str, default):
    v = d.get(key, default)
    return type(default)(v) if v is not None and not isinstance(default, bool) else (bool(v) if isinstance(default, bool) else default)


def load_yaml(path: str, stereo: bool | None = None) -> VOConfig:
    """Load a reference-format YAML (mono or stereo). Unknown keys ignored;
    missing keys keep defaults — same permissiveness as cv::FileStorage reads."""
    with open(path) as f:
        raw = parse_opencv_yaml(f.read())

    cfg = VOConfig()
    if stereo is None:
        stereo = any(k.startswith("Camera.left") for k in raw)

    def fill_cam(cam: CameraConfig, prefix: str):
        for f_ in dataclasses.fields(cam):
            key = f"{prefix}.{f_.name}"
            if key in raw:
                setattr(cam, f_.name, type(getattr(cam, f_.name))(raw[key]))

    if stereo:
        fill_cam(cfg.cam, "Camera.left")
        fill_cam(cfg.cam_right, "Camera.right")
        if "T_lr" in raw and isinstance(raw["T_lr"], dict) and "data" in raw["T_lr"]:
            cfg.T_lr = np.asarray(raw["T_lr"]["data"], np.float32).reshape(4, 4)
    else:
        fill_cam(cfg.cam, "Camera")

    cfg.flagDoUndistortion = bool(raw.get("flagDoUndistortion", 0))

    t = cfg.tracker
    t.thres_error = float(raw.get("feature_tracker.thres_error", t.thres_error))
    t.thres_bidirection = float(raw.get("feature_tracker.thres_bidirection", t.thres_bidirection))
    t.thres_sampson = float(raw.get("feature_tracker.thres_sampson", t.thres_sampson))
    t.window_size = int(raw.get("feature_tracker.window_size", t.window_size))
    t.max_level = min(int(raw.get("feature_tracker.max_level", t.max_level)), 5)

    e = cfg.extractor
    e.n_features = int(raw.get("feature_extractor.n_features", e.n_features))
    e.n_bins_u = int(raw.get("feature_extractor.n_bins_u", e.n_bins_u))
    e.n_bins_v = int(raw.get("feature_extractor.n_bins_v", e.n_bins_v))
    e.thres_fastscore = float(raw.get("feature_extractor.thres_fastscore", e.thres_fastscore))
    e.radius = float(raw.get("feature_extractor.radius", e.radius))

    m = cfg.motion
    m.thres_1p_error = float(raw.get("motion_estimator.thres_1p_error", m.thres_1p_error))
    m.use_1point_gate = bool(int(raw.get("motion_estimator.use_1point_gate", m.use_1point_gate)))
    m.thres_5p_error = float(raw.get("motion_estimator.thres_5p_error", m.thres_5p_error))
    m.thres_poseba_error = float(raw.get("motion_estimator.thres_poseba_error", m.thres_poseba_error))

    k = cfg.keyframe
    k.thres_overlap_ratio = float(
        raw.get("keyframe_update.thres_overlap_ratio", raw.get("keyframe_update.thres_alive_ratio", k.thres_overlap_ratio))
    )
    k.thres_translation = float(
        raw.get("keyframe_update.thres_translation", raw.get("keyframe_update.thres_trans", k.thres_translation))
    )
    k.thres_rotation = float(raw.get("keyframe_update.thres_rotation", k.thres_rotation))
    k.n_max_keyframes_in_window = int(
        raw.get("keyframe_update.n_max_keyframes_in_window", k.n_max_keyframes_in_window)
    )

    cfg.map.thres_parallax = float(raw.get("map_update.thres_parallax", cfg.map.thres_parallax))
    return cfg


def kitti_stereo_config(seq: str = "00") -> VOConfig:
    """Built-in KITTI odometry stereo calibration (grayscale, rectified)."""
    cfg = VOConfig()
    if seq in ("00", "01", "02"):
        fx, cx, cy, base = 718.856, 607.1928, 185.2157, 0.5371657
    elif seq == "03":
        fx, cx, cy, base = 721.5377, 609.5593, 172.854, 0.5371657
    else:
        fx, cx, cy, base = 707.0912, 601.8873, 183.1104, 0.5371657
    for cam in (cfg.cam, cfg.cam_right):
        cam.fx = cam.fy = fx
        cam.cx, cam.cy = cx, cy
    cfg.T_lr = np.eye(4, dtype=np.float32)
    cfg.T_lr[0, 3] = base
    return cfg
