"""Monocular visual-odometry pipeline — 3-phase state machine, jitted stages.

Capability parity with the reference `MonoVO`
(core/visual_odometry/mono_vo/mono_vo.{h,cpp}, trackImage mono_vo.cpp:496-1194):
  phase FIRST  (:496-524)  — detect features only.
  phase INIT   (:525-696)  — track from the first frame, 5-point essential,
                             triangulate with ||t|| normalized to 1 (the mono
                             scale convention, :606), create landmarks.
  phase STEADY (:698-1019) — prior-seeded bidirectional KLT + scale-compensated
                             re-track; pose-only BA on bundled/triangulated
                             landmarks (:799-866); on failure 5-point fallback
                             with translation rescaled to the previous step
                             length (scale propagation, :908-949); Sampson
                             gate (:955-965); replenishment (:976-1013);
                             keyframe rule -> parallax-gated DLT triangulation
                             of window landmarks + local BA (:1022-1128).

Batched design: the steady step is one jitted function; 5-point fallback and the
keyframe/triangulation/BA path are separate jitted functions the host invokes
on scalar flags — RANSAC never runs on the happy path.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from .. import camera as cam_mod
from ..config import VOConfig
from ..mapping import arena as A
from ..ops import ba as BA
from ..ops import depth_filter as DF
from ..ops import epipolar as EP
from ..ops import features as F
from ..ops import klt as KLT
from ..ops import pose_gn as PG
from ..ops import triangulate as TRI
from ..ops.pyramid import build_pyramid_with_gradients
from ..utils import geometry as geo


class MonoVOState(NamedTuple):
    T_wc: jax.Array  # [4, 4]
    dT: jax.Array  # [4, 4] last frame motion
    step_len: jax.Array  # [] scalar — last translation magnitude (scale prop)
    tracks: A.TrackState
    arena: A.LandmarkArena
    ring: A.KeyframeRing
    pyr_prev: tuple  # previous-frame gradient pyramid ((img, gx, gy), ...)
    pyr_first: tuple  # init-phase anchor pyramid
    init_pts0: jax.Array  # [N, 2] detection positions in the first frame
    frame_id: jax.Array
    fail_count: jax.Array  # int32 — consecutive frames where GN AND 5pt failed


class MonoVO:
    """Host driver; phases: 0=first, 1=init, 2=steady."""

    def __init__(self, cfg: VOConfig):
        self.cfg = cfg
        c = cfg.cam
        self.cam = cam_mod.make_camera(c.fx, c.fy, c.cx, c.cy, c.dist, c.width, c.height)
        self.fx, self.fy = float(c.fx), float(c.fy)
        self.cx, self.cy = float(c.cx), float(c.cy)
        # Mono undistortion (reference camera.cpp:163-183, flag read at
        # mono_vo.cpp:150-160): precompute the per-pixel source map once; the
        # pipeline then sees ideal-pinhole images under the same K (all
        # projection ops here are distortion-free).
        if cfg.flagDoUndistortion and float(np.abs(c.dist).max()) > 0:
            self._undist_map = cam_mod.image_undistort_maps(self.cam)
        else:
            self._undist_map = None
        self.N = cfg.extractor.n_features
        self.M = cfg.map.landmark_capacity
        self.K = cfg.keyframe.n_max_keyframes_in_window + 1
        self.klt_params = KLT.KLTParams(
            window_radius=cfg.tracker.window_size // 2,
            levels=cfg.tracker.max_level,
            iters=cfg.tracker.max_iter,
            eps=cfg.tracker.eps,
            min_eig=cfg.tracker.min_eig,
            max_err=cfg.tracker.thres_error,
            fb_thresh=cfg.tracker.thres_bidirection,
            iters_coarse=cfg.tracker.coarse_iter,
        )
        self.pose_params = PG.PoseGNParams(
            max_iters=cfg.motion.pose_ba_iters,
            huber_delta=cfg.motion.huber_delta,
            reproj_thresh=cfg.motion.thres_poseba_error,
            min_inlier_ratio=cfg.motion.min_inlier_ratio,
            min_inliers=cfg.motion.min_inliers,
        )
        self.ba_params = BA.BAParams(
            iters=cfg.motion.lba_iters, n_fix=cfg.keyframe.n_fix, huber_delta=cfg.motion.lba_huber
        )
        self.T_rl_dummy = np.eye(4, dtype=np.float32)

        self._first_frame = jax.jit(self._first_frame_impl)
        self._init_track = jax.jit(self._init_track_impl)
        self._init_bootstrap = jax.jit(self._init_bootstrap_impl)
        self._steady_step = jax.jit(self._steady_step_impl)
        self._fallback_5pt = jax.jit(self._fallback_5pt_impl)
        self._keyframe_step = jax.jit(self._keyframe_step_impl)
        self._recover = jax.jit(self._recover_impl)
        self._scan_steps = jax.jit(self._scan_steps_impl)
        self._remap = (
            jax.jit(lambda im: cam_mod.remap(im, self._undist_map))
            if self._undist_map is not None
            else None
        )

        self.phase = 0
        self.state: MonoVOState | None = None
        self.trajectory: list[np.ndarray] = []
        self.kf_trajectory: list[tuple[int, np.ndarray]] = []
        self.stats_log: list[dict] = []
        self._key = jax.random.key(42)

    # ------------------------------------------------------------------

    def _detect(self, img, pts, valid, n_max):
        cfg = self.cfg
        return F.detect_features(
            img,
            pts,
            valid,
            gh=cfg.extractor.n_bins_v,
            gw=cfg.extractor.n_bins_u,
            n_max=n_max,
            fast_thresh=cfg.extractor.thres_fastscore,
            score_min=cfg.extractor.score_min,
        )

    def _build_pyr(self, img):
        return build_pyramid_with_gradients(img, self.klt_params.levels)

    def _first_frame_impl(self, img):
        pyr = self._build_pyr(img)
        tracks = A.make_tracks(self.N)
        pts, ok = self._detect(img, tracks.pts, tracks.valid, self.N)
        tracks = tracks._replace(pts=pts, valid=ok)
        return MonoVOState(
            T_wc=jnp.eye(4, dtype=jnp.float32),
            dT=jnp.eye(4, dtype=jnp.float32),
            step_len=jnp.asarray(0.0, jnp.float32),
            tracks=tracks,
            arena=A.make_arena(self.M),
            ring=A.make_ring(self.K, self.N),
            pyr_prev=pyr,
            pyr_first=pyr,
            init_pts0=pts,
            frame_id=jnp.asarray(1, jnp.int32),
            fail_count=jnp.asarray(0, jnp.int32),
        )

    def _init_track_impl(self, state: MonoVOState, img):
        """Track the init features FRAME-TO-FRAME into the current image;
        report median displacement vs the anchor frame (init readiness).

        Frame-to-frame (prev pyramid, not the anchor pyramid) is what keeps
        init alive on long spans: anchor-appearance KLT dies under scale
        change / exposure drift well before forward motion builds 20 px of
        median flow (the r3 mono null-ATE: tracks bled 108->0 over 30 init
        frames and bootstrap never fired). The anchor correspondence is kept
        by lane: pts0 = init_pts0, pts1 = chained track position."""
        pyr = self._build_pyr(img)
        pts1, ok = KLT.track_bidirectional_pyr(
            state.pyr_prev, pyr, state.tracks.pts, state.tracks.pts, state.tracks.valid,
            self.klt_params, back_levels=1
        )
        disp = jnp.linalg.norm(pts1 - state.init_pts0, axis=-1)
        med_disp = jnp.nanmedian(jnp.where(ok, disp, jnp.nan))
        tracks = state.tracks._replace(pts=pts1, valid=ok)
        new_state = state._replace(tracks=tracks, pyr_prev=pyr, frame_id=state.frame_id + 1)
        return new_state, med_disp, jnp.sum(ok)

    def _init_bootstrap_impl(self, state: MonoVOState, key):
        """5-point init between first frame and current (mono_vo.cpp:525-696):
        R, t from essential (||t||=1), DLT triangulation, landmark creation,
        two keyframes pushed."""
        pts0 = state.init_pts0
        pts1 = state.tracks.pts
        valid = state.tracks.valid
        xn0 = cam_mod.pixel_to_normalized(self.cam, pts0)
        xn1 = cam_mod.pixel_to_normalized(self.cam, pts1)
        res = EP.estimate_essential_ransac(
            xn0, xn1, valid, key, thresh_px=self.cfg.motion.thres_5p_error, focal=self.fx,
            # Inlier floor scales with detection capacity (tiny rigs detect
            # ~bin-count features; the default 30 would reject their solves).
            min_inliers=max(16, self.N // 16),
        )
        T10 = geo.rt_to_se3(res.R_10, res.t_10)  # ||t|| = 1 (scale convention)
        X0, X1 = TRI.triangulate(xn0, xn1, T10)
        ok3 = (
            res.inliers
            & (X0[:, 2] > self.cfg.map.min_depth)
            & (X1[:, 2] > 0.1)
            & (X0[:, 2] < self.cfg.map.max_depth)
        )

        arena = A.make_arena(self.M)
        slots, slot_ok = A.allocate_slots(~arena.alive, self.N)
        ok_new = ok3 & slot_ok
        # Birth descriptors at the current observation (relocalization table).
        boot_dw, boot_desc_ok = F.orb_descriptors(state.pyr_prev[0][0], pts1)
        boot_desc_u8 = F.desc_to_u8(boot_dw)
        arena = arena._replace(
            Xw=A.onehot_update(arena.Xw, slots, ok_new, X0),  # world = first cam frame
            alive=A.onehot_update(arena.alive, slots, ok_new, op="or"),
            tracked=A.onehot_update(arena.tracked, slots, ok_new, op="or"),
            triangulated=A.onehot_update(arena.triangulated, slots, ok_new, op="or"),
            age=A.onehot_update(arena.age, slots, ok_new, jnp.full((self.N,), 2, jnp.int32)),
            last_pt=A.onehot_update(arena.last_pt, slots, ok_new, pts1),
            # Depth seeds: first camera sits at the origin; the seed lives on
            # the unit ray through the first observation, inverse-range state.
            inv_depth=A.onehot_update(
                arena.inv_depth, slots, ok_new, 1.0 / jnp.maximum(jnp.linalg.norm(X0, axis=-1), 1e-3)
            ),
            inv_depth_var=A.onehot_update(
                arena.inv_depth_var, slots, ok_new,
                DF.measurement_tau2(X0[:, 2], jnp.asarray(1.0), self.fx),
            ),
            df_a=A.onehot_update(arena.df_a, slots, ok_new, jnp.full((self.N,), 10.0, jnp.float32)),
            df_b=A.onehot_update(arena.df_b, slots, ok_new, jnp.full((self.N,), 10.0, jnp.float32)),
            ray_d=A.onehot_update(
                arena.ray_d, slots, ok_new,
                jnp.concatenate([xn0, jnp.ones((self.N, 1))], -1)
                / jnp.maximum(jnp.linalg.norm(jnp.concatenate([xn0, jnp.ones((self.N, 1))], -1), axis=-1, keepdims=True), 1e-9),
            ),
            desc=A.onehot_update(arena.desc, slots, ok_new & boot_desc_ok, boot_desc_u8),
            # set over every born slot: stale-descriptor-on-reuse guard
            # (r4 ADVICE medium, same as stereo).
            desc_valid=A.onehot_update(arena.desc_valid, slots, ok_new, boot_desc_ok),
        )
        tracks = state.tracks._replace(lm_idx=slots, valid=ok_new)

        ring = A.ring_push(
            state.ring,
            jnp.eye(4, dtype=jnp.float32),
            0,
            pts0,
            jnp.zeros_like(pts0),
            slots,
            ok_new,
            jnp.zeros((self.N,), bool),
        )
        ring = A.ring_push(
            ring,
            T10,  # T_cw of current frame (world = first frame)
            state.frame_id,
            pts1,
            jnp.zeros_like(pts1),
            slots,
            ok_new,
            jnp.zeros((self.N,), bool),
        )
        T_wc = geo.se3_inverse(T10)
        # The bootstrap spans frame_id frames: the constant-velocity prior
        # needs the per-frame motion, not the whole-span motion.
        n_span = jnp.maximum(state.frame_id.astype(jnp.float32) - 1.0, 1.0)
        dT = geo.se3_exp(geo.se3_log(T_wc) / n_span)
        new_state = state._replace(
            T_wc=T_wc,
            dT=dT,
            step_len=jnp.linalg.norm(dT[:3, 3]),
            tracks=tracks,
            arena=arena,
            ring=ring,
        )
        return new_state, res.ok, jnp.sum(ok_new)

    def _replenish(self, img, tracks, arena, T_wc, allow=True):
        """New features -> untriangulated landmarks (mono_vo.cpp:976-1013).
        Each birth also plants a depth-filter seed on the world ray through
        the new pixel (SVO-style; depth arrives recursively at keyframes).

        allow: scalar bool — when False (no trusted pose this frame) no
        landmark is born: a seed's world ray anchored at a garbage pose
        poisons the depth filter (r2 death-spiral defect). The 5-point
        fallback re-runs replenishment once it has corrected the pose.
        """
        n_new_cap = self.N // 2
        new_pts, new_ok = self._detect(img, tracks.pts, tracks.valid, n_new_cap)
        slots, slot_ok = A.allocate_slots(~arena.alive, n_new_cap)
        ok_new = new_ok & slot_ok & allow
        zeros_n = jnp.zeros((n_new_cap,), jnp.float32)
        false_n = jnp.zeros((n_new_cap,), bool)
        # Birth ray in world coords + fresh inverse-range seed.
        xn = cam_mod.pixel_to_normalized(self.cam, new_pts)
        d_cam = jnp.concatenate([xn, jnp.ones((n_new_cap, 1))], axis=-1)
        d_w = d_cam @ T_wc[:3, :3].T
        d_w = d_w / jnp.maximum(jnp.linalg.norm(d_w, axis=-1, keepdims=True), 1e-9)
        seeds0 = DF.init_seeds(
            jnp.full((n_new_cap,), self.cfg.map.init_depth, jnp.float32),
            depth_min=self.cfg.map.min_depth,
        )
        # Birth descriptors for relocalization (see stereo twin).
        _dw, _desc_ok = F.orb_descriptors(img, new_pts)
        _desc_u8 = F.desc_to_u8(_dw)
        arena = arena._replace(
            alive=A.onehot_update(arena.alive, slots, ok_new, op="or"),
            tracked=A.onehot_update(arena.tracked, slots, ok_new, op="or"),
            triangulated=A.onehot_update(arena.triangulated, slots, ok_new, false_n),
            bundled=A.onehot_update(arena.bundled, slots, ok_new, false_n),
            age=A.onehot_update(arena.age, slots, ok_new, jnp.ones((n_new_cap,), jnp.int32)),
            last_pt=A.onehot_update(arena.last_pt, slots, ok_new, new_pts),
            inv_depth=A.onehot_update(arena.inv_depth, slots, ok_new, seeds0.mu),
            inv_depth_var=A.onehot_update(arena.inv_depth_var, slots, ok_new, seeds0.sigma2),
            df_a=A.onehot_update(arena.df_a, slots, ok_new, seeds0.a),
            df_b=A.onehot_update(arena.df_b, slots, ok_new, seeds0.b),
            ray_o=A.onehot_update(arena.ray_o, slots, ok_new, jnp.broadcast_to(T_wc[:3, 3], (n_new_cap, 3))),
            ray_d=A.onehot_update(arena.ray_d, slots, ok_new, d_w),
            parallax_last=A.onehot_update(arena.parallax_last, slots, ok_new, zeros_n),
            parallax_max=A.onehot_update(arena.parallax_max, slots, ok_new, zeros_n),
            parallax_min=A.onehot_update(
                arena.parallax_min, slots, ok_new, jnp.full((n_new_cap,), A.PARALLAX_MIN_INIT, jnp.float32)
            ),
            parallax_sum=A.onehot_update(arena.parallax_sum, slots, ok_new, zeros_n),
            parallax_n=A.onehot_update(arena.parallax_n, slots, ok_new, jnp.zeros((n_new_cap,), jnp.int32)),
            desc=A.onehot_update(arena.desc, slots, ok_new & _desc_ok, _desc_u8),
            # set over every born slot: stale-descriptor-on-reuse guard
            # (r4 ADVICE medium, same as stereo).
            desc_valid=A.onehot_update(arena.desc_valid, slots, ok_new, _desc_ok),
        )
        free_lane = ~tracks.valid
        lanes, lane_ok = A.allocate_slots(free_lane, n_new_cap)
        put = ok_new & lane_ok
        tracks = tracks._replace(
            pts=A.onehot_update(tracks.pts, lanes, put, new_pts),
            lm_idx=A.onehot_update(tracks.lm_idx, lanes, put, slots),
            valid=A.onehot_update(tracks.valid, lanes, put, op="or"),
            scale=A.onehot_update(tracks.scale, lanes, put, jnp.ones((n_new_cap,), jnp.float32)),
        )
        return tracks, arena, jnp.sum(put)

    def _track_stage_impl(self, state: MonoVOState, img):
        """Stage: pyramid + priors + bidirectional KLT + scale refinement
        (statisticsStamped time_track bucket)."""
        tracks = state.tracks
        arena = state.arena
        pyr = self._build_pyr(img)

        T_wc_prior = state.T_wc @ state.dT
        T_cw_prior = geo.se3_inverse(T_wc_prior)
        T_cw_prev = geo.se3_inverse(state.T_wc)
        lm_X = arena.Xw[tracks.lm_idx]
        has_3d = tracks.valid & arena.triangulated[tracks.lm_idx]
        prior_pts, prior_depth = KLT.calc_prior(lm_X, T_cw_prior, self.fx, self.fy, self.cx, self.cy)
        depth_prev = geo.transform_points(T_cw_prev, lm_X)[..., 2]
        scale_prior = jnp.clip(depth_prev / jnp.maximum(prior_depth, 0.1), 0.25, 4.0)
        scale_prior = jnp.where(has_3d, scale_prior, 1.0)
        prior_pts = jnp.where((has_3d & (prior_depth > 0.1))[:, None], prior_pts, tracks.pts)

        # Bidirectional prior-seeded KLT (reference trackBidirectionWithPrior).
        pts1, ok_track = KLT.track_bidirectional_pyr(
            state.pyr_prev, pyr, tracks.pts, prior_pts, tracks.valid, self.klt_params,
            fb_scale=5.0, back_levels=1
        )
        img_prev, du0, dv0 = state.pyr_prev[0]
        # Mono keeps the reference's 30-iteration scale refinement: the mono
        # scale chain (depth-filter seeds -> parallax triangulation) sits
        # closer to keyframe-cadence boundaries than stereo, and mono is not
        # the benched serving path, so the scale_iter budget is stereo-only.
        pts1_ref, ok_scale = KLT.track_with_scale(
            img_prev, du0, dv0, img, tracks.pts, pts1, scale_prior, ok_track,
        )
        pts1 = jnp.where(ok_scale[:, None], pts1_ref, pts1)
        return pyr, pts1, ok_track, has_3d, scale_prior

    def _onep_stage_impl(self, state: MonoVOState, pts1, ok_track):
        """Stage: 1-point steering-angle histogram (motion_estimator.cpp:471-537;
        time_1p bucket): the vote always runs (the reference publishes the
        steering angle in its statistics topic); the circular-arc epipolar
        gate is applied only when configured (planar rigs)."""
        op = EP.one_point_pose(
            state.tracks.pts, pts1, ok_track, self.fx, self.fy, self.cx, self.cy,
            thres_px=self.cfg.motion.thres_1p_error,
        )
        if self.cfg.motion.use_1point_gate:
            ok_track = ok_track & op.inliers
        return op.theta, op.n_inliers, ok_track

    def _pose_stage_impl(self, state: MonoVOState, pts1, ok_track, has_3d):
        """Stage: pose-only GN + Sampson gate (time_pose bucket)."""
        cfg = self.cfg
        tracks = state.tracks
        T_cw_prev = geo.se3_inverse(state.T_wc)
        lm_X = state.arena.Xw[tracks.lm_idx]

        # Pose-only GN on triangulated landmarks with positive depth.
        X0 = geo.transform_points(T_cw_prev, lm_X)
        gn_valid = ok_track & has_3d & (X0[..., 2] > 0.1)
        n_gn = jnp.sum(gn_valid)
        T10_init = geo.se3_inverse(state.dT)
        # Two-pass gated GN (see pose_gn.pose_only_gn_mono_robust): a hard
        # reprojection gate + re-solve strips coherent dynamic outliers that
        # bias the single Huber solve.
        res, err_px = PG.pose_only_gn_mono_robust(
            X0, pts1, gn_valid, self.fx, self.fy, self.cx, self.cy, T10_init, self.pose_params
        )
        # Motion-sanity gate vs the constant-velocity prior (see stereo twin;
        # mono steps are up-to-scale but scale-consistent frame to frame).
        m = self.cfg.motion
        dT_cand = geo.se3_inverse(res.T10)
        step_prev = jnp.linalg.norm(state.dT[:3, 3])
        step_new = jnp.linalg.norm(dT_cand[:3, 3])
        cos_p = jnp.clip((jnp.trace(state.dT[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)
        cos_n = jnp.clip((jnp.trace(dT_cand[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)
        sane = (step_new <= jnp.maximum(m.sanity_step_mult * step_prev, m.max_step_abs)) & (
            jnp.degrees(jnp.arccos(cos_n))
            <= jnp.maximum(m.sanity_step_mult * jnp.degrees(jnp.arccos(cos_p)), m.max_rot_abs_deg)
        )
        pose_ok = res.ok & sane & (n_gn >= 10)
        T10 = jnp.where(pose_ok, res.T10, T10_init)
        dT_new = geo.se3_inverse(T10)
        # se3_project: per-frame composition accumulates rotation drift
        # (see geo.so3_project docstring — the r4 det-decay collapse).
        T_wc_new = geo.se3_project(state.T_wc @ dT_new)

        # Sampson gate on the estimated motion (mono_vo.cpp:955-965).
        E = EP.essential_from_rt(T10[:3, :3], T10[:3, 3] / jnp.maximum(jnp.linalg.norm(T10[:3, 3]), 1e-9))
        xn0 = cam_mod.pixel_to_normalized(self.cam, tracks.pts)
        xn1 = cam_mod.pixel_to_normalized(self.cam, pts1)
        sampson_px2 = EP.sampson_distance(E, xn0, xn1) * self.fx * self.fx
        samp_ok = sampson_px2 < cfg.tracker.thres_sampson
        # On GN failure KEEP every KLT-consistent track (see stereo twin):
        # the drifting prior would otherwise mass-kill the correspondences
        # PnP relocalization needs; map feeding is gated on pose_ok upstream.
        inliers = jnp.where(pose_ok, res.inliers, True)
        survived = ok_track & samp_ok & jnp.where(has_3d, inliers, True)
        return T10, dT_new, T_wc_new, survived, pose_ok, res.mean_err, n_gn

    def _update_stage_impl(
        self, state: MonoVOState, pyr, img, pts1, ok_track, scale_prior,
        T10, dT_new, T_wc_new, survived, pose_ok, mean_err, n_gn, theta_1p, n_pass_1p,
    ):
        """Stage: arena/parallax updates, replenishment, keyframe rule
        (time_new bucket), final state/scalars assembly."""
        cfg = self.cfg
        tracks = state.tracks
        arena = state.arena

        # Parallax update (rotation-compensated, landmark.cpp:107-134).
        r0_dir = jnp.stack(
            [
                (tracks.pts[:, 0] - self.cx) / self.fx,
                (tracks.pts[:, 1] - self.cy) / self.fy,
                jnp.ones(self.N),
            ],
            axis=-1,
        )
        r1_dir = jnp.stack(
            [(pts1[:, 0] - self.cx) / self.fx, (pts1[:, 1] - self.cy) / self.fy, jnp.ones(self.N)],
            axis=-1,
        )
        r1_rot = r1_dir @ T10[:3, :3]
        r0n = r0_dir / jnp.linalg.norm(r0_dir, axis=-1, keepdims=True)
        r1n = r1_rot / jnp.maximum(jnp.linalg.norm(r1_rot, axis=-1, keepdims=True), 1e-9)
        par = jnp.arccos(jnp.clip(jnp.sum(r0n * r1n, axis=-1), -1.0, 1.0))

        tracked_now = A.onehot_update(
            jnp.zeros_like(arena.tracked), tracks.lm_idx, survived, op="or"
        )
        arena = arena._replace(
            tracked=tracked_now,
            age=A.onehot_update(arena.age, tracks.lm_idx, survived, jnp.ones((self.N,), jnp.int32), op="add"),
            last_pt=A.onehot_update(arena.last_pt, tracks.lm_idx, survived, pts1),
        )
        arena = A.parallax_observe(arena, tracks.lm_idx, survived, par)
        avg_parallax, avg_age = A.landmark_stat_means(arena)
        tracks = tracks._replace(pts=pts1, valid=survived, scale=scale_prior)

        # Keyframe rule (computed before replenishment — births are never in
        # the last keyframe's landmark set, so the overlap is unchanged; the
        # decision gates replenishment below).
        head = state.ring.head
        last_kf_lm = state.ring.lm_idx[head]
        last_kf_ov = state.ring.obs_valid[head]
        still = A.onehot_update(jnp.zeros((self.M,), bool), tracks.lm_idx, tracks.valid, op="or")
        still = jnp.concatenate([still, jnp.zeros((1,), bool)])
        overlap = jnp.sum(still[jnp.where(last_kf_ov, last_kf_lm, self.M)] & last_kf_ov) / jnp.maximum(
            jnp.sum(last_kf_ov), 1
        )
        T_kf_wc = geo.se3_inverse(state.ring.T_cw[head])
        dT_kf = geo.se3_inverse(T_kf_wc) @ T_wc_new
        trans = jnp.linalg.norm(dT_kf[:3, 3])
        cos_r = jnp.clip((jnp.trace(dT_kf[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)
        rot_deg = jnp.degrees(jnp.arccos(cos_r))
        need_kf = (
            (overlap < cfg.keyframe.thres_overlap_ratio)
            | (trans > cfg.keyframe.thres_translation)
            | (rot_deg > cfg.keyframe.thres_rotation)
        )

        # Replenishment gated on a trusted pose (the 5-point fallback re-runs
        # it after correcting the pose — death-spiral defect, r2 weak #1) AND
        # on needing features (r4 VERDICT #2, see stereo twin): detection +
        # back-track + descriptor births only run on deficit/keyframe frames.
        n_live = jnp.sum(tracks.valid)
        deficit = n_live < jnp.int32(int(cfg.extractor.replenish_min_ratio * self.N))
        do_rep = pose_ok & (deficit | need_kf)

        def _rep(ta):
            t, a = ta
            return self._replenish(img, t, a, T_wc_new, allow=True)

        def _norep(ta):
            t, a = ta
            return t, a, jnp.asarray(0, jnp.int32)

        tracks, arena, n_new = jax.lax.cond(do_rep, _rep, _norep, (tracks, arena))

        step_len = jnp.linalg.norm(dT_new[:3, 3])
        new_state = state._replace(
            T_wc=T_wc_new,
            dT=dT_new,
            step_len=jnp.where(pose_ok, step_len, state.step_len),
            tracks=tracks,
            arena=arena,
            pyr_prev=pyr,
            frame_id=state.frame_id + 1,
            # Tentative: the 5-point fallback resets this when it succeeds.
            fail_count=jnp.where(pose_ok, 0, state.fail_count + 1).astype(jnp.int32),
        )
        n_ok_parallax = jnp.sum(
            arena.alive & (arena.parallax_max >= jnp.radians(cfg.map.thres_parallax))
        )
        scalars = dict(
            n_initial=jnp.sum(state.tracks.valid),
            n_tracked=jnp.sum(ok_track),
            n_gn=n_gn,
            n_inliers=jnp.sum(survived),
            n_new=n_new,
            n_ok_parallax=n_ok_parallax,
            pose_ok=pose_ok,
            mean_reproj_err=mean_err,
            overlap_ratio=overlap,
            need_keyframe=need_kf,
            steering_angle=theta_1p,
            n_pass_1p=n_pass_1p,
            avg_parallax=avg_parallax,
            avg_age=avg_age,
        )
        return new_state, scalars

    def _steady_step_impl(self, state: MonoVOState, img):
        """One steady frame = the four stage impls fused into one jit (the
        production path; track_image(timed=True) jits each separately)."""
        pyr, pts1, ok_track, has_3d, scale_prior = self._track_stage_impl(state, img)
        theta_1p, n_pass_1p, ok_track = self._onep_stage_impl(state, pts1, ok_track)
        T10, dT_new, T_wc_new, survived, pose_ok, mean_err, n_gn = self._pose_stage_impl(
            state, pts1, ok_track, has_3d
        )
        return self._update_stage_impl(
            state, pyr, img, pts1, ok_track, scale_prior,
            T10, dT_new, T_wc_new, survived, pose_ok, mean_err, n_gn, theta_1p, n_pass_1p,
        )

    def _fallback_5pt_impl(self, state_prev: MonoVOState, state_new: MonoVOState, key):
        """5-point fallback with scale propagation (mono_vo.cpp:908-949):
        recompute this frame's motion from 2D-2D geometry, rescale translation
        to the previous step length. On success, re-run the replenishment the
        steady step skipped (landmark births need a trusted pose) and reset
        the failure counter."""
        tracks_prev = state_prev.tracks
        pts1 = state_new.tracks.pts  # same lanes: steady step preserved order
        ok = tracks_prev.valid & state_new.tracks.valid
        xn0 = cam_mod.pixel_to_normalized(self.cam, tracks_prev.pts)
        xn1 = cam_mod.pixel_to_normalized(self.cam, pts1)
        res = EP.estimate_essential_ransac(
            xn0, xn1, ok, key, thresh_px=self.cfg.motion.thres_5p_error, focal=self.fx
        )
        t_scaled = res.t_10 * state_prev.step_len  # propagate scale
        T10 = geo.rt_to_se3(res.R_10, t_scaled)
        dT = geo.se3_inverse(T10)
        T_wc = state_prev.T_wc @ dT
        # Sanity-gate the fallback too (wrong 2D-2D geometry on repeated
        # texture should not outrun the prior).
        m = self.cfg.motion
        cos_p = jnp.clip((jnp.trace(state_prev.dT[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)
        cos_n = jnp.clip((jnp.trace(dT[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)
        fb_ok = res.ok & (
            jnp.degrees(jnp.arccos(cos_n))
            <= jnp.maximum(m.sanity_step_mult * jnp.degrees(jnp.arccos(cos_p)), m.max_rot_abs_deg)
        )
        T_wc = jnp.where(fb_ok, T_wc, state_new.T_wc)
        dT = jnp.where(fb_ok, dT, state_new.dT)
        img = state_new.pyr_prev[0][0]  # current frame (steady step cached it)
        tracks, arena, _n_new = self._replenish(
            img, state_new.tracks, state_new.arena, T_wc, allow=fb_ok
        )
        return state_new._replace(
            T_wc=T_wc,
            dT=dT,
            tracks=tracks,
            arena=arena,
            fail_count=jnp.where(fb_ok, 0, state_new.fail_count),
        ), fb_ok

    def _recover_impl(self, state: MonoVOState):
        """Tracking-loss recovery after `recover_after` frames where both the
        pose GN and the 5-point fallback failed (r2 next-round ask #2).

        1. PnP relocalization (ops/pnp.py) against surviving triangulated
           landmarks still tracked in 2D.
        2. Else re-bootstrap: wipe tracks, fresh detection epoch (depth-filter
           seeds at the prior-propagated pose), reset keyframe window (fresh
           BA gauge). Subsequent frames regain relative motion through the
           5-point fallback until keyframe DLT re-triangulates the map.

        Returns (state, mode): 1 = PnP, 2 = re-bootstrap.
        """
        from ..ops import pnp as PNP

        m = self.cfg.motion
        key = jax.random.fold_in(jax.random.key(0x5EC1), state.frame_id)
        tracks = state.tracks
        lm_X = state.arena.Xw[tracks.lm_idx]
        tri = (state.arena.alive & state.arena.triangulated)[tracks.lm_idx]
        cand = tracks.valid & tri
        pnp = PNP.pnp_ransac(
            lm_X, tracks.pts, cand, key, self.fx, self.fy, self.cx, self.cy,
            thresh_px=1.5 * self.pose_params.reproj_thresh,
            n_hypotheses=128, min_inlier_ratio=0.3,
            T_init=geo.se3_inverse(state.T_wc),
        )
        T_wc_pnp = geo.se3_inverse(pnp.T_cw)
        jump = jnp.linalg.norm(T_wc_pnp[:3, 3] - state.T_wc[:3, 3])
        pnp_good = pnp.ok & (pnp.n_inliers >= 15) & (
            jump <= 2.0 * m.recover_after * m.max_step_abs
        )

        def relocalize(s):
            valid_new = (cand & pnp.inliers) | (s.tracks.valid & ~tri)
            return s._replace(
                T_wc=T_wc_pnp,
                tracks=s.tracks._replace(valid=valid_new),
                fail_count=jnp.asarray(0, jnp.int32),
            )

        def rebootstrap(s):
            arena = s.arena._replace(tracked=jnp.zeros((self.M,), bool))
            img = s.pyr_prev[0][0]
            tracks2, arena, _n = self._replenish(
                img, A.make_tracks(self.N), arena, s.T_wc, allow=True
            )
            ring = A.ring_push(
                A.make_ring(self.K, self.N),
                geo.se3_inverse(s.T_wc),
                s.frame_id,
                tracks2.pts,
                jnp.zeros_like(tracks2.pts),
                tracks2.lm_idx,
                tracks2.valid,
                jnp.zeros((self.N,), bool),
            )
            return s._replace(
                tracks=tracks2, arena=arena, ring=ring, fail_count=jnp.asarray(0, jnp.int32)
            )

        state = jax.lax.cond(pnp_good, relocalize, rebootstrap, state)
        return state, jnp.where(pnp_good, 1, 2).astype(jnp.int32)

    def _keyframe_step_impl(self, state: MonoVOState):
        """Push KF; parallax-gated DLT triangulation of untriangulated window
        landmarks (mono_vo.cpp:1032-1077); local BA."""
        T_cw = geo.se3_inverse(state.T_wc)
        ring = A.ring_push(
            state.ring,
            T_cw,
            state.frame_id,
            state.tracks.pts,
            jnp.zeros_like(state.tracks.pts),
            state.tracks.lm_idx,
            state.tracks.valid,
            jnp.zeros((self.N,), bool),
        )
        arena = state.arena
        gathered = A.gather_ba_problem(ring, arena)
        mask = gathered["mask"]  # [M, K] ordered oldest->newest
        T_cw_win = gathered["T_cw"]

        # --- Triangulate landmarks with >=2 window obs, enough parallax ---
        k_idx = jnp.arange(self.K)
        first_k = jnp.argmax(mask, axis=1)  # first (oldest) observing KF
        last_k = self.K - 1 - jnp.argmax(mask[:, ::-1], axis=1)  # newest
        n_obs = jnp.sum(mask, axis=1)
        cand = arena.alive & ~arena.triangulated & (n_obs >= 2) & (first_k < last_k)

        p0 = jnp.take_along_axis(gathered["pts"], first_k[:, None, None], axis=1)[:, 0]
        p1 = jnp.take_along_axis(gathered["pts"], last_k[:, None, None], axis=1)[:, 0]
        T0 = T_cw_win[first_k]  # [M, 4, 4]
        T1 = T_cw_win[last_k]
        T_10 = T1 @ jax.vmap(geo.se3_inverse)(T0)
        xn0 = cam_mod.pixel_to_normalized(self.cam, p0)
        xn1 = cam_mod.pixel_to_normalized(self.cam, p1)

        # Batched per-landmark two-view DLT with its own relative pose.
        def tri_one(xn0_i, xn1_i, T10_i):
            X0, X1 = TRI.triangulate(xn0_i[None], xn1_i[None], T10_i)
            return X0[0], X1[0]

        X0, X1 = jax.vmap(tri_one)(xn0, xn1, T_10)
        # Parallax between the two rays (rotation-compensated).
        r0 = jnp.concatenate([xn0, jnp.ones((self.M, 1))], axis=-1)
        r1 = jnp.concatenate([xn1, jnp.ones((self.M, 1))], axis=-1)
        r1w = jnp.einsum("mij,mj->mi", T_10[:, :3, :3].transpose(0, 2, 1), r1)
        cosang = jnp.sum(r0 * r1w, axis=-1) / jnp.maximum(
            jnp.linalg.norm(r0, axis=-1) * jnp.linalg.norm(r1w, axis=-1), 1e-9
        )
        par_deg = jnp.degrees(jnp.arccos(jnp.clip(cosang, -1.0, 1.0)))
        par_ok = par_deg >= self.cfg.map.thres_parallax
        # Reprojection check in both views (1 px, mono_vo.cpp:1070).
        uv0 = cam_mod.project_to_pixel(self.cam, X0)
        uv1 = cam_mod.project_to_pixel(self.cam, X1)
        reproj_ok = (jnp.linalg.norm(uv0 - p0, axis=-1) < 2.0) & (jnp.linalg.norm(uv1 - p1, axis=-1) < 2.0)
        depth_ok = (X0[:, 2] > self.cfg.map.min_depth) & (X1[:, 2] > 0.05) & (X0[:, 2] < self.cfg.map.max_depth)
        tri_ok = cand & par_ok & depth_ok & reproj_ok
        # World position: X0 is in first-observing-KF frame.
        T_wc0 = jax.vmap(geo.se3_inverse)(T0)
        Xw_new = jnp.einsum("mij,mj->mi", T_wc0[:, :3, :3], X0) + T_wc0[:, :3, 3]

        # --- Recursive inverse-range depth filter (SVO-style; the algorithm
        # the reference left unfinished at standalone/depth_filter) ---------
        # Every geometrically-sane DLT result — including LOW-parallax ones
        # that fail the instant-triangulation gate — feeds the seed on the
        # landmark's birth ray; seeds whose posterior converges are promoted.
        meas_ok = cand & depth_ok & reproj_ok & (par_deg >= 0.15)
        r_meas = jnp.linalg.norm(Xw_new - arena.ray_o, axis=-1)
        x_meas = 1.0 / jnp.maximum(r_meas, 1e-3)
        c1 = -jnp.einsum("mij,mi->mj", T1[:, :3, :3], T1[:, :3, 3])  # newest-view centers
        t_norm = jnp.linalg.norm(c1 - T_wc0[:, :3, 3], axis=-1)
        tau2 = DF.measurement_tau2(X0[:, 2], t_norm, self.fx)
        seeds = DF.DepthSeeds(
            mu=arena.inv_depth,
            sigma2=arena.inv_depth_var,
            a=arena.df_a,
            b=arena.df_b,
            z_range=jnp.full((self.M,), 1.0 / self.cfg.map.min_depth, jnp.float32),
        )
        seeds = DF.update_seeds(seeds, x_meas, tau2, meas_ok)
        promote = (
            cand
            & ~tri_ok
            & DF.converged(seeds, self.cfg.map.df_converge_ratio)
            & (DF.inlier_probability(seeds) > self.cfg.map.df_min_inlier_prob)
        )
        Xw_df = arena.ray_o + arena.ray_d / jnp.maximum(seeds.mu, 1e-4)[:, None]

        arena = arena._replace(
            Xw=jnp.where(tri_ok[:, None], Xw_new, jnp.where(promote[:, None], Xw_df, arena.Xw)),
            triangulated=arena.triangulated | tri_ok | promote,
            inv_depth=jnp.where(tri_ok, x_meas, seeds.mu),
            inv_depth_var=jnp.where(tri_ok, tau2, seeds.sigma2),
            df_a=seeds.a,
            df_b=seeds.b,
        )

        # --- Local BA ---
        problem = BA.BAProblem(
            T_cw=T_cw_win,
            Xw=arena.Xw,
            pts=gathered["pts"],
            mask=mask,
            pts_r=gathered["pts_r"],
            mask_r=gathered["mask_r"],
            kf_valid=gathered["kf_valid"],
            lm_valid=arena.alive & arena.triangulated,
        )
        res = BA.ba_solve(
            problem, self.fx, self.fy, self.cx, self.cy, jnp.asarray(self.T_rl_dummy), self.ba_params
        )
        # Acceptance guard (shared rule, BA.ba_accept; see stereo twin):
        # reject a solve that ends worse than it started instead of writing
        # a diverged window back.
        accept = BA.ba_accept(
            res.mean_err_px, res.mean_err0_px, self.pose_params.reproj_thresh
        )
        T_cw_res = jnp.where(accept, res.T_cw, T_cw_win)
        Xw_res = jnp.where(accept, res.Xw, arena.Xw)
        killed = res.killed & accept
        order = A.ring_order(ring)
        # Permutation write-back as one-hot einsum (scatter-free).
        perm = (order[:, None] == jnp.arange(ring.capacity, dtype=order.dtype)[None, :]).astype(jnp.float32)
        ring = ring._replace(T_cw=jnp.einsum("pk,pij->kij", perm, T_cw_res))
        T_wc_new = geo.se3_inverse(ring.T_cw[ring.head])
        touched = (arena.alive & arena.triangulated) & (jnp.sum(problem.mask, axis=1) >= 2) & accept
        arena = arena._replace(
            Xw=Xw_res,
            alive=arena.alive & ~killed,
            # drop killed slots' descriptors (stale-appearance guard, r4 ADVICE)
            desc_valid=arena.desc_valid & ~killed,
            bundled=arena.bundled | touched,
        )
        n_tri = jnp.sum(tri_ok | promote)

        # Post-BA patch-scale recompute (mono_vo.cpp:1085-1128): refresh each
        # tracked landmark's patch scale from BA-refined geometry — scale =
        # depth in its first observing window KF / depth in the current frame.
        T0_ref = T_cw_res[first_k]  # [M, 4, 4] refined pose of first observing KF
        d0 = jnp.einsum("mj,mj->m", T0_ref[:, 2, :3], arena.Xw) + T0_ref[:, 2, 3]
        T_cw_new = geo.se3_inverse(T_wc_new)
        d1 = arena.Xw @ T_cw_new[2, :3] + T_cw_new[2, 3]
        scale_lm = jnp.clip(d0 / jnp.maximum(d1, 0.1), 0.25, 4.0)
        scale_tr = scale_lm[state.tracks.lm_idx]
        scale_ok = (
            state.tracks.valid
            & (arena.alive & arena.triangulated)[state.tracks.lm_idx]
            & (d1[state.tracks.lm_idx] > 0.1)
            & (d0[state.tracks.lm_idx] > 0.1)
        )
        tracks = state.tracks._replace(
            scale=jnp.where(scale_ok, scale_tr, state.tracks.scale)
        )
        return state._replace(T_wc=T_wc_new, ring=ring, arena=arena, tracks=tracks), res.mean_err_px, n_tri, accept

    def _scan_steps_impl(self, state: MonoVOState, key, imgs):
        """Device-resident multi-frame mono step: lax.scan over B frames with
        the 5-point fallback and keyframe/BA branches inlined as lax.cond —
        one host->device upload and one readback per batch (mirrors the
        stereo scan path)."""

        # Batch u8 -> f32 once, not per frame inside the scan.
        imgs = imgs.astype(jnp.float32)
        if self._undist_map is not None:
            imgs = jax.vmap(lambda im: cam_mod.remap(im, self._undist_map))(imgs)

        def one_frame(carry, img):
            state, key = carry
            key, sub = jax.random.split(key)
            state_new, sc = self._steady_step_impl(state, img)

            def fb(args):
                prev, new, k = args
                return self._fallback_5pt_impl(prev, new, k)

            state_new, est_ok = jax.lax.cond(
                sc["pose_ok"],
                lambda args: (args[1], jnp.array(True)),
                fb,
                (state, state_new, sub),
            )

            # Tracking-loss recovery (PnP relocalization / re-bootstrap).
            state_new, rec_mode = jax.lax.cond(
                state_new.fail_count >= self.cfg.motion.recover_after,
                self._recover_impl,
                lambda s: (s, jnp.asarray(0, jnp.int32)),
                state_new,
            )

            def do_kf(s):
                s2, ba_err, n_tri, acc = self._keyframe_step_impl(s)
                return s2, ba_err, n_tri, acc

            def no_kf(s):
                return s, jnp.asarray(-1.0, jnp.float32), jnp.asarray(0, jnp.int32), jnp.asarray(True)

            # Keyframe insertion needs a trusted pose (GN or fallback) and no
            # recovery this frame (re-bootstrap already pushed a fresh KF).
            state_new, ba_err, n_tri, ba_acc = jax.lax.cond(
                sc["need_keyframe"] & est_ok & (rec_mode == 0), do_kf, no_kf, state_new
            )
            sc = dict(sc, recovered=rec_mode, fail_count=state_new.fail_count, est_ok=est_ok,
                      ba_rejected=~ba_acc)
            return (state_new, key), (state_new.T_wc, sc, ba_err, n_tri)

        (state, key), outs = jax.lax.scan(one_frame, (state, key), imgs)
        return state, key, outs

    def track_batch(self, imgs: np.ndarray):
        """Process a batch of B frames in one device call (steady phase only:
        bootstrap with per-frame track_image until phase == 2 first).
        Returns list of stats dicts."""
        if self.phase != 2:
            raise RuntimeError(
                "track_batch requires a bootstrapped pipeline (phase 2); "
                "feed initial frames through track_image first"
            )
        self.state, self._key, (poses, sc, ba_errs, n_tris) = self._scan_steps(
            self.state, self._key, jnp.asarray(imgs)
        )
        # ONE device->host transfer for the whole batch output (see stereo
        # track_stereo_batch).
        poses, sc, ba_errs, n_tris = jax.device_get((poses, sc, ba_errs, n_tris))
        out = []
        for i in range(poses.shape[0]):
            need_kf = (
                bool(sc["need_keyframe"][i])
                and bool(sc["est_ok"][i])
                and int(sc["recovered"][i]) == 0
            )
            stats = {
                "frame": len(self.trajectory),
                "phase": "steady",
                "keyframe": need_kf,
                "fail_count": int(sc["fail_count"][i]),
                "recovered": int(sc["recovered"][i]),
                "n_initial": int(sc["n_initial"][i]),
                "n_ok_parallax": int(sc["n_ok_parallax"][i]),
                "n_tracked": int(sc["n_tracked"][i]),
                "n_inliers": int(sc["n_inliers"][i]),
                "n_new": int(sc["n_new"][i]),
                "pose_ok": bool(sc["pose_ok"][i]),
                "used_fallback": not bool(sc["pose_ok"][i]),
                "mean_reproj_err": float(sc["mean_reproj_err"][i]),
                "overlap_ratio": float(sc["overlap_ratio"][i]),
                "steering_angle": float(sc["steering_angle"][i]),
                "n_pass_1p": int(sc["n_pass_1p"][i]),
                "avg_parallax": float(sc["avg_parallax"][i]),
                "avg_age": float(sc["avg_age"][i]),
                "ba_err": float(ba_errs[i]) if ba_errs[i] >= 0 else None,
                "ba_rejected": bool(sc["ba_rejected"][i]) if need_kf else False,
                "n_triangulated": int(n_tris[i]),
            }
            self.trajectory.append(poses[i])
            if need_kf:
                self.kf_trajectory.append((stats["frame"], poses[i]))
            self.stats_log.append(stats)
            out.append(stats)
        return out

    # ------------------------------------------------------------------

    def _steady_step_timed(self, state: MonoVOState, im):
        """Instrumented steady step: stages jitted separately and host-timed
        (the reference's tic/toc stage instrumentation, mono_vo.cpp:762-790)."""
        import time as _time

        if not hasattr(self, "_j_stages"):
            self._j_stages = (
                jax.jit(self._track_stage_impl),
                jax.jit(self._onep_stage_impl),
                jax.jit(self._pose_stage_impl),
                jax.jit(self._update_stage_impl),
            )
        jt, j1, jp, ju = self._j_stages
        t0 = _time.perf_counter()
        pyr, pts1, ok_track, has_3d, scale_prior = jax.block_until_ready(jt(state, im))
        t1 = _time.perf_counter()
        theta_1p, n_pass_1p, ok_track = jax.block_until_ready(j1(state, pts1, ok_track))
        t2 = _time.perf_counter()
        out_p = jax.block_until_ready(jp(state, pts1, ok_track, has_3d))
        t3 = _time.perf_counter()
        new_state, scalars = jax.block_until_ready(
            ju(state, pyr, im, pts1, ok_track, scale_prior, *out_p, theta_1p, n_pass_1p)
        )
        t4 = _time.perf_counter()
        stage_ms = {
            "time_track": (t1 - t0) * 1e3,
            "time_1p": (t2 - t1) * 1e3,
            "time_pose": (t3 - t2) * 1e3,
            "time_new": (t4 - t3) * 1e3,
        }
        return new_state, scalars, stage_ms

    def debug_overlay(self, img: np.ndarray) -> np.ndarray:
        """Per-frame debug image (reference showTracking, mono_vo.cpp:392-475)."""
        from ..io.visualize import draw_tracking
        from ..utils import geometry as _geo

        st = self.state
        pts = np.asarray(st.tracks.pts)
        valid = np.asarray(st.tracks.valid)
        lm_idx = np.asarray(st.tracks.lm_idx)
        new_mask = np.asarray(st.arena.age)[lm_idx] <= 1
        T_cw = np.asarray(_geo.se3_inverse(st.T_wc))
        Xw = np.asarray(st.arena.Xw)[lm_idx]
        Xc = Xw @ T_cw[:3, :3].T + T_cw[:3, 3]
        tri = np.asarray(st.arena.triangulated)[lm_idx] & valid & (Xc[:, 2] > 0.1)
        uv = Xc[:, :2] / np.maximum(Xc[:, 2:3], 1e-6) * np.array([self.fx, self.fy]) + np.array(
            [self.cx, self.cy]
        )
        return draw_tracking(img, pts, valid, new_mask, uv[tri])

    def track_image(self, img: np.ndarray, timestamp: float = 0.0, timed: bool = False):
        import time as _time

        im = jnp.asarray(img, jnp.float32)
        if self._remap is not None:
            im = self._remap(im)
        if self.phase == 0:
            self.state = self._first_frame(im)
            self.phase = 1
            self.trajectory.append(np.eye(4, dtype=np.float32))
            stats = {"frame": 0, "phase": "first", "keyframe": False}
            self.stats_log.append(stats)
            return np.eye(4, dtype=np.float32), stats

        if self.phase == 1:
            self.state, med_disp, n_ok = self._init_track(self.state, im)
            med_disp = float(med_disp)
            stats = {
                "frame": len(self.trajectory),  # trajectory index of this frame
                "phase": "init",
                "median_disp": med_disp,
                "n_tracked": int(n_ok),
                "keyframe": False,
            }
            # Bootstrap when features have moved enough for a conditioned
            # 5-point solve (displacement proxy for parallax). Forward motion
            # builds median flow slowly (radial field, ~0 at the FOE) — the
            # span trigger bootstraps off accumulated baseline instead of
            # waiting for 20 px that may never come; the reference inits off
            # two consecutive frames with no flow gate at all
            # (mono_vo.cpp:525-696).
            span = int(self.state.frame_id) - 1
            # Survivor floor scales with detection capacity: tiny rigs with a
            # g x g bin grid can only ever detect ~g^2 features, so an
            # absolute 60 would wedge them in phase 1 forever.
            n_min_boot = max(24, self.N // 8)
            ready = int(n_ok) > n_min_boot and (
                med_disp > 20.0 or (span >= 8 and med_disp > 6.0)
            )
            if ready:
                self._key, sub = jax.random.split(self._key)
                self.state, ok, n_lm = self._init_bootstrap(self.state, sub)
                if bool(ok):
                    self.phase = 2
                    stats["phase"] = "bootstrapped"
                    stats["n_landmarks"] = int(n_lm)
                    stats["keyframe"] = True
                    self.kf_trajectory.append((stats["frame"], np.asarray(self.state.T_wc)))
            elif int(n_ok) <= n_min_boot:
                # Track starvation before bootstrap: re-anchor the init epoch
                # at the current frame (fresh detections, span reset). Without
                # this a failed anchor permanently wedges phase 1.
                self.state = self._first_frame(im)
                stats["phase"] = "init_reanchor"
            self.trajectory.append(np.asarray(self.state.T_wc))
            self.stats_log.append(stats)
            return np.asarray(self.state.T_wc), stats

        prev_state = self.state
        if timed:
            self.state, sc, stage_ms = self._steady_step_timed(self.state, im)
        else:
            self.state, sc = self._steady_step(self.state, im)
            stage_ms = None
        pose_ok = bool(sc["pose_ok"])
        used_fallback = False
        est_ok = pose_ok
        if not pose_ok:
            t_5p = _time.perf_counter()
            self._key, sub = jax.random.split(self._key)
            self.state, fb_ok = self._fallback_5pt(prev_state, self.state, sub)
            used_fallback = True
            est_ok = bool(fb_ok)
            if stage_ms is not None:
                jax.block_until_ready(self.state)
                stage_ms["time_5p"] = (_time.perf_counter() - t_5p) * 1e3
        recovered = 0
        if int(self.state.fail_count) >= self.cfg.motion.recover_after:
            self.state, rec_mode = self._recover(self.state)
            recovered = int(rec_mode)
        # Keyframe insertion needs a trusted pose and no recovery this frame
        # (a re-bootstrap already pushed a fresh keyframe window).
        need_kf = bool(sc["need_keyframe"]) and est_ok and recovered == 0
        ba_err = None
        n_tri = 0
        ba_rejected = False
        if need_kf:
            t_ba = _time.perf_counter()
            self.state, ba_err, n_tri, ba_acc = self._keyframe_step(self.state)
            ba_err, n_tri = float(ba_err), int(n_tri)  # sync point
            ba_rejected = not bool(ba_acc)
            if stage_ms is not None:
                stage_ms["time_ba"] = (_time.perf_counter() - t_ba) * 1e3

        T_wc = np.asarray(self.state.T_wc)
        stats = {
            # Trajectory index (matches frame_poses.txt rows + batch numbering).
            "frame": len(self.trajectory),
            "phase": "steady",
            "keyframe": need_kf,
            "n_initial": int(sc["n_initial"]),
            "n_ok_parallax": int(sc["n_ok_parallax"]),
            "n_tracked": int(sc["n_tracked"]),
            "n_gn": int(sc["n_gn"]),
            "n_inliers": int(sc["n_inliers"]),
            "n_new": int(sc["n_new"]),
            "pose_ok": pose_ok,
            "used_fallback": used_fallback,
            "fail_count": int(self.state.fail_count),
            "recovered": recovered,
            "mean_reproj_err": float(sc["mean_reproj_err"]),
            "overlap_ratio": float(sc["overlap_ratio"]),
            "steering_angle": float(sc["steering_angle"]),
            "n_pass_1p": int(sc["n_pass_1p"]),
            "avg_parallax": float(sc["avg_parallax"]),
            "avg_age": float(sc["avg_age"]),
            "ba_err": ba_err,
            "ba_rejected": ba_rejected,
            "n_triangulated": n_tri,
        }
        if stage_ms is not None:
            stats["stage_ms"] = stage_ms
        self.trajectory.append(T_wc)
        if need_kf:
            self.kf_trajectory.append((stats["frame"], T_wc))
        self.stats_log.append(stats)
        return T_wc, stats
