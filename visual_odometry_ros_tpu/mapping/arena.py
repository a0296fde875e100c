"""Fixed-capacity map state: landmark arena, track state, keyframe ring.

Capability parity with the reference map data model (L2):
  - `Landmark` (core/visual_odometry/landmark.{h,cpp}): 3D point, alive/
    tracked/triangulated/bundled flags, age, incremental min/max/avg/last
    parallax statistics (landmark.cpp:107-134).
  - `LandmarkTracking` (landmark.cpp:185-270): the SoA batch of per-frame
    correspondences — here a fixed-capacity `TrackState` whose mask-filter
    "compaction" is just `valid &= mask` (no reallocation, no pointers).
  - `Keyframes` sliding window (keyframes.{h,cpp}): ring buffer of keyframe
    slots with per-slot observation tables; `checkUpdateRule`
    (keyframes.cpp:47-125) is computed as scalars inside jit.

Batched design: `shared_ptr` graphs become integer slot indices into static-shape
arrays; every mutation is a masked scatter. Free-slot allocation is a cumsum
ranking (SURVEY.md §7 'slot-allocation into the fixed arena').
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class LandmarkArena(NamedTuple):
    """Global landmark store; capacity M is static."""

    Xw: jax.Array  # [M, 3] world position
    alive: jax.Array  # [M] bool
    tracked: jax.Array  # [M] bool — tracked into the current frame
    triangulated: jax.Array  # [M] bool — Xw is valid
    bundled: jax.Array  # [M] bool — touched by BA at least once
    age: jax.Array  # [M] int32 — #frames observed
    last_pt: jax.Array  # [M, 2] most recent pixel observation
    inv_depth: jax.Array  # [M] depth-filter state: inverse-RANGE mean along ray_d
    inv_depth_var: jax.Array  # [M] depth-filter state: variance
    df_a: jax.Array  # [M] Beta-distribution inlier count (depth filter)
    df_b: jax.Array  # [M] Beta-distribution outlier count
    ray_o: jax.Array  # [M, 3] birth camera center (world) — depth-seed anchor
    ray_d: jax.Array  # [M, 3] unit world ray through the birth pixel
    parallax_last: jax.Array  # [M] rad
    parallax_max: jax.Array  # [M] rad
    parallax_min: jax.Array  # [M] rad (1e9 until first sample; landmark.cpp:126-127)
    parallax_sum: jax.Array  # [M] rad — running sum; avg = sum / parallax_n
    parallax_n: jax.Array  # [M] int32 — #parallax samples (landmark.cpp:129-132)
    desc: jax.Array  # [M, 32] int32 bytes — 256-bit rotated-BRIEF at birth (reloc)
    # (byte values are f32-exact so the one-hot-einsum scatter path works —
    # packed uint32 words would be corrupted by the float contraction.)
    desc_valid: jax.Array  # [M] bool

    @property
    def capacity(self) -> int:
        return self.Xw.shape[0]


PARALLAX_MIN_INIT = 1e9  # sentinel before the first parallax sample


def make_arena(capacity: int) -> LandmarkArena:
    z1 = jnp.zeros((capacity,), jnp.float32)
    return LandmarkArena(
        Xw=jnp.zeros((capacity, 3), jnp.float32),
        alive=jnp.zeros((capacity,), bool),
        tracked=jnp.zeros((capacity,), bool),
        triangulated=jnp.zeros((capacity,), bool),
        bundled=jnp.zeros((capacity,), bool),
        age=jnp.zeros((capacity,), jnp.int32),
        last_pt=jnp.zeros((capacity, 2), jnp.float32),
        inv_depth=z1,
        inv_depth_var=z1,
        df_a=z1,
        df_b=z1,
        ray_o=jnp.zeros((capacity, 3), jnp.float32),
        ray_d=jnp.zeros((capacity, 3), jnp.float32),
        parallax_last=z1,
        parallax_max=z1,
        parallax_min=jnp.full((capacity,), PARALLAX_MIN_INIT, jnp.float32),
        parallax_sum=z1,
        parallax_n=jnp.zeros((capacity,), jnp.int32),
        desc=jnp.zeros((capacity, 32), jnp.int32),
        desc_valid=jnp.zeros((capacity,), bool),
    )


def parallax_observe(arena: LandmarkArena, lm_idx, mask, par):
    """Record one rotation-compensated parallax sample per masked lane —
    last/max/min/avg bookkeeping of Landmark::addObservationAndRelatedFrame
    (landmark.cpp:107-134), batched over the whole track table."""
    new_last = onehot_update(arena.parallax_last, lm_idx, mask, par)
    hit = onehot_update(jnp.zeros((arena.capacity,), bool), lm_idx, mask, op="or")
    return arena._replace(
        parallax_last=new_last,
        parallax_max=jnp.where(hit, jnp.maximum(arena.parallax_max, new_last), arena.parallax_max),
        parallax_min=jnp.where(hit, jnp.minimum(arena.parallax_min, new_last), arena.parallax_min),
        parallax_sum=jnp.where(hit, arena.parallax_sum + new_last, arena.parallax_sum),
        parallax_n=arena.parallax_n + hit.astype(jnp.int32),
    )


def landmark_stat_means(arena: LandmarkArena):
    """Per-frame aggregates over currently-tracked landmarks for the
    statistics record (statisticsStamped.msg avg_parallax/avg_age)."""
    sel = arena.alive & arena.tracked
    n = jnp.maximum(jnp.sum(sel), 1)
    avg_age = jnp.sum(jnp.where(sel, arena.age, 0)) / n
    per_lm_avg = arena.parallax_sum / jnp.maximum(arena.parallax_n, 1)
    avg_parallax = jnp.sum(jnp.where(sel, per_lm_avg, 0.0)) / n
    return avg_parallax, avg_age.astype(jnp.float32)


class TrackState(NamedTuple):
    """Per-frame active tracks; capacity N is static (LandmarkTracking analog)."""

    pts: jax.Array  # [N, 2] pixel position in the current frame
    lm_idx: jax.Array  # [N] int32 arena slot (undefined where ~valid)
    valid: jax.Array  # [N] bool
    scale: jax.Array  # [N] patch-scale prior (depth ratio)

    @property
    def capacity(self) -> int:
        return self.pts.shape[0]


def make_tracks(capacity: int) -> TrackState:
    return TrackState(
        pts=jnp.zeros((capacity, 2), jnp.float32),
        lm_idx=jnp.full((capacity,), -1, jnp.int32),
        valid=jnp.zeros((capacity,), bool),
        scale=jnp.ones((capacity,), jnp.float32),
    )


class KeyframeRing(NamedTuple):
    """Sliding keyframe window; capacity K static. Slot `head` is newest."""

    T_cw: jax.Array  # [K, 4, 4]
    valid: jax.Array  # [K] bool
    frame_id: jax.Array  # [K] int32
    pts: jax.Array  # [K, N, 2] feature pixels at this KF (left cam)
    pts_r: jax.Array  # [K, N, 2] right-cam pixels (stereo; zeros in mono)
    lm_idx: jax.Array  # [K, N] int32 arena slots
    obs_valid: jax.Array  # [K, N]
    obs_valid_r: jax.Array  # [K, N]
    head: jax.Array  # [] int32 — index of newest keyframe slot
    count: jax.Array  # [] int32 — number of live keyframes

    @property
    def capacity(self) -> int:
        return self.T_cw.shape[0]


def make_ring(K: int, N: int) -> KeyframeRing:
    return KeyframeRing(
        T_cw=jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (K, 4, 4)),
        valid=jnp.zeros((K,), bool),
        frame_id=jnp.full((K,), -1, jnp.int32),
        pts=jnp.zeros((K, N, 2), jnp.float32),
        pts_r=jnp.zeros((K, N, 2), jnp.float32),
        lm_idx=jnp.full((K, N), -1, jnp.int32),
        obs_valid=jnp.zeros((K, N), bool),
        obs_valid_r=jnp.zeros((K, N), bool),
        head=jnp.asarray(-1, jnp.int32),
        count=jnp.asarray(0, jnp.int32),
    )


def onehot_update(dest: jax.Array, idx: jax.Array, mask: jax.Array, vals=None, op: str = "set"):
    """Masked scatter with UNIQUE indices, expressed as one-hot contraction.

    dest: [M] or [M, D]; idx: [n] int32; mask: [n] bool (False lanes ignored).
    op in {"set", "or", "add", "max"}. The one-hot form keeps every update
    a fused contraction with no scatter in the graph; whether unique-index
    scatters are faster on the GPU is an open measurement. Requires idx
    unique among masked lanes (slot allocations guarantee this).
    """
    M = dest.shape[0]
    oh = (idx[:, None] == jnp.arange(M, dtype=idx.dtype)[None, :]) & mask[:, None]  # [n, M]
    hit = jnp.any(oh, axis=0)
    if op == "or":
        return dest | hit
    ohf = oh.astype(jnp.float32)
    if vals.ndim == 1:
        scat = jnp.einsum("nm,n->m", ohf, vals.astype(jnp.float32))
    else:
        scat = jnp.einsum("nm,nd->md", ohf, vals.astype(jnp.float32))
    scat = scat.astype(dest.dtype)
    if op == "add":
        return dest + scat
    hit_b = hit if dest.ndim == 1 else hit[:, None]
    if op == "max":
        return jnp.where(hit_b, jnp.maximum(dest, scat), dest)
    return jnp.where(hit_b, scat, dest)  # set


def allocate_slots(free: jax.Array, n_request: int):
    """Assign the first `n_request` free slots (cumsum ranking, jit-static).

    free: [M] bool. Returns (slots [n_request] int32, ok [n_request] bool).
    slot j = index of the (j+1)-th free lane; ok=False when fewer free lanes
    exist than requested.
    """
    M = free.shape[0]
    rank = jnp.cumsum(free.astype(jnp.int32)) - 1  # rank among free slots
    # Scatter-free inverse permutation: rank r -> slot index, via one-hot
    # argmax (see onehot_update).
    oh = (rank[None, :] == jnp.arange(n_request, dtype=jnp.int32)[:, None]) & free[None, :]
    slot_of_rank = jnp.argmax(oh, axis=1).astype(jnp.int32)
    n_free = jnp.sum(free.astype(jnp.int32))
    ok = jnp.arange(n_request) < n_free
    return slot_of_rank, ok


def ring_push(ring: KeyframeRing, T_cw, frame_id, pts, pts_r, lm_idx, obs_valid, obs_valid_r):
    """Insert a keyframe at the next ring slot (evicting the oldest when full).

    Matches Keyframes::addNewKeyframe's pop-oldest behavior (keyframes.cpp:30-45)
    with a circular index instead of list surgery.
    """
    K = ring.capacity
    slot = (ring.head + 1) % K
    return ring._replace(
        T_cw=ring.T_cw.at[slot].set(T_cw),
        valid=ring.valid.at[slot].set(True),
        frame_id=ring.frame_id.at[slot].set(frame_id),
        pts=ring.pts.at[slot].set(pts),
        pts_r=ring.pts_r.at[slot].set(pts_r),
        lm_idx=ring.lm_idx.at[slot].set(lm_idx),
        obs_valid=ring.obs_valid.at[slot].set(obs_valid),
        obs_valid_r=ring.obs_valid_r.at[slot].set(obs_valid_r),
        head=slot,
        count=jnp.minimum(ring.count + 1, K),
    )


def ring_order(ring: KeyframeRing) -> jax.Array:
    """[K] slot indices oldest -> newest among live slots (dead slots last)."""
    K = ring.capacity
    offs = jnp.arange(K, dtype=jnp.int32)
    # newest = head, oldest = head - (count-1)
    idx = (ring.head - (ring.count - 1) + offs) % K
    return idx


def gather_ba_problem(ring: KeyframeRing, arena: LandmarkArena, M_cap: int | None = None):
    """Scatter the ring's per-KF observation tables into the dense [M, K]
    incidence the BA solver consumes (SparseBAParameters analog).

    Keyframe axis is ordered oldest->newest so BA's n_fix applies to the
    oldest window poses. Returns (BAProblem fields as a dict) — the caller
    assembles the final BAProblem with the arena's Xw.
    """
    K = ring.capacity
    M = arena.capacity if M_cap is None else M_cap
    order = ring_order(ring)
    T_cw = ring.T_cw[order]
    kf_valid = ring.valid[order]

    lm = ring.lm_idx[order]  # [K, N]
    ov = ring.obs_valid[order] & kf_valid[:, None]
    ovr = ring.obs_valid_r[order] & kf_valid[:, None]
    pts_o = ring.pts[order]
    pts_r_o = ring.pts_r[order]

    # Scatter-free build: per keyframe one [N, M] one-hot contraction (lane
    # indices are unique within a KF), as in onehot_update.
    arange_m = jnp.arange(M, dtype=lm.dtype)
    pts_cols, mask_cols, pts_r_cols, mask_r_cols = [], [], [], []
    for k in range(K):
        oh_l = (lm[k][:, None] == arange_m[None, :]) & ov[k][:, None]  # [N, M]
        oh_r = (lm[k][:, None] == arange_m[None, :]) & ovr[k][:, None]
        mask_cols.append(jnp.any(oh_l, axis=0))
        mask_r_cols.append(jnp.any(oh_r, axis=0))
        pts_cols.append(jnp.einsum("nm,nd->md", oh_l.astype(jnp.float32), pts_o[k]))
        pts_r_cols.append(jnp.einsum("nm,nd->md", oh_r.astype(jnp.float32), pts_r_o[k]))
    pts_mk = jnp.stack(pts_cols, axis=1)  # [M, K, 2]
    pts_r_mk = jnp.stack(pts_r_cols, axis=1)
    mask_mk = jnp.stack(mask_cols, axis=1)  # [M, K]
    mask_r_mk = jnp.stack(mask_r_cols, axis=1)

    return dict(
        T_cw=T_cw,
        pts=pts_mk,
        mask=mask_mk,
        pts_r=pts_r_mk,
        mask_r=mask_r_mk,
        kf_valid=kf_valid,
        lm_valid=arena.alive & arena.triangulated,
    )
