"""Distributed sliding-window BA: landmark-sharded Schur complement.

BASELINE.json config #5 / SURVEY.md §7 step 7 — the capability the reference
does not have. Partitioning:
  - landmark blocks (Xw, observation incidence, C/Cinv/B blocks, back-
    substitution) are sharded along the mesh 'lm' axis and never move;
  - keyframe poses + the reduced camera system (6K x 6K with K <= window+1,
    i.e. a few KB) are replicated; each GN iteration does exactly one psum of
    (S, s) over the interconnect — latency-bound, tiny payload;
  - the replicated dense solve is deterministic, so all devices step the
    poses identically with no further synchronization.

Validation contract: identical to the single-device solver up to f32
reduction order (tests assert tight agreement on an 8-device CPU mesh).
"""

from __future__ import annotations

from functools import partial

import jax
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import ba as BA
from .mesh import LM_AXIS


def _sharded_specs():
    prob_spec = BA.BAProblem(
        T_cw=P(),
        Xw=P(LM_AXIS),
        pts=P(LM_AXIS),
        mask=P(LM_AXIS),
        pts_r=P(LM_AXIS),
        mask_r=P(LM_AXIS),
        kf_valid=P(),
        lm_valid=P(LM_AXIS),
    )
    out_spec = BA.BAResult(
        T_cw=P(),
        Xw=P(LM_AXIS),
        killed=P(LM_AXIS),
        mean_err_px=P(),
        n_obs=P(),
        mean_err0_px=P(),
    )
    return prob_spec, (P(), P(), P(), P(), P()), out_spec


def make_distributed_ba(mesh: Mesh, params: BA.BAParams = BA.BAParams()):
    """Build a jitted landmark-sharded BA solve bound to `mesh`.

    Returns fn(problem, fx, fy, cx, cy, T_rl) -> BAResult. The landmark
    capacity M must be divisible by the mesh size (pad the arena; masked
    lanes are free).
    """
    prob_spec, scalar_specs, out_spec = _sharded_specs()

    def local_solve(problem, fx, fy, cx, cy, T_rl):
        return BA.ba_solve_impl(problem, fx, fy, cx, cy, T_rl, params, axis_name=LM_AXIS)

    sharded = jax.shard_map(
        local_solve,
        mesh=mesh,
        in_specs=(prob_spec, *scalar_specs),
        out_specs=out_spec,
        check_vma=False,
    )
    return jax.jit(sharded)
