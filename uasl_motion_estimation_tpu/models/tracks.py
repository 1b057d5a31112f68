"""Fixed-capacity feature-track table — the array re-design of ``WBA_Point``.

The reference tracks features across a sliding window with per-track deques
(``WBA_Point<T>``: deque of features + frame indices + 3D location + unique id,
reference: include/MotionEstimation/core/feature_types.h:122-197), grown and
popped per frame. Deques don't jit, so the array form is a static
(max_tracks, window) structure-of-arrays with masks:

* ``addMatch`` + ``pop()`` (feature_types.h:136-146) become a masked roll of
  the window axis plus a write at the newest slot;
* track birth/death becomes slot recycling via a cumsum-based assignment of
  new detections to dead slots (no data-dependent shapes, so a whole
  sequence runs under one jit compilation);
* the (M, W, 4) observation block IS the BA problem's observation table
  (solvers/ba.py) — no flattening/conversion step like the reference's
  initialiseObservations (BundleAdjuster.h:351-376).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


class TrackTable(NamedTuple):
    uv: jax.Array  # (M, W, 4) [ul, vl, ur, vr] per window frame
    obs_mask: jax.Array  # (M, W) bool
    active: jax.Array  # (M,) bool
    track_id: jax.Array  # (M,) int32 unique ids (WBA_Point::m_id)
    pt3d: jax.Array  # (M, 3) camera/world 3D estimate
    pt3d_valid: jax.Array  # (M,) bool
    next_id: jax.Array  # () int32
    n_frames: jax.Array  # () int32 frames pushed so far (window fill level)

    @property
    def capacity(self) -> int:
        return self.uv.shape[0]

    @property
    def window(self) -> int:
        return self.uv.shape[1]


def empty_table(max_tracks: int, window: int, dtype=jnp.float32) -> TrackTable:
    """Fresh table (capacity mirrors TrackingInfo.nb_feats/window_size,
    file_IO.h:69-73)."""
    return TrackTable(
        uv=jnp.zeros((max_tracks, window, 4), dtype),
        obs_mask=jnp.zeros((max_tracks, window), bool),
        active=jnp.zeros(max_tracks, bool),
        track_id=jnp.full(max_tracks, -1, jnp.int32),
        pt3d=jnp.zeros((max_tracks, 3), dtype),
        pt3d_valid=jnp.zeros(max_tracks, bool),
        next_id=jnp.asarray(0, jnp.int32),
        n_frames=jnp.asarray(0, jnp.int32),
    )


@jax.jit
def advance(
    table: TrackTable,
    tracked_uv: jax.Array,
    tracked_ok: jax.Array,
    new_uv: jax.Array,
    new_ok: jax.Array,
) -> TrackTable:
    """Push one frame: update surviving tracks, recycle dead slots with new
    detections.

    Args:
      tracked_uv: (M, 4) this frame's [ul, vl, ur, vr] for each slot (from
        KLT + stereo matching of the slot's previous feature).
      tracked_ok: (M,) tracking/matching success per slot.
      new_uv: (K, 4) fresh detections (K <= M).
      new_ok: (K,) validity of fresh detections.

    Semantics per slot:
      * active & tracked_ok -> window rolls (oldest popped once full,
        WBA_Point::pop, feature_types.h:142), newest slot = tracked_uv;
      * active & ~tracked_ok -> track dies (reference consumers drop
        lost tracks);
      * dead slots are filled by the first valid new detections, starting a
        1-observation window with a fresh id.
    """
    m, w = table.uv.shape[0], table.uv.shape[1]
    dtype = table.uv.dtype

    survives = table.active & tracked_ok

    # roll the window left by one (evict oldest) once the window is full;
    # before that, append at slot n_frames_in_track. A track's fill level is
    # its obs count; rolling a partially-filled window is also correct if we
    # always append at the last slot and keep obs right-aligned.
    uv_rolled = jnp.roll(table.uv, -1, axis=1).at[:, -1, :].set(tracked_uv)
    mask_rolled = jnp.roll(table.obs_mask, -1, axis=1).at[:, -1].set(True)

    uv_after = jnp.where(survives[:, None, None], uv_rolled, 0.0)
    mask_after = jnp.where(survives[:, None], mask_rolled, False)

    # --- recycle dead slots with new detections ---
    dead = ~survives
    # rank of each dead slot among dead slots (0-based)
    dead_rank = jnp.cumsum(dead.astype(jnp.int32)) - 1
    k = new_uv.shape[0]
    # valid new detections, packed: rank of each valid detection
    new_rank = jnp.cumsum(new_ok.astype(jnp.int32)) - 1
    # detection j fills the dead slot whose rank equals new_rank[j]:
    # first invert dead ranks to slot indices, then route detections
    dead_slot_by_rank = jnp.full(m, m, jnp.int32).at[
        jnp.where(dead, dead_rank, m)
    ].set(jnp.arange(m, dtype=jnp.int32), mode="drop")
    target_slot = jnp.where(new_ok, dead_slot_by_rank[jnp.clip(new_rank, 0, m - 1)], m)

    filled = jnp.zeros(m, bool).at[target_slot].set(new_ok, mode="drop")
    fill_uv = jnp.zeros((m, 4), dtype).at[target_slot].set(new_uv, mode="drop")
    new_ids = table.next_id + new_rank
    fill_id = jnp.full(m, -1, jnp.int32).at[target_slot].set(
        jnp.where(new_ok, new_ids, -1), mode="drop"
    )
    n_new = jnp.sum(new_ok.astype(jnp.int32))

    uv_final = jnp.where(
        filled[:, None, None],
        jnp.zeros((m, w, 4), dtype).at[:, -1, :].set(fill_uv),
        uv_after,
    )
    mask_final = jnp.where(
        filled[:, None],
        jnp.zeros((m, w), bool).at[:, -1].set(True),
        mask_after,
    )
    active_final = survives | filled
    id_final = jnp.where(filled, fill_id, jnp.where(survives, table.track_id, -1))

    return TrackTable(
        uv=uv_final,
        obs_mask=mask_final,
        active=active_final,
        track_id=id_final,
        pt3d=jnp.where(filled[:, None], 0.0, table.pt3d),
        pt3d_valid=jnp.where(filled, False, table.pt3d_valid & survives),
        next_id=table.next_id + n_new,
        n_frames=table.n_frames + 1,
    )


def latest_uv(table: TrackTable) -> tuple[jax.Array, jax.Array]:
    """(M, 4) newest observation per track + (M,) validity."""
    return table.uv[:, -1, :], table.active & table.obs_mask[:, -1]


def track_lengths(table: TrackTable) -> jax.Array:
    """(M,) number of observations in the window per track
    (WBA_Point::getNbFeatures, feature_types.h:150)."""
    return jnp.sum(table.obs_mask, axis=1)


@partial(jax.jit, static_argnames=("min_obs",))
def ba_window_view(table: TrackTable, min_obs: int = 2
                   ) -> tuple[jax.Array, jax.Array]:
    """(W, M, 4) observations + (W, M) mask for solvers.ba.BAProblem,
    keeping only tracks with >= min_obs observations."""
    keep = (track_lengths(table) >= min_obs) & table.active
    obs = jnp.swapaxes(table.uv, 0, 1)  # (W, M, 4)
    mask = jnp.swapaxes(table.obs_mask, 0, 1) & keep[None, :]
    return obs, mask
