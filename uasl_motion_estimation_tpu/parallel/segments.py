"""Multi-chip sequence sharding: segment-parallel VO + parallel pose chaining.

The reference is strictly single-process/single-threaded on its compute path
(SURVEY.md section 2.3; its only dependencies are OpenCV/Eigen/Ceres,
CMakeLists.txt:10-12), so this layer has no reference counterpart — it is the
framework's multi-device scaling story, per BASELINE.json config 5:

* a video sequence is split into contiguous segments, one per device of a
  ``jax.sharding.Mesh`` axis ("seg");
* every device runs the per-frame front-end + 6-DoF solve for its segment
  independently (the per-frame problems only couple through the pose chain);
* the sequential pose-chain recurrence pose_i = pose_{i-1} @ inv(motion_i) is
  computed as an associative prefix-product scan: local `lax.associative_scan`
  per device, then one `all_gather` of per-segment totals and a prefix
  correction — O(log) collectives instead of an O(N) serial chain.

Everything runs under `shard_map`, so the same code path compiles for the
virtual-device CPU mesh used in tests and for a host of GPUs.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models import frontend as fe
from ..models.stereo_vo import StereoVOParams, stereo_vo_solve

SEG_AXIS = "seg"


def make_mesh(n_devices: int | None = None, axis_name: str = SEG_AXIS,
              devices: list | None = None) -> Mesh:
    """1-D device mesh over the sequence-segment axis, on the first
    ``n_devices`` (default: all) of ``devices`` (default: the default
    backend's). Raises when there are fewer devices than asked for."""
    devs = devices if devices is not None else jax.devices()
    n = len(devs) if n_devices is None else n_devices
    if len(devs) < n:
        raise ValueError(f"need {n} devices, have {len(devs)}")
    return Mesh(np.array(devs[:n]), (axis_name,))


def _compose(a: jax.Array, b: jax.Array) -> jax.Array:
    """Associative pose-chain combine: earlier @ later (order-preserving).

    Full f32 products: at a TF32 default (the H100's for f32 matmuls) the
    chained 4x4 products drift by ~1e-3 relative, millimetres over a
    10 m segment, and differently for each association order."""
    return jnp.einsum("...ij,...jk->...ik", a, b, precision="highest")


def chain_motions(motions: jax.Array) -> jax.Array:
    """(B, 4, 4) frame-to-frame motions -> (B, 4, 4) cam-to-world poses.

    ``motions[i]`` maps frame-i points into frame i+1 (the reference's Rt from
    getMotion, StereoVisualOdometry.cpp:331-342); the accumulated pose is the
    inclusive prefix product of the inverses, evaluated as a parallel scan
    instead of the consumer's serial pose loop (SURVEY.md section 3.5).
    """
    inv = jnp.linalg.inv(motions)
    return jax.lax.associative_scan(_compose, inv, axis=0)


def _sharded_chain_body(inv_local: jax.Array, axis_name: str) -> jax.Array:
    """Inside shard_map: local scan + cross-device prefix correction."""
    local = jax.lax.associative_scan(_compose, inv_local, axis=0)
    totals = jax.lax.all_gather(local[-1], axis_name)  # (n_seg, 4, 4)
    idx = jax.lax.axis_index(axis_name)

    # prefix product of totals strictly before this segment
    def step(carry, t):
        return _compose(carry, t), carry

    eye = jax.lax.pcast(jnp.eye(4, dtype=inv_local.dtype), to="varying",
                        axis_name=axis_name)
    _, prefixes = jax.lax.scan(step, eye, totals)
    return _compose(prefixes[idx][None], local)


def sharded_chain_motions(motions: jax.Array, mesh: Mesh,
                          axis_name: str = SEG_AXIS) -> jax.Array:
    """`chain_motions` with the frame axis sharded over ``mesh``."""
    fn = jax.shard_map(
        partial(_sharded_chain_body, axis_name=axis_name),
        mesh=mesh,
        in_specs=P(axis_name),
        out_specs=P(axis_name),
    )
    return fn(jnp.linalg.inv(motions))


@partial(jax.jit, static_argnames=("cfg", "mesh"))
def sharded_sequence_vo(
    prev_left: jax.Array,
    prev_right: jax.Array,
    cur_left: jax.Array,
    cur_right: jax.Array,
    keys: jax.Array,
    cfg,
    mesh: Mesh,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Full sharded sequence step: front-end + VO per frame pair + pose chain.

    Args:
      prev_/cur_left/right: (B, H, W) stacked frame pairs, frame i of the
        sequence paired with frame i+1 (host builds the 1-frame halo by
        stacking overlapping views; images are read-only so the duplication
        costs one HBM copy, not a collective).
      keys: (B,) PRNG keys for RANSAC.
      cfg: models.pipeline.PipelineConfig (static).
      mesh: 1-D mesh whose axis shards the frame/batch dimension.

    Returns (poses (B, 4, 4) cam-to-world relative to frame 0, success (B,),
    n_inliers (B,), motion_cov (B, 6, 6) per-motion covariance on the
    [dt, dtheta] tangent — failed frames carry the large-diagonal
    uninformative covariance, see StereoVOResult.cov).
    """
    from ..models.pipeline import vo_step  # local import to avoid cycle

    axis_name = mesh.axis_names[0]

    def per_segment(pl, pr, cl, cr, ks):
        out = jax.vmap(lambda a, b, c, d, k: vo_step(a, b, c, d, k, cfg))(
            pl, pr, cl, cr, ks
        )
        # failed frames contribute identity motion (degraded-frame contract)
        eye = jnp.eye(4, dtype=out.motion.dtype)
        motion = jnp.where(out.success[:, None, None], out.motion, eye)
        poses = _sharded_chain_body(jnp.linalg.inv(motion), axis_name)
        return poses, out.success, out.n_inliers, out.cov

    fn = jax.shard_map(
        per_segment,
        mesh=mesh,
        in_specs=(P(axis_name), P(axis_name), P(axis_name), P(axis_name),
                  P(axis_name)),
        out_specs=(P(axis_name), P(axis_name), P(axis_name), P(axis_name)),
        # the solver's loop carries mix unvarying constants (init state) with
        # device-varying data, which the VMA type check rejects; correctness
        # here only needs the explicit all_gather in the chain scan
        check_vma=False,
    )
    return fn(prev_left, prev_right, cur_left, cur_right, keys)


def shard_frames(frames: jax.Array, mesh: Mesh, axis_name: str = SEG_AXIS
                 ) -> jax.Array:
    """Place a (B, ...) array with the leading axis sharded over the mesh."""
    spec = P(axis_name, *([None] * (frames.ndim - 1)))
    return jax.device_put(frames, NamedSharding(mesh, spec))
