"""Cross-device window-parallel BA with fixed-frame halo exchange.

The reference anchors each BA window by holding its first ``fixedFrames``
camera blocks constant (SetParameterBlockConstant,
include/MotionEstimation/optimisation/BundleAdjuster.h:406-407,452-453); in a
single-process pipeline the anchors come from the previous window's solution,
which serializes the windows. Here the same anchoring becomes the
CONSISTENCY mechanism between concurrently-solved windows (SURVEY.md
section 2.3):

* consecutive windows overlap by ``n_fixed`` frames (window i's last
  ``n_fixed`` frames are window i+1's first ``n_fixed`` frames);
* every window solves in parallel (vmap within a device, shard_map across
  the mesh) with its head frames fixed;
* after each solve, every window sends its refined tail poses to its right
  neighbor — `jnp.roll` inside a device, one `ppermute` hop across the
  device boundary — which installs them as its new fixed head;
* repeat for ``n_sweeps`` block-Gauss-Seidel sweeps. Window 0 keeps its own
  head throughout: it carries the global gauge.

Each sweep propagates corrections one window to the right, so ``n_sweeps``
bounds the coupling range; for VO-scale windows 2-3 sweeps reach agreement
to solver tolerance (tests/test_parallel_ba.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..solvers.ba import BAConfig, BAProblem, BAResult, ba_solve

SEG_AXIS = "seg"


def _sweep_body(problem: BAProblem, cfg: BAConfig, axis_name: str,
                n_sweeps: int) -> BAResult:
    """Runs on one device: local windows (k, W, ...) + halo exchange."""
    n_fixed = cfg.n_fixed
    idx = jax.lax.axis_index(axis_name)
    n_dev = jax.lax.axis_size(axis_name)
    k = problem.cam.shape[0]  # local windows per device

    def solve(cams, pts):
        return jax.vmap(
            lambda c, p, o, m: ba_solve(BAProblem(c, p, o, m), cfg)
        )(cams, pts, problem.obs, problem.mask)

    def one_sweep(carry, _):
        cams, pts = carry
        res = solve(cams, pts)
        # tails of every local window (k, n_fixed, 6)
        tails = res.cam[:, -n_fixed:, :]
        # within-device shift: window j's head <- window j-1's tail
        heads_new = jnp.roll(tails, 1, axis=0)
        # across the device boundary: local window 0's head <- the LEFT
        # device's LAST window tail (one ppermute hop)
        from_left = jax.lax.ppermute(
            tails[-1], axis_name,
            perm=[(d, d + 1) for d in range(n_dev - 1)],
        )
        heads_new = heads_new.at[0].set(from_left)
        # the global first window keeps its own head: it IS the gauge
        win_global = idx * k + jnp.arange(k)
        keep_own = (win_global == 0)[:, None, None]
        heads = jnp.where(keep_own, res.cam[:, :n_fixed, :], heads_new)
        cams_next = res.cam.at[:, :n_fixed, :].set(heads)
        return (cams_next, res.pts), res.cost

    (cams, pts), costs = jax.lax.scan(
        one_sweep, (problem.cam, problem.pts), None, length=n_sweeps
    )
    # final solve so the returned windows are optimal under the last anchors
    res = solve(cams, pts)
    return res


@partial(jax.jit, static_argnames=("cfg", "mesh", "n_sweeps"))
def window_parallel_ba(
    problem: BAProblem,
    cfg: BAConfig,
    mesh: Mesh,
    n_sweeps: int = 2,
) -> BAResult:
    """Solve a batch of overlapping BA windows consistently across a mesh.

    Args:
      problem: batched BAProblem with leading window axis (n_windows, ...);
        n_windows must be divisible by the mesh size. Consecutive windows
        must share their ``cfg.n_fixed`` boundary frames.
      cfg: BAConfig; ``n_fixed`` doubles as the overlap width.
      mesh: 1-D device mesh; windows are sharded over its axis.
      n_sweeps: halo-exchange sweeps before the final solve.

    Returns a batched BAResult whose shared boundary frames agree between
    neighboring windows (left neighbor's tail == right neighbor's fixed
    head) by construction.
    """
    axis_name = mesh.axis_names[0]
    fn = jax.shard_map(
        partial(_sweep_body, cfg=cfg, axis_name=axis_name, n_sweeps=n_sweeps),
        mesh=mesh,
        in_specs=P(axis_name),
        out_specs=P(axis_name),
        check_vma=False,
    )
    return fn(problem)


def shard_windows(problem: BAProblem, mesh: Mesh,
                  axis_name: str = SEG_AXIS) -> BAProblem:
    """Place the window axis of a batched BAProblem over the mesh."""
    def put(x):
        spec = P(axis_name, *([None] * (x.ndim - 1)))
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree.map(put, problem)
