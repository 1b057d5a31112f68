"""Multi-chip window parallelism for the unified track-table engine.

The unified integrated system (models/smoother.py) makes sliding windows
the unit of work: each window's detection, tracking, per-motion VO, and BA
are independent of every other window's. That independence IS the
multi-chip axis — windows shard across the device mesh with NO collectives
in the compute path (the only cross-window coupling is the host-side
best-support motion install, which consumes gathered per-window outputs).

This is the production multi-chip shape for the integrated system,
complementing the segment-sharded plain-VO path (parallel/segments.py) and
the halo-exchange window-BA refinement (parallel/ba_windows.py). Frame
stacks are passed replicated here (read-only inputs; across hosts each
host feeds only the frame span its windows touch — window spans are contiguous,
so the per-device working set is span = (k_local-1)*stride + window
frames regardless of sequence length).

No reference counterpart (the reference is single-threaded on the compute
path, SURVEY.md section 2.3); design authority is BASELINE.json config 5.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.smoother import (
    SmootherConfig,
    UnifiedOutput,
    unified_solve_group,
    unified_window_starts,
)
from .segments import SEG_AXIS


@partial(jax.jit, static_argnames=("cfg", "mesh"))
def sharded_unified_scan(
    ls: jax.Array,  # (n, H, W) staged frames (uint8 or f32), replicated
    rs: jax.Array,
    base_key: jax.Array,
    cfg: SmootherConfig,
    mesh: Mesh,
) -> UnifiedOutput:
    """The whole integrated system with the WINDOW axis sharded over the
    mesh: every device builds track tables, solves VO, and runs BA for its
    own windows. Returns per-window outputs with the leading axis sharded
    (device_get composes them on the host via compose_unified).
    """
    if cfg.ba_rate > cfg.window - 1:
        raise ValueError(
            "unified engine needs ba_rate <= window-1 for full motion "
            f"coverage (got ba_rate={cfg.ba_rate}, window={cfg.window})")
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    n = int(ls.shape[0])
    starts_np = unified_window_starts(n, cfg.window, cfg.ba_rate)
    k = len(starts_np)
    if k == 0:
        raise ValueError(f"sequence of {n} frames has no windows")
    # pad the window count to a device multiple (repeat the last start; the
    # host compose deduplicates via best-support install)
    g = -(-k // n_dev)
    starts = jnp.asarray(np.concatenate(
        [starts_np, np.full(g * n_dev - k, starts_np[-1], np.int32)]
    ))
    starts = jax.device_put(starts, NamedSharding(mesh, P(axis)))

    lf = ls.astype(jnp.float32)
    rf = rs.astype(jnp.float32)

    def per_device(local_starts):  # (g,) on each device
        return unified_solve_group(lf, rf, local_starts, base_key, 0, cfg)

    fn = jax.shard_map(
        per_device,
        mesh=mesh,
        in_specs=P(axis),
        out_specs=P(axis),
        # the RANSAC/LM loop carries mix unvarying constants with
        # device-varying data (same as sharded_sequence_vo); windows are
        # independent so no cross-device values flow at all
        check_vma=False,
    )
    out = UnifiedOutput(*fn(starts))
    # drop the padding windows
    return jax.tree.map(lambda x: x[:k], out)
