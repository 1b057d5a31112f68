"""Checkpoint/resume of a running odometry session.

The reference has no persistence — its only "resume" is starting mid-sequence
via FrameInfo.fframe (reference: include/MotionEstimation/core/file_IO.h:42-64
and the ImageReader seek loop, file_IO.h:319-322) plus keyboard pause/resume
(IOSigHandler, file_IO.h:159-182). This module gives the real thing the
survey calls for (SURVEY.md section 5, checkpoint/resume): the full session
state — pose chain, keyframe anchor, active track table, BA window, RNG key,
frame index — keyed by frame number, so a run can stop and restart
bit-exactly. Which fields make up the state is ``OdometrySystem``'s
business (``get_state`` / ``set_state``); this module only stores them.

Plain .npz on purpose: the state is a few MB of arrays, and a dependency-free
format stays readable from any tool.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

FORMAT_VERSION = 2


def save_checkpoint(path: str, system) -> None:
    """Serialize an OdometrySystem (models/odometry.py) to ``path`` (.npz)."""
    arrays = system.get_state()
    meta = {"version": FORMAT_VERSION}
    arrays["meta"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8
    ).copy()
    np.savez_compressed(path, **arrays)


def load_checkpoint(path: str, system) -> None:
    """Restore state saved by save_checkpoint into ``system`` (in place)."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(bytes(data["meta"]).decode())
        if meta["version"] != FORMAT_VERSION:
            raise ValueError(f"checkpoint version {meta['version']} unsupported")
        system.set_state({k: data[k] for k in data.files if k != "meta"})


def checkpoint_every(system, directory: str, every: int = 50) -> str | None:
    """Convenience: checkpoint keyed by frame number every ``every`` frames.

    Returns the written path, or None if no checkpoint was due."""
    if system.frame_idx == 0 or system.frame_idx % every:
        return None
    Path(directory).mkdir(parents=True, exist_ok=True)
    path = str(Path(directory) / f"ckpt_{system.frame_idx:08d}.npz")
    save_checkpoint(path, system)
    return path
