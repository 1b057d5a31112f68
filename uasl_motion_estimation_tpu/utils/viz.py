"""Offline visualization: trajectory plots, feature/reprojection overlays,
covariance ellipses.

Host-side matplotlib/numpy re-design of the reference's gui module — the
interactive OpenCV windows (Graph2D raster plotter, Graph2D.h:26-90;
cv::viz Graph3D thread, Graph3D.h:27-93; live overlays, gui_utils.h:20-37)
become figure-producing functions for headless analysis, which is the only
mode that makes sense next to an accelerator job. Each function returns the
matplotlib figure (and optionally saves it) rather than opening a window.
"""

from __future__ import annotations

import numpy as np


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_trajectories(
    trajectories: dict[str, np.ndarray],
    path: str | None = None,
    plane: tuple[int, int] = (0, 2),
    title: str = "trajectory",
):
    """Top-down (x-z by default) multi-trajectory plot with per-curve path
    length — the Graph2D orthogonal-mode equivalent (Graph2D.h:54, cpp:112-142
    length accumulation).

    Args:
      trajectories: name -> (N, 3) positions or (N, 4, 4) pose arrays.
    """
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(7, 7))
    a, b = plane
    for name, arr in trajectories.items():
        pos = arr[:, :3, 3] if arr.ndim == 3 else arr
        length = float(np.linalg.norm(np.diff(pos, axis=0), axis=1).sum())
        ax.plot(pos[:, a], pos[:, b], label=f"{name} ({length:.1f} m)")
    ax.set_aspect("equal")
    ax.set_xlabel("xyz"[a] + " [m]")
    ax.set_ylabel("xyz"[b] + " [m]")
    ax.legend()
    ax.set_title(title)
    ax.grid(True, alpha=0.3)
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
    return fig


def plot_metrics(records: list[dict], path: str | None = None):
    """Per-frame metric curves (inliers, matches, reprojection error) from
    MetricsLogger JSONL records — the numeric replacement for the reference's
    live text overlays."""
    plt = _mpl()
    frames = [r.get("frame", i) for i, r in enumerate(records)]
    fig, axes = plt.subplots(3, 1, figsize=(8, 8), sharex=True)
    for ax, keys, ylabel in (
        (axes[0], ("n_matches", "n_inliers"), "count"),
        (axes[1], ("mean_reproj_error",), "px^2"),
        (axes[2], ("n_tracks",), "tracks"),
    ):
        for k in keys:
            vals = [r.get(k) for r in records]
            if any(v is not None for v in vals):
                ax.plot(frames, [v if v is not None else np.nan for v in vals],
                        label=k)
        ax.set_ylabel(ylabel)
        ax.legend(loc="upper right", fontsize=8)
        ax.grid(True, alpha=0.3)
    axes[-1].set_xlabel("frame")
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
    return fig


def draw_tracks(
    image: np.ndarray,
    uv: np.ndarray,
    valid: np.ndarray,
    depths: np.ndarray | None = None,
    path: str | None = None,
):
    """Feature overlay on a frame, depth-colored when depths are given —
    the ``show`` overloads of gui_utils.cpp:16-74."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(10, 4))
    ax.imshow(image, cmap="gray", vmin=0, vmax=255)
    sel = np.asarray(valid, bool)
    pts = np.asarray(uv)[sel]
    if depths is not None:
        sc = ax.scatter(pts[:, 0], pts[:, 1], c=np.asarray(depths)[sel],
                        s=12, cmap="turbo")
        fig.colorbar(sc, ax=ax, label="depth [m]", shrink=0.8)
    else:
        ax.scatter(pts[:, 0], pts[:, 1], s=12, c="lime")
    ax.set_axis_off()
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
    return fig


def draw_stereo_reprojection(
    left: np.ndarray,
    observed: np.ndarray,
    predicted: np.ndarray,
    valid: np.ndarray,
    path: str | None = None,
):
    """Observed-vs-predicted reprojection overlay
    (show_stereo_reproj, gui_utils.cpp:77-163)."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(10, 4))
    ax.imshow(left, cmap="gray", vmin=0, vmax=255)
    sel = np.asarray(valid, bool)
    o = np.asarray(observed)[sel]
    pr = np.asarray(predicted)[sel]
    ax.scatter(o[:, 0], o[:, 1], s=14, facecolors="none", edgecolors="lime",
               label="observed")
    ax.scatter(pr[:, 0], pr[:, 1], s=8, c="red", marker="x", label="predicted")
    for i in range(len(o)):
        ax.plot([o[i, 0], pr[i, 0]], [o[i, 1], pr[i, 1]], "y-", lw=0.5)
    ax.legend(loc="upper right")
    ax.set_axis_off()
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
    return fig


def plot_trajectory_3d(
    trajectories: dict[str, np.ndarray],
    path: str | None = None,
    title: str = "trajectory (3D)",
):
    """3D trajectory view — the headless stand-in for the reference's
    cv::viz Graph3D camera-path scene (Graph3D.h:27-93)."""
    plt = _mpl()
    fig = plt.figure(figsize=(8, 7))
    ax = fig.add_subplot(projection="3d")
    for name, arr in trajectories.items():
        pos = arr[:, :3, 3] if arr.ndim == 3 else arr
        ax.plot(pos[:, 0], pos[:, 2], -pos[:, 1], label=name)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_zlabel("-y (up) [m]")
    ax.legend()
    ax.set_title(title)
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
    return fig


def plot_joint_distribution(
    patch_a: np.ndarray,
    patch_b: np.ndarray,
    bins: int = 20,
    path: str | None = None,
):
    """Joint intensity histogram image of two patches — the debug
    visualization of the MI core (jointDistribution,
    mutual_information.cpp:88-134)."""
    plt = _mpl()
    qa = np.clip((np.asarray(patch_a).ravel() * bins / 256.0).astype(int),
                 0, bins - 1)
    qb = np.clip((np.asarray(patch_b).ravel() * bins / 256.0).astype(int),
                 0, bins - 1)
    hist = np.zeros((bins, bins))
    np.add.at(hist, (qa, qb), 1.0)
    hist /= max(hist.sum(), 1.0)
    fig, ax = plt.subplots(figsize=(5, 5))
    im = ax.imshow(hist, cmap="viridis", origin="lower")
    fig.colorbar(im, ax=ax, shrink=0.8, label="p(a, b)")
    ax.set_xlabel("intensity bin (b)")
    ax.set_ylabel("intensity bin (a)")
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
    return fig


def covariance_ellipse(cov2: np.ndarray, n_std: float = 2.4477
                       ) -> tuple[float, float, float]:
    """(width, height, angle_deg) of the 95% confidence ellipse of a 2x2
    covariance — the eigen-decomposition of display_cov
    (gui_utils.cpp:188-251). n_std=2.4477 is chi2(0.95, dof=2)."""
    vals, vecs = np.linalg.eigh(np.asarray(cov2))
    order = np.argsort(vals)[::-1]
    vals, vecs = vals[order], vecs[:, order]
    angle = float(np.degrees(np.arctan2(vecs[1, 0], vecs[0, 0])))
    width, height = (2 * n_std * np.sqrt(np.maximum(vals, 0.0))).tolist()
    return width, height, angle


def plot_covariances(
    positions: np.ndarray,
    covs: np.ndarray,
    path: str | None = None,
    plane: tuple[int, int] = (0, 2),
):
    """Trajectory with 95% position-covariance ellipses (display_cov
    equivalent for the pose chain)."""
    plt = _mpl()
    from matplotlib.patches import Ellipse

    fig, ax = plt.subplots(figsize=(7, 7))
    a, b = plane
    ax.plot(positions[:, a], positions[:, b], "b-", lw=1)
    for pos, cov in zip(positions, covs):
        sub = np.asarray(cov)[np.ix_([a, b], [a, b])]
        w, h, ang = covariance_ellipse(sub)
        ax.add_patch(Ellipse((pos[a], pos[b]), w, h, angle=ang,
                             fill=False, color="r", alpha=0.5, lw=0.8))
    ax.set_aspect("equal")
    ax.grid(True, alpha=0.3)
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
    return fig
