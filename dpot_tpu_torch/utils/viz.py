"""Visualization of trajectories and rollouts (a copy of the JAX package's
dpot_tpu/utils/viz.py, which is numpy + matplotlib; the port keeps its own).

Counterpart of the reference's data_generation plotting scripts: field
snapshots (visualize_data.py:26-48), per-channel time grids, histograms
and macro-statistic bars (cfdbench/vis_data.py:19-62, pdearena/vis_data.py,
ns2d/visualize_ns2d.py), 3D volume rendering (visualize_3d.py:16-37), plus
prediction-vs-target rollout comparisons and a GIF of the rollout, which
`save_eval_viz` writes for the evaluator and the train loop (`viz_dir`).
matplotlib is optional and imported only when a function draws (`_plt`):
where it is absent, each function prints a message and writes nothing
(False, or an empty list). Everything renders on the Agg backend.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _plt():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except Exception:
        return None


def plot_trajectory(
    traj: np.ndarray,
    path: str,
    channel: int = 0,
    times: Optional[Sequence[int]] = None,
    title: str = "",
) -> bool:
    """traj: (H, W, T, C) -> grid of snapshots."""
    plt = _plt()
    if plt is None:
        print("viz: matplotlib unavailable, skipping", path)
        return False
    traj = np.asarray(traj)
    T = traj.shape[-2]
    times = list(times if times is not None else np.linspace(0, T - 1, min(T, 6)).astype(int))
    fig, axes = plt.subplots(1, len(times), figsize=(3 * len(times), 3))
    if len(times) == 1:
        axes = [axes]
    for ax, t in zip(axes, times):
        im = ax.imshow(traj[..., t, channel], cmap="RdBu_r")
        ax.set_title(f"t={t}")
        ax.axis("off")
        fig.colorbar(im, ax=ax, fraction=0.046)
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return True


def plot_snapshots(
    traj: np.ndarray,
    path_prefix: str,
    channel: int = 0,
    start_idx: int = 0,
    n_frames: int = 3,
    cmap: str = "plasma",
    zoom_to: int = 0,
) -> list[str]:
    """Single-frame borderless snapshot export — the reference's
    visualize_data.py:26-48 behavior (one PNG per frame, axis off,
    tight bbox, cubic zoom to a target res when the grid is smaller).
    traj: (H, W, T, C). Returns the written paths."""
    plt = _plt()
    if plt is None:
        print("viz: matplotlib unavailable, skipping", path_prefix)
        return []
    traj = np.asarray(traj)
    paths = []
    for i in range(n_frames):
        t = min(start_idx + i, traj.shape[-2] - 1)
        x = traj[..., t, channel]
        if zoom_to and x.shape[0] < zoom_to:
            try:
                import scipy.ndimage

                x = scipy.ndimage.zoom(
                    x, (zoom_to / x.shape[0], zoom_to / x.shape[1]), order=3
                )
            except ImportError:
                pass  # plot at native res
        fig = plt.figure()
        plt.imshow(x, cmap=cmap)
        plt.axis("off")
        p = f"{path_prefix}_{t}.png"
        fig.savefig(p, bbox_inches="tight", pad_inches=0)
        plt.close(fig)
        paths.append(p)
    return paths


def plot_channels(
    traj: np.ndarray,
    path_prefix: str,
    channel_names: Optional[Sequence[str]] = None,
    cmap: str = "viridis",
    max_steps: int = 20,
) -> list[str]:
    """Per-channel 4x5 time-step grid, one PNG per channel — the
    reference's visualize_channels (cfdbench/vis_data.py:19-34; identical
    in pdearena/vis_data.py and ns2d/visualize_ns2d.py). traj: (H,W,T,C)."""
    plt = _plt()
    if plt is None:
        print("viz: matplotlib unavailable, skipping", path_prefix)
        return []
    traj = np.asarray(traj)
    C, T = traj.shape[-1], traj.shape[-2]
    paths = []
    for c in range(C):
        name = (
            channel_names[c]
            if channel_names and c < len(channel_names)
            else f"channel {c}"
        )
        fig, axs = plt.subplots(4, 5, figsize=(20, 16))
        im = None
        for i in range(4):
            for j in range(5):
                t = i * 5 + j
                axs[i, j].axis("off")
                if t < min(T, max_steps):
                    im = axs[i, j].imshow(traj[:, :, t, c], cmap=cmap)
                    axs[i, j].set_title(f"Time Step: {t + 1}")
        if im is not None:
            fig.colorbar(
                im, ax=axs.ravel().tolist(), orientation="horizontal",
                pad=0.05,
            )
        fig.suptitle(f"Channel: {name}")
        p = f"{path_prefix}_ch{c}.png"
        fig.savefig(p, dpi=80)
        plt.close(fig)
        paths.append(p)
    return paths


def plot_histograms(
    traj: np.ndarray,
    path: str,
    channel_names: Optional[Sequence[str]] = None,
    bins: int = 50,
) -> bool:
    """Per-channel value histograms (reference visualize_histograms,
    cfdbench/vis_data.py:37-47) — one multi-panel PNG instead of the
    reference's one interactive window per channel. traj: (..., C)."""
    plt = _plt()
    if plt is None:
        print("viz: matplotlib unavailable, skipping", path)
        return False
    traj = np.asarray(traj)
    C = traj.shape[-1]
    fig, axes = plt.subplots(1, C, figsize=(5 * C, 4), squeeze=False)
    for c in range(C):
        name = (
            channel_names[c]
            if channel_names and c < len(channel_names)
            else f"channel {c}"
        )
        ax = axes[0][c]
        ax.hist(traj[..., c].ravel(), bins=bins, color="blue", alpha=0.7)
        ax.set_title(f"Histogram for {name}")
        ax.set_xlabel(name)
        ax.set_ylabel("Frequency")
        ax.grid(True)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return True


def plot_statistics(traj: np.ndarray, path: str) -> bool:
    """Macro-statistics bar (mean/std/min/max — reference
    compute_statistics + visualize_statistics, cfdbench/vis_data.py:50-70)."""
    plt = _plt()
    if plt is None:
        print("viz: matplotlib unavailable, skipping", path)
        return False
    traj = np.asarray(traj)
    labels = ["Mean", "Std. Dev.", "Min", "Max"]
    values = [
        float(np.mean(traj)), float(np.std(traj)),
        float(np.min(traj)), float(np.max(traj)),
    ]
    fig = plt.figure()
    plt.bar(labels, values, color=["blue", "orange", "green", "red"])
    plt.title("Macro Statistics of Data")
    for i, v in enumerate(values):
        plt.text(i, v + 0.05, f"{v:.2f}", ha="center")
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return True


def animate_rollout(
    pred: np.ndarray,
    target: np.ndarray,
    path: str,
    channel: int = 0,
    fps: int = 4,
) -> bool:
    """Target / prediction / error GIF over the rollout (the moving
    version of plot_rollout_comparison; evaluate --viz_dir emits one per
    dataset). pred/target: (H, W, T, C); writes a GIF via the Pillow
    writer, falling back to per-frame PNGs if no writer is available."""
    plt = _plt()
    if plt is None:
        print("viz: matplotlib unavailable, skipping", path)
        return False
    from matplotlib import animation

    pred, target = np.asarray(pred), np.asarray(target)
    T = pred.shape[-2]
    err = pred - target
    # fixed color scales across frames so the animation doesn't "breathe"
    vmax = float(max(np.abs(target[..., channel]).max(), 1e-8))
    emax = float(max(np.abs(err[..., channel]).max(), 1e-8))
    fig, axes = plt.subplots(1, 3, figsize=(10, 3.6))
    ims = []
    for ax, (fld, lbl, vm) in zip(
        axes,
        [(target, "target", vmax), (pred, "prediction", vmax),
         (err, "error", emax)],
    ):
        im = ax.imshow(
            fld[..., 0, channel], cmap="RdBu_r", vmin=-vm, vmax=vm
        )
        ax.set_title(lbl)
        ax.axis("off")
        ims.append((im, fld))
    title = fig.suptitle("t=0")
    fig.tight_layout()

    def frame(t):
        for im, fld in ims:
            im.set_data(fld[..., t, channel])
        title.set_text(f"t={t}")
        return [im for im, _ in ims]

    anim = animation.FuncAnimation(fig, frame, frames=T, blit=False)
    try:
        anim.save(path, writer=animation.PillowWriter(fps=fps))
    except Exception:
        plt.close(fig)
        base = path.rsplit(".", 1)[0]
        for t in range(T):
            plot_rollout_comparison(
                pred, target, f"{base}_t{t}.png", channel=channel, times=[t]
            )
        return True
    plt.close(fig)
    return True


def plot_volume(
    vol: np.ndarray,
    path: str,
    step: int = 5,
    max_points: int = 4096,
) -> bool:
    """3D volume rendering: alpha-weighted scatter (the reference's
    volume_rendering, visualize_3d.py:16-37 — its plotly Isosurface path
    needs kaleido, absent here) plus the three orthogonal mid-plane
    slices. vol: (X, Y, Z)."""
    plt = _plt()
    if plt is None:
        print("viz: matplotlib unavailable, skipping", path)
        return False
    vol = np.asarray(vol, np.float32)
    lo, hi = float(vol.min()), float(vol.max())
    nrm = (vol - lo) / (hi - lo + 1e-12)
    nx, ny, nz = vol.shape
    # stride up until the scatter stays bounded (a 512^3 volume would
    # otherwise draw 1M points)
    while (nx // step + 1) * (ny // step + 1) * (nz // step + 1) > max_points:
        step *= 2
    xs, ys, zs = np.mgrid[0:nx:step, 0:ny:step, 0:nz:step]
    a = nrm[::step, ::step, ::step].ravel()

    fig = plt.figure(figsize=(12, 3.2))
    ax3 = fig.add_subplot(1, 4, 1, projection="3d")
    ax3.scatter(
        xs.ravel(), ys.ravel(), zs.ravel(), c="blue",
        alpha=np.clip(a, 0.0, 1.0), s=4,
    )
    ax3.set_title("volume")
    for i, (sl, lbl) in enumerate(
        [(vol[nx // 2], "x mid"), (vol[:, ny // 2], "y mid"),
         (vol[:, :, nz // 2], "z mid")]
    ):
        ax = fig.add_subplot(1, 4, i + 2)
        m = ax.imshow(sl, cmap="viridis")
        ax.set_title(lbl)
        ax.axis("off")
        fig.colorbar(m, ax=ax, fraction=0.046)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return True


def save_eval_viz(
    pred: np.ndarray,
    target: np.ndarray,
    out_dir: str,
    dataset: str,
    channel: int = 0,
) -> list[str]:
    """Per-dataset evaluation visuals (cli/evaluate.py --viz_dir): rollout
    comparison PNG + GIF for 2D, mid-Z slice comparison + volume PNG for
    3D. pred/target: one sample, (H,W,T,C) or (X,Y,Z,T,C)."""
    import os

    os.makedirs(out_dir, exist_ok=True)
    pred, target = np.asarray(pred), np.asarray(target)
    safe = dataset.replace("/", "_")
    written = []
    if pred.ndim == 5:  # 3D: compare on the mid-Z plane, render the volume
        z = pred.shape[2] // 2
        vol_p = os.path.join(out_dir, f"{safe}_volume.png")
        if plot_volume(pred[..., -1, channel], vol_p):
            written.append(vol_p)
        pred, target = pred[:, :, z], target[:, :, z]
    cmp_p = os.path.join(out_dir, f"{safe}_rollout.png")
    if plot_rollout_comparison(pred, target, cmp_p, channel=channel):
        written.append(cmp_p)
    gif_p = os.path.join(out_dir, f"{safe}_rollout.gif")
    if animate_rollout(pred, target, gif_p, channel=channel):
        written.append(gif_p)
    return written


def plot_rollout_comparison(
    pred: np.ndarray,
    target: np.ndarray,
    path: str,
    channel: int = 0,
    times: Optional[Sequence[int]] = None,
) -> bool:
    """pred/target: (H, W, T, C) -> 3 rows: target / prediction / error."""
    plt = _plt()
    if plt is None:
        print("viz: matplotlib unavailable, skipping", path)
        return False
    pred, target = np.asarray(pred), np.asarray(target)
    T = pred.shape[-2]
    times = list(times if times is not None else np.linspace(0, T - 1, min(T, 5)).astype(int))
    fig, axes = plt.subplots(3, len(times), figsize=(3 * len(times), 9))
    rows = [target, pred, pred - target]
    labels = ["target", "prediction", "error"]
    for r, (row, lbl) in enumerate(zip(rows, labels)):
        for c, t in enumerate(times):
            ax = axes[r][c] if len(times) > 1 else axes[r]
            im = ax.imshow(row[..., t, channel], cmap="RdBu_r")
            ax.axis("off")
            if c == 0:
                ax.set_ylabel(lbl)
            ax.set_title(f"{lbl} t={t}", fontsize=8)
            fig.colorbar(im, ax=ax, fraction=0.046)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return True
