"""Visualization utilities (a copy of ``mitransient_tpu/vis.py``: the
reference's unpolarized_visualization.py; the polarized false-color maps
are in ``vis_polarized.py``).

numpy and matplotlib; tensors on any device are copied to the host first.
Video export uses imageio where it is installed and otherwise saves the
frames as ``.npy``.
"""
from __future__ import annotations

import numpy as np


def _host(x) -> np.ndarray:
    """A tensor on any device, or an array, as a host numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def tonemap_transient(transient, scale: float = 1.0):
    """Normalize a transient video by its q99 (reference
    unpolarized_visualization.py:14-18)."""
    transient = _host(transient)
    channel_top = np.quantile(transient, 0.99)
    return transient * scale / max(channel_top, 1e-30)


def tonemap_grad_transient(grad, scale: float = 1.0):
    """Map signed gradient videos onto a blue-white-red diverging colormap
    (reference unpolarized_visualization.py:21-39)."""
    grad = _host(grad)
    if grad.ndim == 4 and grad.shape[-1] > 1:
        grad = grad.mean(axis=-1)
    top = np.quantile(np.abs(grad), 0.99)
    x = np.clip(grad * scale / max(top, 1e-30), -1.0, 1.0)
    r = np.clip(1.0 + x, 0.0, 1.0)
    b = np.clip(1.0 - x, 0.0, 1.0)
    g = np.minimum(r, b)
    return np.stack([r, g, b], axis=-1)


def save_frames(transient, folder: str, prefix: str = "frame",
                fmt: str = "exr"):
    """Write one image per time bin (reference saves EXRs via mi.Bitmap,
    unpolarized_visualization.py:65-76).  ``fmt``: 'exr' (built-in pure
    numpy writer, io_exr.py) or 'npy'."""
    import os

    os.makedirs(folder, exist_ok=True)
    transient = _host(transient)
    if fmt == "exr":
        from .io_exr import write_exr

        for t in range(transient.shape[2]):
            write_exr(os.path.join(folder, f"{prefix}_{t:04d}.exr"),
                      transient[:, :, t])
    elif fmt == "npy":
        for t in range(transient.shape[2]):
            np.save(os.path.join(folder, f"{prefix}_{t:04d}.npy"),
                    transient[:, :, t])
    else:
        raise ValueError(f"unknown frame format {fmt!r}")


def save_video(transient, path: str, fps: int = 24, axis_video: int = 2):
    """mp4/gif export via imageio if present (reference uses cv2,
    unpolarized_visualization.py:42-62)."""
    transient = tonemap_transient(transient)
    frames = np.moveaxis(transient, axis_video, 0)
    frames8 = (np.clip(frames, 0, 1) * 255).astype(np.uint8)
    if frames8.shape[-1] == 1:
        frames8 = np.repeat(frames8, 3, axis=-1)
    try:
        import imageio

        imageio.mimwrite(path, frames8, fps=fps)
    except ImportError:
        np.save(path + ".npy", frames8)


def show_video(transient, axis_video: int = 2, fps: int = 24):
    """Jupyter HTML animation (reference unpolarized_visualization.py:79-118)."""
    import matplotlib.animation as animation
    import matplotlib.pyplot as plt

    frames = np.moveaxis(tonemap_transient(transient), axis_video, 0)
    fig, ax = plt.subplots()
    im = ax.imshow(np.clip(frames[0], 0, 1))
    ax.axis("off")

    def update(i):
        im.set_data(np.clip(frames[i], 0, 1))
        return (im,)

    anim = animation.FuncAnimation(
        fig, update, frames=frames.shape[0], interval=1000 / fps, blit=True
    )
    plt.close(fig)
    try:
        from IPython.display import HTML

        return HTML(anim.to_html5_video())
    except Exception:
        return anim


def rainbow_visualization(transient, modulo: int = 0):
    """False-color image of per-pixel peak arrival time (reference
    unpolarized_visualization.py:122-151)."""
    import matplotlib.cm as cm

    tr = _host(transient)
    if tr.ndim == 4:
        tr = tr.mean(axis=-1)
    peak = np.argmax(tr, axis=2).astype(np.float64)
    mag = np.max(tr, axis=2)
    T = tr.shape[2]
    if modulo > 0:
        peak = np.mod(peak, modulo) / max(modulo - 1, 1)
    else:
        peak = peak / max(T - 1, 1)
    rgba = cm.hsv(peak)
    out = rgba[..., :3] * (mag / max(mag.max(), 1e-30))[..., None]
    return out
