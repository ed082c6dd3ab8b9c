"""Polarized visualization utilities (a copy of
``mitransient_tpu/vis_polarized.py``): degree-of-polarization metrics and
the [Wilkie & Weidlich 2010] false-color maps.

Inputs are Stokes-channel images or videos shaped (..., 4) with channels
(I, Q, U, V), the layout of a ``mono_polarized`` render (the reference's
'0123' channel packing, transient_image_block.py:90-99).  Everything but
:func:`show_video_polarized` is numpy alone; the AoLP map converts HSV
with :func:`hsv_to_rgb`, matplotlib's formula.
"""
from __future__ import annotations

import numpy as np


def _stokes(arr):
    a = np.asarray(arr)
    if a.shape[-1] < 4:
        raise ValueError("expected Stokes data with 4 trailing channels")
    return a[..., 0], a[..., 1], a[..., 2], a[..., 3]


def degree_of_polarization(arr):
    """DoP = sqrt(Q^2+U^2+V^2)/I (reference polarized_visualization.py:193)."""
    i, q, u, v = _stokes(arr)
    return np.sqrt(q * q + u * u + v * v) / np.maximum(i, 1e-9)


def degree_of_linear_polarization(arr):
    i, q, u, _ = _stokes(arr)
    return np.sqrt(q * q + u * u) / np.maximum(i, 1e-9)


def degree_of_circular_polarization(arr):
    i, _, _, v = _stokes(arr)
    return np.abs(v) / np.maximum(i, 1e-9)


def angle_of_linear_polarization(arr):
    _, q, u, _ = _stokes(arr)
    return 0.5 * np.arctan2(u, q)


def hsv_to_rgb(hsv):
    """HSV (..., 3) in [0, 1] -> RGB (..., 3), as
    ``matplotlib.colors.hsv_to_rgb`` computes it."""
    hsv = np.asarray(hsv)
    hsv = hsv.astype(np.promote_types(hsv.dtype, np.float32))
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = (h * 6.0).astype(int)
    f = (h * 6.0) - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    sector = np.where(i % 6 == 0, 0, i)
    r = np.select([sector == k for k in range(6)], [v, q, p, p, t, v], h)
    g = np.select([sector == k for k in range(6)], [t, v, v, q, p, p], h)
    b = np.select([sector == k for k in range(6)], [p, p, t, v, v, q], h)
    grey = s == 0
    return np.stack([np.where(grey, v, r), np.where(grey, v, g),
                     np.where(grey, v, b)], axis=-1).astype(hsv.dtype)


def polarization_generate_false_color(arr, mode="dop"):
    """False-color maps per [Wilkie & Weidlich 2010]
    (reference polarized_visualization.py:232-289):

    * 'dop'  — degree of polarization in reds
    * 'aolp' — angle of linear polarization as a hue rainbow, saturation by
      DoLP
    * 'top'  — type of polarization: linear (red) vs circular (blue)
    * 'chirality' — circular handedness: right (green) vs left (magenta)
    """
    i, q, u, v = _stokes(arr)
    if mode == "dop":
        d = np.clip(degree_of_polarization(arr), 0, 1)
        out = np.stack([d, d * 0.15, d * 0.15], axis=-1)
    elif mode == "aolp":
        ang = (angle_of_linear_polarization(arr) + np.pi / 2) / np.pi
        sat = np.clip(degree_of_linear_polarization(arr), 0, 1)
        val = np.clip(i / max(np.quantile(i, 0.99), 1e-9), 0, 1)
        hsv = np.stack([ang, sat, val], axis=-1)
        out = hsv_to_rgb(hsv)
    elif mode == "top":
        lin = degree_of_linear_polarization(arr)
        circ = degree_of_circular_polarization(arr)
        out = np.stack([np.clip(lin, 0, 1), np.zeros_like(lin),
                        np.clip(circ, 0, 1)], axis=-1)
    elif mode == "chirality":
        right = np.clip(v, 0, None) / np.maximum(i, 1e-9)
        left = np.clip(-v, 0, None) / np.maximum(i, 1e-9)
        out = np.stack([np.clip(left, 0, 1), np.clip(right, 0, 1),
                        np.clip(left, 0, 1)], axis=-1)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return out


def tonemap_transient(transient, scale: float = 1.0, normalize_M00=True):
    """q99-normalized intensity tonemap for Stokes videos
    (reference polarized_visualization.py:292-303)."""
    tr = np.asarray(transient)
    i = tr[..., 0]
    top = np.quantile(i, 0.99)
    if normalize_M00:
        return i * scale / max(top, 1e-30)
    return tr * scale / max(top, 1e-30)


def show_video_polarized(transient, fps: int = 24):
    """Multi-panel Stokes/false-color animation (reference
    polarized_visualization.py:33-190): I, |Q|, |U|, |V|, DoP, DoLP, AoLP,
    chirality panels."""
    import matplotlib.animation as animation
    import matplotlib.pyplot as plt

    tr = np.asarray(transient)  # (H, W, T, 4)
    T = tr.shape[2]
    top = max(np.quantile(tr[..., 0], 0.99), 1e-9)

    def panels(t):
        f = tr[:, :, t, :]
        return [
            np.clip(f[..., 0] / top, 0, 1),
            np.clip(np.abs(f[..., 1]) / top, 0, 1),
            np.clip(np.abs(f[..., 2]) / top, 0, 1),
            np.clip(np.abs(f[..., 3]) / top, 0, 1),
            polarization_generate_false_color(f, "dop"),
            polarization_generate_false_color(f, "aolp"),
            polarization_generate_false_color(f, "top"),
            polarization_generate_false_color(f, "chirality"),
        ]

    titles = ["I", "|Q|", "|U|", "|V|", "DoP", "AoLP", "ToP", "chirality"]
    fig, axes = plt.subplots(2, 4, figsize=(12, 6))
    ims = []
    first = panels(0)
    for ax, img, name in zip(axes.ravel(), first, titles):
        ims.append(ax.imshow(img, cmap="gray" if img.ndim == 2 else None,
                             vmin=0, vmax=1))
        ax.set_title(name)
        ax.axis("off")

    def update(t):
        for im, img in zip(ims, panels(t)):
            im.set_data(img)
        return ims

    anim = animation.FuncAnimation(fig, update, frames=T,
                                   interval=1000 / fps, blit=False)
    plt.close(fig)
    try:
        from IPython.display import HTML

        return HTML(anim.to_html5_video())
    except Exception:
        return anim
