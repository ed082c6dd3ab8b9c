"""Shared helpers for the example scripts of the PyTorch port.

Every example accepts ``--quick`` (a tiny configuration, seconds on the
CPU; tests/test_torch_examples.py runs it), ``--out DIR`` (where figures
land, default ``examples/out/torch/<script>``), ``--spp`` and ``--device``
(``cuda`` by default; ``cpu`` runs the kernels' plain PyTorch versions).
matplotlib is imported only when a figure is written.
"""
from __future__ import annotations

import argparse
import os
import sys

# `python examples/torch/<suite>/<script>.py` from the repository's root
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def example_args(name: str, description: str,
                 parser: argparse.ArgumentParser | None = None):
    p = parser or argparse.ArgumentParser(description=description)
    p.add_argument("--quick", action="store_true",
                   help="tiny configuration (seconds on the CPU)")
    p.add_argument("--out", default=os.path.join("examples", "out", "torch",
                                                 name),
                   help="output directory for figures")
    p.add_argument("--spp", type=int, default=None,
                   help="override samples per pixel")
    p.add_argument("--device", default="cuda",
                   help="torch device of the scene (default cuda)")
    args = p.parse_args()
    os.makedirs(args.out, exist_ok=True)
    return args


def reference_file(*parts):
    """A file of the reference's example corpus (scenes this repository
    does not hold) under the directory ``MITR_REFERENCE_EXAMPLES`` names, or
    None where it is not there."""
    root = os.environ.get("MITR_REFERENCE_EXAMPLES")
    path = os.path.join(root, *parts) if root else None
    return path if path and os.path.exists(path) else None


def host(x):
    """A tensor on any device as a host numpy array."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else x


def save_image(path: str, img, gamma: float = 2.2):
    """Tonemap (percentile-normalized, gamma) and save an (H, W, C|1) image."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    img = np.asarray(host(img), np.float32)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    scale = np.quantile(img, 0.99)
    out = np.clip((img / max(scale, 1e-9)) ** (1.0 / gamma), 0.0, 1.0)
    plt.imsave(path, out)
    return path
