"""Hand-written CUDA kernels of the port: build, load and launch counts
(kept in ``trace.py``)."""
from ..trace import launch_counts, reset_launch_counts  # noqa: F401
from ._build import build, library  # noqa: F401
