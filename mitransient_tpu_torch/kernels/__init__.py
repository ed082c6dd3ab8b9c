"""Hand-written CUDA kernels of the port: build, load and launch counts."""
from ._build import (  # noqa: F401
    build,
    launch_counts,
    library,
    reset_launch_counts,
)
