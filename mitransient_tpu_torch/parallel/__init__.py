"""Multi-device and multi-process rendering (see mesh.py, distributed.py)."""
from .distributed import (  # noqa: F401
    Mesh,
    fetch,
    global_mesh,
    init_distributed,
    process_count,
    process_index,
    replicate,
    shutdown,
)
from .dryrun import dryrun_multichip  # noqa: F401
from .mesh import (  # noqa: F401
    make_mesh,
    render_backward_sharded,
    render_nlos_exhaustive_sharded,
    render_sharded,
)
