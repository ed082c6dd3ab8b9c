"""One process of the port's two-process test (tests/test_torch_multihost.py).

It joins the gloo process group with 2 logical CPU shards through
``init_distributed``, renders its shards' share of the sharded calls, takes
part in the cross-process all-reduce and writes what it holds afterwards to
an npz file.

Usage: python torch_multihost_worker.py <proc_id> <nproc> <port> <outfile>
"""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]


def main():
    proc_id, nproc, port, outfile = (
        int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    import numpy as np
    import torch

    torch.set_num_threads(1)
    import mitransient_tpu_torch as mt
    from mitransient_tpu_torch.parallel import (
        fetch,
        global_mesh,
        init_distributed,
        process_count,
        process_index,
        render_backward_sharded,
        render_sharded,
        shutdown,
    )
    import torch_multihost_cases as cases

    init_distributed(coordinator_address=f"127.0.0.1:{port}",
                     num_processes=nproc, process_id=proc_id,
                     local_device_count=2)
    assert process_count() == nproc and process_index() == proc_id
    mesh = global_mesh()
    assert mesh.size == 2 * nproc and mesh.offset == 2 * proc_id

    out = {}
    scene = mt.load_dict(cases.cbox(mt), device="cpu")
    s, t, stats = render_sharded(scene, mesh, **cases.RENDER,
                                 return_stats=True)
    g = render_backward_sharded(scene, mesh, (None, cases.ones_t()),
                                **cases.BACKWARD)["__tables__"]
    out.update(steady=s, transient=t, rays=torch.tensor(stats["rays"]),
               g_bsdf=g.bsdf_reflectance, g_emitter=g.emitter_radiance)
    for variant in cases.EXHAUSTIVE_VARIANTS:
        mt.set_variant(variant)
        try:
            es, et = render_sharded(
                mt.load_dict(cases.exhaustive(), device="cpu"), mesh,
                **cases.EXHAUSTIVE)
        finally:
            mt.set_variant("rgb")
        out[f"exhaustive_steady_{variant}"] = es
        out[f"exhaustive_{variant}"] = et
    np.savez(outfile, **fetch(out))
    shutdown()
    bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
           or m.split(".")[0] == "mitransient_tpu"]
    assert not bad, bad
    print(f"worker {proc_id} OK", flush=True)


if __name__ == "__main__":
    main()
