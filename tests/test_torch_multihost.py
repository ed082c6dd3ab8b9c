"""The port's multi-process rendering: two OS processes, each with 2
logical CPU shards, joined over gloo by ``init_distributed`` into one
4-shard mesh (the pattern of tests/test_multihost.py).  The film partials,
ray counts, gradient tables and the exhaustive capture's slabs cross the
process boundary in ``dist.all_reduce``.

Tolerances: the two processes hold bit-identical results; against one
process with 4 shards, whose shards' partials are summed in another order
((p0 + p1) + (p2 + p3) against ((p0 + p1) + p2) + p3), rtol 2e-6 / atol
1e-7 and 2e-5 for the gradients, the JAX package's bounds
(tests/test_multihost.py:101-109); the exhaustive capture bit for bit (each
slab comes from one shard); against the JAX package's one-process
4-device render test_golden's rule with no element out and gradients within
1e-4 of each table's largest |value|.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import mitransient_tpu as mitr
import mitransient_tpu_torch as mt
import torch_multihost_cases as cases
from mitransient_tpu.parallel import mesh as jmesh
from mitransient_tpu_torch.parallel import mesh as tmesh
from torch_cases import golden_mismatch, with_variant

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER_TIMEOUT_S = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def worker_outputs(tmp_path_factory):
    """Run the two processes once; their npz outputs."""
    tmp = tmp_path_factory.mktemp("torch_mh")
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    outs = [str(tmp / f"out{i}.npz") for i in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_multihost_worker.py"),
         str(i), "2", str(port), outs[i]],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        cwd=os.path.dirname(HERE)) for i in range(2)]
    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=WORKER_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            stdout, _ = p.communicate()
        logs.append(stdout.decode(errors="replace"))
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{logs[i][-4000:]}"
    return [dict(np.load(o)) for o in outs]


@pytest.fixture(scope="module")
def one_process():
    """The same calls in this process over 4 CPU shards."""
    torch.set_num_threads(1)
    mesh = tmesh.make_mesh(devices=["cpu"] * 4)
    scene = mt.load_dict(cases.cbox(mt), device="cpu")
    s, t, stats = tmesh.render_sharded(scene, mesh, **cases.RENDER,
                                       return_stats=True)
    g = tmesh.render_backward_sharded(scene, mesh, (None, cases.ones_t()),
                                      **cases.BACKWARD)["__tables__"]
    out = dict(steady=s.numpy(), transient=t.numpy(), rays=stats["rays"],
               g_bsdf=g.bsdf_reflectance.numpy(),
               g_emitter=g.emitter_radiance.numpy())
    for variant in cases.EXHAUSTIVE_VARIANTS:
        with with_variant(mt, variant):
            es, et = mt.render(mt.load_dict(cases.exhaustive(),
                                            device="cpu"),
                               **cases.EXHAUSTIVE)
        out[f"exhaustive_steady_{variant}"] = es.numpy()
        out[f"exhaustive_{variant}"] = et.numpy()
    return out


def test_processes_agree_bitwise(worker_outputs):
    a, b = worker_outputs
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_two_processes_equal_one(worker_outputs, one_process):
    """2 processes x 2 shards against 1 process x 4 shards (and, for the
    exhaustive captures, the local capture): the same samples."""
    a, want = worker_outputs[0], one_process
    assert int(a["rays"]) == want["rays"]
    for k in ("steady", "transient"):
        np.testing.assert_allclose(a[k], want[k], rtol=2e-6, atol=1e-7,
                                   err_msg=k)
    for k in ("g_bsdf", "g_emitter"):
        np.testing.assert_allclose(a[k], want[k], rtol=2e-5, atol=1e-7,
                                   err_msg=k)
    for v in cases.EXHAUSTIVE_VARIANTS:
        np.testing.assert_array_equal(a[f"exhaustive_{v}"],
                                      want[f"exhaustive_{v}"])
        np.testing.assert_allclose(a[f"exhaustive_steady_{v}"],
                                   want[f"exhaustive_steady_{v}"],
                                   rtol=1e-5, atol=1e-7)
        assert a[f"exhaustive_{v}"].sum() > 0


def test_two_processes_match_jax(worker_outputs):
    """Against the JAX package's one-process 4-device calls."""
    a = worker_outputs[0]
    scene = mitr.load_dict(cases.cbox(mitr))
    mesh = jmesh.make_mesh(4)
    s, t, stats = jmesh.render_sharded(scene, mesh, **cases.RENDER,
                                       return_stats=True)
    g = jmesh.render_backward_sharded(scene, mesh, (None, cases.ones_t()),
                                      **cases.BACKWARD)["__tables__"]
    for k, w in (("steady", s), ("transient", t)):
        m = golden_mismatch(a[k], np.asarray(w))
        assert m["shape_ok"] and m["n_bad"] == 0, (k, m)
    assert abs(int(a["rays"]) - float(stats["rays"])) <= 1e-3 * float(
        stats["rays"])
    for k, w in (("g_bsdf", g.bsdf_reflectance),
                 ("g_emitter", g.emitter_radiance)):
        w = np.asarray(w)
        np.testing.assert_allclose(a[k], w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)
