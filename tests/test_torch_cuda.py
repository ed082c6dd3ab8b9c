"""CUDA kernels K1-K3 of the PyTorch port against their plain versions.

Every test is marked ``cuda`` and skips without an NVIDIA GPU.  This file
imports neither jax nor the JAX package, so on a machine with only PyTorch
it runs with ``python -m pytest tests/test_torch_cuda.py -m cuda
--noconftest`` (the repo's conftest.py imports jax).

Tolerances: the kernels are built with ``--fmad=false`` and follow the
plain versions' operation order, so ``prim``, ``occluded`` and ``t`` must
be equal.  The plain splat adds with atomics on the card (order varies),
so the film is held to 1e-6 of its maximum.
"""
import numpy as np
import pytest
import torch

import mitransient_tpu_torch as mt
from mitransient_tpu_torch.film import transient_film as tf
from mitransient_tpu_torch.kernels import launch_counts, reset_launch_counts
from mitransient_tpu_torch.ops import intersect as isect
from torch_cases import (
    golden_mismatch,
    random_rays,
    random_soup,
    small_cbox,
    splat_events,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _soups(dev):
    rng = np.random.default_rng(1)
    sd = mt.load_dict(mt.cornell_box(), device=dev).data
    yield "cbox", (sd.tri.v0, sd.tri.e1, sd.tri.e2)
    # 2100 triangles: more than one shared-memory chunk of 1024
    for m in (200, 2100):
        yield f"random{m}", tuple(torch.from_numpy(a).to(dev)
                                  for a in random_soup(rng, m))


def _rays(dev, soup, n=20000, seed=2):
    rng = np.random.default_rng(seed)
    host = tuple(a.cpu().numpy() for a in soup)
    return tuple(torch.from_numpy(a).to(dev)
                 for a in random_rays(rng, n, host))


@pytest.mark.cuda
def test_closest_hit_kernel_matches_plain(cuda):
    for name, soup in _soups(cuda):
        o, d, maxt, active = _rays(cuda, soup)
        t_k, prim_k = isect.closest_hit(*soup, o, d, maxt, active)
        t_p, prim_p, _, _ = isect.intersect_soup(*soup, o, d, maxt, active)
        torch.cuda.synchronize()
        assert torch.equal(prim_k, prim_p), name
        assert torch.equal(t_k, t_p), name
        assert (prim_k >= 0).any() and (prim_k < 0).any(), name


@pytest.mark.cuda
def test_ray_test_kernel_matches_plain(cuda):
    for name, soup in _soups(cuda):
        o, d, maxt, active = _rays(cuda, soup, seed=3)
        maxt = torch.where(torch.isinf(maxt), 1.0, maxt)
        occ_k = isect.ray_test(*soup, o, d, maxt, active)
        occ_p = isect.ray_test_soup(*soup, o, d, maxt, active)
        torch.cuda.synchronize()
        assert torch.equal(occ_k, occ_p), name
        assert occ_k.any() and (~occ_k & active).any(), name


@pytest.mark.cuda
@pytest.mark.parametrize("two_events", [False, True])
def test_splat_kernel_matches_plain(cuda, two_events):
    rng = np.random.default_rng(4)
    lanes, hw, bins = 6, 300, 50
    sets = [splat_events(rng, lanes, hw, bins) for _ in range(2)]
    sets = [tuple(torch.from_numpy(a).to(cuda) for a in s) for s in sets]
    (ba, va), (bb, vb) = sets if two_events else (sets[0], (None, None))
    init = torch.from_numpy(rng.random((3, bins + 1, hw)).astype(np.float32))
    film_k, film_p = init.to(cuda), init.to(cuda)
    tf.splat_accumulate(film_k, ba, va, bb, vb, spp=lanes)
    tf._scatter_layout(film_p, hw, ba, va)
    if two_events:
        tf._scatter_layout(film_p, hw, bb, vb)
    torch.cuda.synchronize()
    scale = float(film_p.abs().max())
    assert float((film_k - film_p).abs().max()) <= 1e-6 * scale
    # the kernel is deterministic: the same adds give the same bits
    film_k2 = init.to(cuda)
    tf.splat_accumulate(film_k2, ba, va, bb, vb, spp=lanes)
    assert torch.equal(film_k, film_k2)


@pytest.mark.cuda
def test_kernels_check_their_arguments(cuda):
    soup = next(_soups(cuda))[1]
    o, d, maxt, active = _rays(cuda, soup, n=64)
    with pytest.raises(TypeError):
        isect.closest_hit(*soup, o.double(), d, maxt, active)
    with pytest.raises(ValueError):
        isect.ray_test(*soup, o[:, :2], d, maxt, active)
    with pytest.raises(ValueError):
        isect.closest_hit(*soup, o.T.contiguous().T, d, maxt, active)
    with pytest.raises(ValueError):
        isect.closest_hit(*soup, o, d.cpu(), maxt, active)


@pytest.mark.cuda
def test_small_render_on_cuda_goes_through_the_kernels(cuda):
    """The cbox_rgb config on the card: each kernel launches once per loop
    iteration and the images agree with the port on the CPU under the
    golden rule (rtol 5e-4, atol 5e-5 * max, no element out)."""
    out = {}
    for dev in ("cpu", cuda):
        scene = mt.load_dict(small_cbox(mt), device=dev)
        reset_launch_counts()
        s, t, stats = mt.render(scene, spp=8, seed=0, return_stats=True)
        out[str(dev)] = (s.cpu().numpy(), t.cpu().numpy(), stats,
                         launch_counts())
    s_c, t_c, stats_c, counts_c = out["cpu"]
    s_g, t_g, stats_g, counts_g = out[str(cuda)]
    assert counts_c == {}
    n = stats_g["loop_iters"]
    assert n > 0 and counts_g == {"closest_hit": n, "ray_test": n,
                                  "splat_accumulate": n}
    assert np.isfinite(s_g).all() and np.isfinite(t_g).all()
    for got, want in ((s_g, s_c), (t_g, t_c)):
        m = golden_mismatch(got, want)
        assert m["shape_ok"] and m["n_bad"] == 0, m
