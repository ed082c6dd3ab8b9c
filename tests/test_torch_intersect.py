"""Plain versions of kernels K1 (closest hit) and K2 (any hit) against the
JAX contract ``mitransient_tpu/ops/intersect.py`` on the CPU.

Tolerance: ``prim`` and ``occluded`` exact; ``t`` and the barycentrics
within rtol 1e-5 / atol 1e-6.  XLA:CPU contracts ``a*b + c`` into an FMA
inside a fused loop (measured with jax 0.9: every one of 1e5 jitted
``a*b + c`` equals the fused result), while the port rounds each operation
as the TPU and CUDA kernels do; where a Moller-Trumbore sum cancels, the
two roundings part by a few 1e-6 of t.

The cases cover the Cornell box soup and a random 200-triangle soup with
misses, inactive lanes, short maxt and an exact tie (triangle 199 repeats
triangle 0; index 0 must win).  Cornell box rays start in the box's air,
outside the two cubes: from inside a cube, the cube's bottom face and the
floor are coplanar, a tie that the two roundings may break differently,
and that no path of a render can reach.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitransient_tpu_torch as mt
from mitransient_tpu.ops import intersect as jx
from mitransient_tpu_torch.kernels import launch_counts, reset_launch_counts
from mitransient_tpu_torch.core.transform import from_spec
from mitransient_tpu_torch.ops import intersect as tx
from torch_cases import camera_rays, random_rays, random_soup

torch.set_num_threads(1)


def _soup(kind):
    if kind == "cbox":
        sd = mt.load_dict(mt.cornell_box(), device="cpu").data
        return tuple(a.numpy() for a in (sd.tri.v0, sd.tri.e1, sd.tri.e2))
    return random_soup(np.random.default_rng(11), 200)


def _outside_cubes(o):
    desc = mt.cornell_box()
    keep = np.ones(o.shape[0], bool)
    for key in ("small-box", "large-box"):
        inv = from_spec(desc[key]["to_world"]).inverse()
        keep &= np.abs(inv.apply_point(o)).max(axis=1) > 1.0
    return keep


def _rays(kind, soup, n=4000):
    rng = np.random.default_rng(12)
    o, d, maxt, act = random_rays(rng, 2 * n, soup)
    if kind == "cbox":
        keep = _outside_cubes(o)
        o, d, maxt, act = o[keep], d[keep], maxt[keep], act[keep]
        cam = mt.load_dict(mt.cornell_box(), device="cpu").sensors[0].to_world.m
        o2, d2 = camera_rays(rng, n // 2, cam[:3, :3], cam[:3, 3],
                             np.array([0.357, 0.357]))
        o[: n // 2], d[: n // 2] = o2, d2  # half of them camera rays
    return o[:n], d[:n], maxt[:n], act[:n]


def _both(fn_j, fn_t, soup, rays):
    got = fn_t(*(torch.from_numpy(a) for a in (*soup, *rays)))
    want = fn_j(*(jnp.asarray(a) for a in (*soup, *rays)))
    return got, want


@pytest.mark.parametrize("kind", ["cbox", "random200"])
def test_intersect_soup_matches_jax(kind):
    soup = _soup(kind)
    rays = _rays(kind, soup)
    (t, prim, u, v), (jt, jprim, ju, jv) = _both(jx.intersect_soup,
                                                 tx.intersect_soup, soup, rays)
    np.testing.assert_array_equal(prim.numpy(), np.asarray(jprim))
    hit = prim.numpy() >= 0
    assert 0.2 < hit.mean() < 0.95
    np.testing.assert_array_equal(np.isinf(t.numpy()), ~hit)
    for name, g, w in (("t", t, jt), ("u", u, ju), ("v", v, jv)):
        np.testing.assert_allclose(g.numpy()[hit], np.asarray(w)[hit],
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    if kind == "random200":  # rays aimed at the tied pair hit index 0
        assert (prim.numpy() == 0).sum() > 20
        assert not (prim.numpy() == 199).any()
    inactive = ~rays[3]
    assert (prim.numpy()[inactive] == -1).all()


@pytest.mark.parametrize("kind", ["cbox", "random200"])
def test_ray_test_soup_matches_jax(kind):
    soup = _soup(kind)
    o, d, maxt, act = _rays(kind, soup)
    maxt = np.where(np.isinf(maxt), np.float32(1.2), maxt)
    occ, jocc = _both(jx.ray_test_soup, tx.ray_test_soup, soup,
                      (o, d, maxt, act))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    assert 0.1 < occ.numpy().mean() < 0.9
    assert not occ.numpy()[~act].any()


def test_small_cases():
    """The JAX package's own unit cases (tests/test_intersect.py)."""
    v0 = np.array([[-1.0, -1.0, 0.0], [-1.0, -1.0, -2.0]], np.float32)
    e1 = np.array([[2.0, 0.0, 0.0]] * 2, np.float32)
    e2 = np.array([[0.0, 2.0, 0.0]] * 2, np.float32)
    o = np.array([[0.0, -0.5, 1.0], [5.0, 5.0, 1.0], [0.0, -0.5, 1.0],
                  [-0.5, -0.5, 1.0], [0.0, -0.5, 1.0]], np.float32)
    d = np.array([[0, 0, -1.0], [0, 0, -1.0], [0, 0, 1.0], [0, 0, -1.0],
                  [0, 0, -1.0]], np.float32)
    maxt = np.array([np.inf, np.inf, np.inf, np.inf, 0.5], np.float32)
    act = np.array([True, True, True, True, True])
    t, prim, u, v = tx.intersect_soup(*(torch.from_numpy(a) for a in
                                        (v0, e1, e2, o, d, maxt, act)))
    assert prim.tolist() == [0, -1, -1, 0, -1]
    assert t[0] == 1.0 and t[3] == 1.0 and torch.isinf(t[1])
    assert abs(float(u[3]) - 0.25) < 1e-6 and abs(float(v[3]) - 0.25) < 1e-6
    act[0] = False
    occ = tx.ray_test_soup(*(torch.from_numpy(a) for a in
                             (v0, e1, e2, o, d, np.full(5, 1.5, np.float32),
                              act)))
    assert occ.tolist() == [False, False, False, True, True]


def test_wrappers_take_the_plain_path_on_cpu():
    """On CPU tensors the wrappers are the plain versions and count no
    kernel launch; on another device they raise instead of falling back."""
    soup = _soup("cbox")
    rays = _rays("cbox", soup, n=256)
    ts = [torch.from_numpy(a) for a in (*soup, *rays)]
    reset_launch_counts()
    t, prim = tx.closest_hit(*ts)
    t2, prim2, _, _ = tx.intersect_soup(*ts)
    assert torch.equal(prim, prim2) and torch.equal(t, t2)
    assert torch.equal(tx.ray_test(*ts), tx.ray_test_soup(*ts))
    assert launch_counts() == {}
    meta = [a.to("meta") for a in ts]
    for fn in (tx.closest_hit, tx.ray_test):
        with pytest.raises(ValueError, match="expected cpu or cuda"):
            fn(*meta)


def test_tri_table_layout():
    """Packed 48-byte records: v0, e1, e2, then three zeros."""
    soup = [torch.from_numpy(a) for a in _soup("random200")]
    table = tx.tri_table(*soup)
    assert table.shape == (200, tx.TABLE_WIDTH) and table.is_contiguous()
    assert table.dtype == torch.float32
    for k, a in enumerate(soup):
        assert torch.equal(table[:, 3 * k:3 * k + 3], a)
    assert not table[:, 9:].any()
