"""The port's BSDF code (``bsdf/api.py``, ``bsdf/fresnel.py``) and its
warps against ``mitransient_tpu/bsdf/api.py`` on the CPU.

Tolerances, by function:

- The diffuse lobe and the warps: rtol 1e-6, with atol 1e-6 for values
  near zero (direction components come out of sin/cos, which XLA and
  PyTorch round by different ulps).  The hemisphere's z = sqrt(1 - x^2 -
  y^2), and the pdf z / pi, turn an ulp of x^2 near the horizon into an
  error of about 1e-7 / z, so they are held to the same tolerance on
  their squares.
- The dielectric Fresnel term, the texture lookup and the perturbed
  shading normal: rtol 1e-5, atol 1e-6.  The conductor's Fresnel term:
  rtol 5e-5, atol 1e-6; its t0 = eta^2 - k^2 - sin^2 cancels where eta^2
  - k^2 is near sin^2 (2e-5 at worst on random IORs), and XLA contracts
  its products into FMAs.
- ``eval_pdf`` of every kind: rtol 1e-5, atol 1e-6.
- ``sample`` of every kind: directions to 2e-4 absolute, pdf and weight
  to rtol 2e-4, atol 1e-6.  The GGX visible-normal sample composes
  sin/cos(2 pi u) with square roots of arguments near 0 (p3 = sqrt(1 -
  p1^2 - p2^2)), and the plastic's alpha = 0.03 lobe peaks at a pdf of
  about 4e3, so an ulp in the draw's chain grows to about 1e-4.

Discrete results are exact: kinds, ``delta``, ``eta``, the lanes with a
nonzero pdf, and the dielectric's reflect/refract pick except where
``|u1 - F| < 1e-6``.
"""
import jax.numpy as jnp
import numpy as np
import torch

import mitransient_tpu as mitr
import mitransient_tpu_torch as mt
import pytest

from mitransient_tpu.bsdf import api as jb
from mitransient_tpu.bsdf import fresnel as jfr
from mitransient_tpu.core import warp as jw
from mitransient_tpu.scene import scene as jscene
from mitransient_tpu_torch.bsdf import api as tb
from mitransient_tpu_torch.bsdf import fresnel as tfr
from mitransient_tpu_torch.core import warp as tw
from mitransient_tpu_torch.scene import scene as tscene

torch.set_num_threads(1)

N = 20000


def _close(got, want, name):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6, err_msg=name)


def _close_z(got, want, name):
    """z = sqrt(1 - x^2 - y^2): compare z^2, and the signs, exactly as
    sensitive as x and y."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.sign(got), np.sign(want), err_msg=name)
    _close(got * got, want * want, name)


def _close_hemi(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    _close(got[:, :2], want[:, :2], name + ".xy")
    _close_z(got[:, 2], want[:, 2], name + ".z")


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-1, 3, N).astype(np.int32)  # -1 = no hit
    wi = rng.normal(size=(N, 3))
    wo = rng.normal(size=(N, 3))
    wi = (wi / np.linalg.norm(wi, axis=1, keepdims=True)).astype(np.float32)
    wo = (wo / np.linalg.norm(wo, axis=1, keepdims=True)).astype(np.float32)
    u1 = rng.random(N).astype(np.float32)
    u2 = rng.random((N, 2)).astype(np.float32)
    u2[:4] = [[0.5, 0.5], [0.5, 0.9], [0.1, 0.5], [0.0, 0.0]]  # disk edge cases
    active = rng.random(N) > 0.1
    return ids, wi, wo, u1, u2, active


def _lanes(ids):
    jbp = mitr.load_dict(mitr.cornell_box()).data.bsdf
    tbp = mt.load_dict(mt.cornell_box(), device="cpu").data.bsdf
    return (jb.gather_lane_bsdf(jbp, jnp.asarray(ids)),
            tb.gather_lane_bsdf(tbp, torch.from_numpy(ids)))


def test_gather_and_is_smooth_match_jax():
    ids = _inputs()[0]
    jl, tl = _lanes(ids)
    np.testing.assert_array_equal(tl.kind.numpy(), np.asarray(jl.kind))
    np.testing.assert_array_equal(tl.reflectance.numpy(),
                                  np.asarray(jl.reflectance))
    np.testing.assert_array_equal(tb.is_smooth(tl).numpy(),
                                  np.asarray(jb.is_smooth(jl)))


def test_eval_pdf_matches_jax():
    ids, wi, wo, _, _, active = _inputs(1)
    jl, tl = _lanes(ids)
    jf, jpdf = jb.eval_pdf(jl, jnp.asarray(wi), jnp.asarray(wo),
                           jnp.asarray(active))
    f, pdf = tb.eval_pdf(tl, torch.from_numpy(wi), torch.from_numpy(wo),
                         torch.from_numpy(active))
    _close(f, jf, "f")
    _close(pdf, jpdf, "pdf")
    np.testing.assert_array_equal(pdf.numpy() > 0, np.asarray(jpdf) > 0)
    assert (pdf.numpy() > 0).mean() > 0.1


def test_sample_matches_jax():
    ids, wi, _, u1, u2, active = _inputs(2)
    jl, tl = _lanes(ids)
    js = jb.sample(jl, jnp.asarray(wi), jnp.asarray(u1), jnp.asarray(u2),
                   jnp.asarray(active))
    ts = tb.sample(tl, torch.from_numpy(wi), torch.from_numpy(u1),
                   torch.from_numpy(u2), torch.from_numpy(active))
    _close_hemi(ts.wo, js.wo, "wo")
    _close_z(ts.pdf.numpy() * np.pi, np.asarray(js.pdf) * np.pi, "pdf")
    for f in ("eta", "weight"):
        _close(getattr(ts, f), getattr(js, f), f)
    np.testing.assert_array_equal(ts.delta.numpy(), np.asarray(js.delta))
    np.testing.assert_array_equal(ts.pdf.numpy() > 0, np.asarray(js.pdf) > 0)
    assert (ts.pdf.numpy() > 0).mean() > 0.3


def test_warps_match_jax():
    u2 = _inputs(3)[4]
    _close(tw.square_to_uniform_disk_concentric(torch.from_numpy(u2)),
           jw.square_to_uniform_disk_concentric(jnp.asarray(u2)), "disk")
    hemi = tw.square_to_cosine_hemisphere(torch.from_numpy(u2))
    _close_hemi(hemi, jw.square_to_cosine_hemisphere(jnp.asarray(u2)), "hemi")
    _close(tw.square_to_cosine_hemisphere_pdf(hemi),
           jw.square_to_cosine_hemisphere_pdf(jnp.asarray(hemi.numpy())),
           "pdf")
    np.testing.assert_array_equal(hemi[0].numpy(), [0.0, 0.0, 1.0])


# --------------------------------------------------------------------------
# Every kind
# --------------------------------------------------------------------------

AU = ([0.1431, 0.3749, 1.4424], [3.9831, 2.3857, 1.6032])
# one row a kind, one-sided and isotropic; with its variant two-sided and
# anisotropic: (kind, reflectance, eta_re, eta_im, alpha, eta_ratio,
# alpha_v)
KIND_ROWS = {
    "diffuse": (0, [0.8, 0.5, 0.3], 0.0, 0.0, 0.0, 1.5046, 0.0),
    "conductor": (1, [1.0, 0.9, 0.8], *AU, 0.0, 1.5046, 0.0),
    "roughconductor": (2, [0.9, 0.9, 0.9], *AU, 0.2, 1.5046, 0.2),
    "dielectric": (3, [1.0, 1.0, 1.0], 0.0, 0.0, 0.0, 1.5046, 0.0),
    "null": (4, [1.0, 1.0, 1.0], 0.0, 0.0, 0.0, 1.5046, 0.0),
    "roughplastic": (5, [0.2, 0.4, 0.7], 0.0, 0.0, 0.2, 1.49, 0.2),
}
VARIANTS = ("one_sided_isotropic", "two_sided_anisotropic")


def _table(rows):
    """Numpy BSDF table columns of ``rows`` (kind, two_sided, reflectance,
    eta_re, eta_im, alpha, eta_ratio, alpha_v)."""
    def col(i):
        return np.array([np.broadcast_to(np.asarray(r[i], np.float64), (3,))
                         for r in rows], np.float32)

    def scalar(i, dtype=np.float32):
        return np.array([r[i] for r in rows], dtype)

    return dict(kind=scalar(0, np.int32), two_sided=scalar(1, bool),
                reflectance=col(2), eta_re=col(3), eta_im=col(4),
                alpha=scalar(5), eta_ratio=scalar(6), alpha_v=scalar(7))


def _kind_table(name):
    """Rows of one kind: the plain row, a two-sided and anisotropic
    variant (alpha_u 0.4, alpha_v 0.05 for the GGX kinds; the dielectric's
    variant leaves glass, eta 1/1.33; the conductor's is a perfect mirror,
    eta = k = 0)."""
    k, refl, er, ei, a, eta, av = KIND_ROWS[name]
    rows = [(k, False, refl, er, ei, a, eta, av)]
    if k in (2, 5):
        rows.append((k, True, refl, er, ei, 0.4, eta, 0.05))
    elif k == 3:
        rows.append((k, True, refl, er, ei, a, 1.0 / 1.33, av))
    elif k == 1:
        rows.append((k, True, refl, 0.0, 0.0, a, eta, av))
    else:
        rows.append((k, True, refl, er, ei, a, eta, av))
    return _table(rows)


def _both_lanes(table, ids, kinds=None, two_sided=True):
    """The lanes ``ids`` of ``table`` in both packages, with the static
    kind set ``kinds`` (None: every kind)."""
    jbp = jscene.BSDFParams(
        **{k: jnp.asarray(v) for k, v in table.items()},
        ks=(jscene.KindsStatic() if kinds is None else
            jscene.KindsStatic(kinds=kinds, any_two_sided=two_sided)))
    tbp = tscene.BSDFParams(**{k: torch.from_numpy(v)
                               for k, v in table.items()})
    ks = (tscene.BSDFKinds() if kinds is None
          else tscene.BSDFKinds(kinds, two_sided))
    return (jb.gather_lane_bsdf(jbp, jnp.asarray(ids)),
            tb.gather_lane_bsdf(tbp, torch.from_numpy(ids), ks=ks))


def _lane_inputs(seed, rows):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-1, rows, N).astype(np.int32)
    wi = rng.normal(size=(N, 3))
    wo = rng.normal(size=(N, 3))
    wi = (wi / np.linalg.norm(wi, axis=1, keepdims=True)).astype(np.float32)
    wo = (wo / np.linalg.norm(wo, axis=1, keepdims=True)).astype(np.float32)
    u1 = rng.random(N).astype(np.float32)
    u2 = rng.random((N, 2)).astype(np.float32)
    u2[:4] = [[0.5, 0.5], [0.5, 0.9], [0.1, 0.5], [0.0, 0.0]]
    return ids, wi, wo, u1, u2, rng.random(N) > 0.1


def _sample_close(ts, js, wi, u1, lb):
    np.testing.assert_allclose(ts.wo.numpy(), np.asarray(js.wo), rtol=0,
                               atol=2e-4, err_msg="wo")
    for f in ("pdf", "weight"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=2e-4,
                                   atol=1e-6, err_msg=f)
    np.testing.assert_array_equal(ts.eta.numpy(), np.asarray(js.eta))
    np.testing.assert_array_equal(ts.delta.numpy(), np.asarray(js.delta))
    np.testing.assert_array_equal(ts.pdf.numpy() > 0, np.asarray(js.pdf) > 0)
    # the dielectric's pick: reflected where wo stays on wi's side
    diel = lb.kind.numpy() == 3
    if diel.any():
        F = tfr.fresnel_dielectric(torch.from_numpy(wi[:, 2]),
                                   lb.eta_ratio)[0].numpy()
        pick = diel & (np.abs(u1 - F) >= 1e-6) & (ts.pdf.numpy() > 0)
        side_t = ts.wo.numpy()[:, 2] * wi[:, 2] > 0
        side_j = np.asarray(js.wo)[:, 2] * wi[:, 2] > 0
        np.testing.assert_array_equal(side_t[pick], side_j[pick])
        assert 0 < side_t[pick].mean() < 1


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("kind", list(KIND_ROWS))
def test_eval_pdf_every_kind_matches_jax(kind, variant):
    table = _kind_table(kind)
    ids, wi, wo, _, _, active = _lane_inputs(10, 2)
    ids = np.where(ids == 1, 0 if variant == VARIANTS[0] else 1, ids)
    jl, tl = _both_lanes(table, ids)
    jf, jpdf = jb.eval_pdf(jl, jnp.asarray(wi), jnp.asarray(wo),
                           jnp.asarray(active))
    f, pdf = tb.eval_pdf(tl, torch.from_numpy(wi), torch.from_numpy(wo),
                         torch.from_numpy(active))
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-5,
                               atol=1e-6, err_msg="f")
    np.testing.assert_allclose(pdf.numpy(), np.asarray(jpdf), rtol=1e-5,
                               atol=1e-6, err_msg="pdf")
    np.testing.assert_array_equal(pdf.numpy() > 0, np.asarray(jpdf) > 0)
    smooth = tb.is_smooth(tl).numpy()
    np.testing.assert_array_equal(smooth, np.asarray(jb.is_smooth(jl)))
    np.testing.assert_array_equal(tb.is_null(tl).numpy(),
                                  np.asarray(jb.is_null(jl)))
    # smooth lobes have lanes of both hemispheres lit; delta lobes none
    assert ((pdf.numpy() > 0).mean() > 0.05) == bool(smooth.any())


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("kind", list(KIND_ROWS))
def test_sample_every_kind_matches_jax(kind, variant):
    table = _kind_table(kind)
    ids, wi, _, u1, u2, active = _lane_inputs(11, 2)
    ids = np.where(ids == 1, 0 if variant == VARIANTS[0] else 1, ids)
    jl, tl = _both_lanes(table, ids)
    js = jb.sample(jl, jnp.asarray(wi), jnp.asarray(u1), jnp.asarray(u2),
                   jnp.asarray(active))
    ts = tb.sample(tl, torch.from_numpy(wi), torch.from_numpy(u1),
                   torch.from_numpy(u2), torch.from_numpy(active))
    _sample_close(ts, js, wi, u1, tl)
    assert (ts.pdf.numpy() > 0).mean() > 0.2


def test_lobe_pruning_changes_no_lane():
    """A table of a few kinds: the port with the table's static kind set
    computes only those lobes (and no two-sided flip), and gives every
    lane exactly what it gives with every lobe computed, and what the JAX
    package gives with its KindsStatic pruning."""
    table = _table([(0, False, [0.8, 0.5, 0.3], 0, 0, 0, 1.5046, 0),
                    (3, False, [1, 1, 1], 0, 0, 0, 1.5046, 0),
                    (2, False, [1, 1, 1], *AU, 0.3, 1.5046, 0.3)])
    ids, wi, wo, u1, u2, active = _lane_inputs(12, 3)
    args = [torch.from_numpy(a) for a in (wi, u1, u2, active)]
    jl, pruned = _both_lanes(table, ids, (0, 2, 3), False)
    _, full = _both_lanes(table, ids)
    assert pruned.two_sided is None and pruned.eta_re is not None
    for a, b in zip(tb.sample(pruned, *args), tb.sample(full, *args)):
        assert torch.equal(a, b)
    ev = [torch.from_numpy(a) for a in (wi, wo, active)]
    for a, b in zip(tb.eval_pdf(pruned, *ev), tb.eval_pdf(full, *ev)):
        assert torch.equal(a, b)
    js = jb.sample(jl, *map(jnp.asarray, (wi, u1, u2, active)))
    _sample_close(tb.sample(pruned, *args), js, wi, u1, pruned)
    # a diffuse-only table reads no column but the reflectance
    _, diffuse = _both_lanes(table, np.zeros(8, np.int32), (0,), False)
    assert all(getattr(diffuse, f) is None for f in
               ("two_sided", "eta_re", "eta_im", "alpha", "eta_ratio",
                "alpha_v"))


def test_fresnel_matches_jax():
    rng = np.random.default_rng(13)
    n = 20000
    cos = rng.uniform(-1.0, 1.0, n).astype(np.float32)
    cos[:3] = [0.0, 1.0, -1.0]
    eta = rng.uniform(0.5, 2.5, n).astype(np.float32)
    er = rng.uniform(0.0, 3.0, (n, 3)).astype(np.float32)
    ei = rng.uniform(0.0, 5.0, (n, 3)).astype(np.float32)
    er[:100] = ei[:100] = 0.0  # non-conductor rows of the dense dispatch
    got = tfr.fresnel_conductor(*map(torch.from_numpy, (cos, er, ei)))
    want = jfr.fresnel_conductor(*map(jnp.asarray, (cos, er, ei)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-5,
                               atol=1e-6)
    got = tfr.fresnel_dielectric(torch.from_numpy(cos), torch.from_numpy(eta))
    want = jfr.fresnel_dielectric(jnp.asarray(cos), jnp.asarray(eta))
    for name, g, w in zip(("F", "cos_t", "eta_it", "eta_ti"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    assert 0 < (got[0].numpy() == 1.0).mean() < 0.5  # some total reflection


def test_apply_texture_matches_jax():
    """The bilinear atlas lookup with repeat wrapping and a uv transform,
    at uv in [-1.5, 2.5] (negative texels: a floor modulo)."""
    rng = np.random.default_rng(14)
    atlas = rng.uniform(0.0, 1.0, (2, 9, 7, 3)).astype(np.float32)
    table = _table([(0, False, [0.5] * 3, 0, 0, 0, 1.5, 0)] * 3)
    table.update(tex_id=np.array([0, -1, 1], np.int32),
                 tex_hw=np.array([[9, 7], [1, 1], [5, 6]], np.float32),
                 tex_uv=np.array([[1, 1, 0, 0], [1, 1, 0, 0],
                                  [3, 2, -0.3, 0.25]], np.float32),
                 textures=atlas)
    ids = rng.integers(-1, 3, N).astype(np.int32)
    uv = rng.uniform(-1.5, 2.5, (N, 2)).astype(np.float32)
    jbp = jscene.BSDFParams(**{k: jnp.asarray(v) for k, v in table.items()})
    tbp = tscene.BSDFParams(**{k: torch.from_numpy(v)
                               for k, v in table.items()})
    jl = jb.gather_lane_bsdf(jbp, jnp.asarray(ids), jnp.asarray(uv))
    tl = tb.gather_lane_bsdf(tbp, torch.from_numpy(ids), torch.from_numpy(uv))
    np.testing.assert_allclose(tl.reflectance.numpy(),
                               np.asarray(jl.reflectance), rtol=1e-5,
                               atol=1e-6)
    assert np.all(tl.reflectance.numpy()[ids == 1] == 0.5)


def test_perturbed_normal_matches_jax():
    """Bump-mapped and normal-mapped shading normals of random triangles
    and uv edges (some degenerate), against the JAX package."""
    rng = np.random.default_rng(15)
    n = 4000
    atlas = rng.uniform(-1.0, 1.0, (2, 6, 8, 3)).astype(np.float32)
    table = _table([(0, False, [0.5] * 3, 0, 0, 0, 1.5, 0)] * 3)
    table.update(bump_id=np.array([0, 1, -1], np.int32),
                 bump_hw=np.array([[6, 8], [5, 5], [1, 1]], np.float32),
                 bump_uv=np.array([[2, 2, 0.1, 0], [1, 1, 0, 0],
                                   [1, 1, 0, 0]], np.float32),
                 bump_scale=np.array([0.5, 0.0, 0.0], np.float32),
                 bump_kind=np.array([1, 2, 0], np.int32),
                 bump_textures=atlas)
    ids = rng.integers(0, 3, n).astype(np.int32)
    e1 = rng.normal(size=(n, 3)).astype(np.float32)
    e2 = rng.normal(size=(n, 3)).astype(np.float32)
    ng = np.cross(e1, e2)
    ng = (ng / np.linalg.norm(ng, axis=1, keepdims=True)).astype(np.float32)
    uv = rng.uniform(-1.0, 2.0, (n, 2)).astype(np.float32)
    uv_e1 = rng.normal(size=(n, 2)).astype(np.float32)
    uv_e2 = rng.normal(size=(n, 2)).astype(np.float32)
    uv_e2[:50] = uv_e1[:50]  # degenerate uv edges keep ng
    args = (ids, ng, uv, e1, e2, uv_e1, uv_e2)
    jbp = jscene.BSDFParams(**{k: jnp.asarray(v) for k, v in table.items()})
    tbp = tscene.BSDFParams(**{k: torch.from_numpy(v)
                               for k, v in table.items()})
    want = np.asarray(jscene._perturbed_normal(jbp, *map(jnp.asarray, args)))
    got = tscene._perturbed_normal(tbp, *map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    moved = np.abs(got - ng).max(axis=1) > 1e-3
    assert moved[ids == 0].mean() > 0.5 and moved[ids == 1].mean() > 0.5
    assert not moved[ids == 2].any() and not moved[:50].any()


def test_math_rounds_correctly():
    """``core/math.py``'s sqrt and cos_sin return the correctly rounded
    float32 (the float64 result rounded) and ``divide`` one rounded
    division: the same bits on the card (tests/test_torch_cuda.py)."""
    from mitransient_tpu_torch.core import math as tm

    rng = np.random.default_rng(17)
    x = rng.uniform(-4.0, 4.0, 1 << 18).astype(np.float32)
    tx = torch.from_numpy(x)
    for f, nf in ((lambda a: tm.sqrt(a.abs()), lambda a: np.sqrt(np.abs(a))),
                  (lambda a: tm.cos_sin(a)[0], np.cos),
                  (lambda a: tm.cos_sin(a)[1], np.sin)):
        want = nf(x.astype(np.float64)).astype(np.float32)
        np.testing.assert_array_equal(f(tx).numpy(), want)
    np.testing.assert_array_equal(tm.divide(tx, 0.02).numpy(),
                                  x / np.float32(0.02))
