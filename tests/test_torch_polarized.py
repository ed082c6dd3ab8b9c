"""The port's polarized variants against the JAX package on the CPU.

- ``core/mueller.py``, dense and structured, and ``bsdf/polarized.py`` on
  seeded inputs: rtol 1e-5 with an atol of 1e-6 of the largest value
  (XLA:CPU contracts multiply-adds into FMAs, the port rounds each op);
  the pending-rotator carry against the dense Mueller chain (a mirror of
  tests/test_polarized.py:228 on the port's functions).
- ``vis_polarized``'s numpy functions: equal to the JAX package's.
- Renders: the ``cbox_polarized`` golden with no element out under
  test_golden's rule (rtol 5e-4, atol 5e-5 * max), and mono_polarized and
  rgb_polarized with a gold GGX small box (``torch_cases.variant_case``)
  through the regen loop and the multi-pass accumulator, per sample under
  the same rule with no element out and ray counts within 0.1 %.
- The physics configurations of tests/test_polarized.py:32-92 on the port.
- NLOS, volumetric and differentiable renders of a polarized or spectral
  scene run, by the JAX package's routes (``test_variant_refusals``;
  per sample against the JAX package in tests/test_torch_variants_*.py).
"""
import copy
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitransient_tpu as mitr
import mitransient_tpu_torch as mt
from mitransient_tpu import vis_polarized as jvis
from mitransient_tpu.bsdf import api as jbsdf
from mitransient_tpu.bsdf import polarized as jpol
from mitransient_tpu.core import mueller as jmu
from mitransient_tpu_torch import vis_polarized as tvis
from mitransient_tpu_torch.bsdf import api as tbsdf
from mitransient_tpu_torch.bsdf import polarized as tpol
from mitransient_tpu_torch.core import mueller as tmu
from torch_cases import (
    DOP_Q95_MAX,
    GOLD_GGX_BOX,
    VARIANT_REGEN,
    golden_mismatch,
    nlos_scene,
    small_cbox,
    spy_routes,
    stokes_checks,
    variant_render,
    vol_cbox,
    with_variant,
)

torch.set_num_threads(1)

RTOL = 1e-5
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "cbox_polarized.npz")


def _close(got, want, rtol=RTOL):
    got = np.asarray(got.detach().numpy() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    atol = 1e-6 * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _soa(t):
    """A JAX structured matrix (tuple of 16) or vector (tuple of 4) ->
    the port's layout (4, 4, ...) or (4, ...)."""
    a = np.stack([np.asarray(e) for e in t])
    return a.reshape((4, 4) + a.shape[1:]) if len(t) == 16 else a


def _tup(a):
    """The port's layout as numpy -> the JAX tuple form."""
    a = np.asarray(a)
    flat = a.reshape((-1,) + a.shape[2:]) if a.shape[:2] == (4, 4) else a
    return tuple(jnp.asarray(e) for e in flat)


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _perp(rng, w):
    """A random vector perpendicular to each row of ``w``, unnormalized."""
    v = rng.normal(size=w.shape)
    v = v - (v * w).sum(1, keepdims=True) * w
    return (v * rng.uniform(0.5, 2.0, (w.shape[0], 1))).astype(np.float32)


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


# --------------------------------------------------------------------------
# core/mueller.py
# --------------------------------------------------------------------------

N, C = 257, 3


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(21)
    w = _unit(rng, N)
    return dict(
        w=w, a=_perp(rng, w), b=_perp(rng, w), w2=_unit(rng, N),
        c=_perp(rng, w), d=_perp(rng, w),
        M=rng.normal(size=(N, 4, 4, C)).astype(np.float32),
        M2=rng.normal(size=(N, 4, 4, C)).astype(np.float32),
        v=rng.normal(size=(N, 4, C)).astype(np.float32),
        cos=rng.uniform(-1, 1, N).astype(np.float32),
        eta_re=rng.uniform(0.1, 2.5, (N, C)).astype(np.float32),
        eta_im=rng.uniform(0.0, 4.0, (N, C)).astype(np.float32),
        theta=rng.uniform(0, 2 * np.pi, N).astype(np.float32),
        s=rng.normal(size=(N, C)).astype(np.float32),
        mask=rng.random((N, 1)) < 0.5,
        angles=[rng.normal(size=(N, 1)).astype(np.float32)
                for _ in range(4)],
        abcs=[rng.normal(size=(N, C)).astype(np.float32) for _ in range(4)],
    )


def test_dense_bases_and_rotators(inputs):
    x = inputs
    (jw, ja, jb, jth), (tw, ta, tb, tth) = _both(x["w"], x["a"], x["b"],
                                                 x["theta"])
    _close(tmu.stokes_basis(tw), jmu.stokes_basis(jw))
    _close(tmu._rotator(tth), jmu._rotator(jth))
    _close(tmu.unit_angle(tmu.stokes_basis(tw), tw),
           jmu.unit_angle(jmu.stokes_basis(jw), jw))
    _close(tmu.rotate_stokes_basis(tw, ta, tb),
           jmu.rotate_stokes_basis(jw, ja, jb))
    for f in ("rotator_angles", "rotator_angles_unnorm"):
        for g, want in zip(getattr(tmu, f)(tw, ta, tb),
                           getattr(jmu, f)(jw, ja, jb)):
            _close(g, want)
    (jw2, jc, jd, jM), (tw2, tc, td, tM) = _both(x["w2"], x["c"], x["d"],
                                                 x["M"][..., 0])
    jc, tc = jmu.stokes_basis(jw2), tmu.stokes_basis(tw2)
    _close(tmu.rotate_mueller_basis(tM, tw, ta, tb, tw2, tc, td),
           jmu.rotate_mueller_basis(jM, jw, ja, jb, jw2, jc, jd))


def test_dense_products_and_fresnel(inputs):
    x = inputs
    (jM, jM2, jv, jcos, jre, jim, js), (tM, tM2, tv, tcos, tre, tim, ts) = \
        _both(x["M"], x["M2"], x["v"], x["cos"], x["eta_re"], x["eta_im"],
              x["s"])
    _close(tmu.mueller_product(tM, tM2), jmu.mueller_product(jM, jM2))
    _close(tmu.mueller_matvec(tM, tv), jmu.mueller_matvec(jM, jv))
    R1 = jmu._rotator(jnp.asarray(x["theta"]))
    R2 = jmu._rotator(jnp.asarray(x["theta"][::-1].copy()))
    _close(tmu.rotate_mueller_product(torch.from_numpy(np.array(R1)), tM,
                                      torch.from_numpy(np.array(R2))),
           jmu.rotate_mueller_product(R1, jM, R2))
    _close(tmu.linear_polarizer(ts), jmu.linear_polarizer(js))
    _close(tmu.depolarizer(ts), jmu.depolarizer(js))
    for g, want in zip(tmu.specular_abcs(tcos[:, None], tre, tim),
                       jmu.specular_abcs(jcos[:, None], jre, jim)):
        _close(g, want)
    _close(tmu.specular_reflection_mueller(tcos[:, None], tre, tim),
           jmu.specular_reflection_mueller(jcos[:, None], jre, jim))
    ja, ta = _both(*x["abcs"])
    jang, tang = _both(*x["angles"])
    _close(tmu.specular_sandwich(*ta, *tang),
           jmu.specular_sandwich(*ja, *jang))
    _close(tmu.specular_sandwich_col0(ta[0], ta[1], tang[2], tang[3]),
           jmu.specular_sandwich_col0(ja[0], ja[1], jang[2], jang[3]))


def test_structured_ops(inputs):
    x = inputs
    jM, jM2 = (jmu.msoa_from_dense(jnp.asarray(x[k])) for k in ("M", "M2"))
    tM, tM2 = (tmu.msoa_from_dense(torch.from_numpy(x[k]))
               for k in ("M", "M2"))
    _close(tM, _soa(jM))
    _close(tmu.msoa_to_dense(tM), jmu.msoa_to_dense(jM))
    _close(tmu.msoa_product(tM, tM2), _soa(jmu.msoa_product(jM, jM2)))
    tv = torch.from_numpy(x["v"]).movedim(1, 0)
    jv = _tup(tv.numpy())
    _close(tmu.msoa_matvec(tM, tv), _soa(jmu.msoa_matvec(jM, jv)))
    s = torch.from_numpy(x["s"])
    _close(tmu.msoa_scale(tM, s),
           _soa(jmu.msoa_scale(jM, jnp.asarray(x["s"]))))
    mask = x["mask"]
    _close(tmu.msoa_where(torch.from_numpy(mask), tM, tM2),
           _soa(jmu.msoa_where(jnp.asarray(mask), jM, jM2)))
    _close(tmu.msoa_identity(s), _soa(jmu.msoa_identity(jnp.asarray(x["s"]))))
    ja, ta = _both(*x["abcs"])
    jang, tang = _both(*x["angles"])
    _close(tmu.specular_sandwich_soa(*ta, *tang),
           _soa(jmu.specular_sandwich_soa(*ja, *jang)))
    _close(tmu.rotator_soa(tang[0], tang[1]),
           _soa(jmu.rotator_soa(jang[0], jang[1])))
    for g, want in zip(tmu.rot2_compose(*tang), jmu.rot2_compose(*jang)):
        _close(g, want)
    _close(tmu.msoa_apply_rotator_cols(tM, tang[0], tang[1]),
           _soa(jmu.msoa_apply_rotator_cols(jM, jang[0], jang[1])))
    _close(tmu.msoa_apply_fresnel_cols(tM, *ta),
           _soa(jmu.msoa_apply_fresnel_cols(jM, *ja)))
    _close(tmu.msoa_depolarize_cols(tM, ta[0]),
           _soa(jmu.msoa_depolarize_cols(jM, ja[0])))
    _close(tmu.stokes_rotate(tv, tang[0], tang[1]),
           _soa(jmu.stokes_rotate(jv, jang[0], jang[1])))
    _close(tmu.msoa_apply_sandwich(tM, *ta, *tang),
           _soa(jmu.msoa_apply_sandwich(jM, *ja, *jang)))
    _close(tmu.stokes_apply_sandwich(tv, *ta, *tang),
           _soa(jmu.stokes_apply_sandwich(jv, *ja, *jang)))


def test_pending_rotator_carry_matches_dense_chain():
    """The port's structured bounce update (stored beta @ R(pend), the
    Givens and Fresnel column applies, ``path.polarized_update``'s
    arithmetic) equals the dense chain beta @ (R_out F R_in) for random
    sequences of specular, depolarizing and null lobes (the rule of
    tests/test_polarized.py:228)."""
    rng = np.random.RandomState(11)
    n, C = 64, 1

    def rnd():
        return torch.from_numpy(rng.uniform(-1, 1, (n, C)).astype(np.float32))

    def angles():
        th = rng.uniform(0, 2 * np.pi, (n,)).astype(np.float32)
        return torch.from_numpy(np.cos(th)), torch.from_numpy(np.sin(th))

    pc2, ps2 = angles()
    zeros = torch.zeros((n, C))
    dense = tmu.msoa_product(tmu.msoa_identity(zeros),
                             tmu.rotator_soa(pc2, ps2)[..., None]
                             .expand(4, 4, n, C))
    stored = tmu.msoa_identity(zeros)
    pend = (pc2, ps2)
    for _bounce in range(4):
        A, B, Cc, S = rnd(), rnd(), rnd(), rnd()
        ci2, si2 = angles()
        co2, so2 = angles()
        kind = rng.randint(0, 3, (n,))  # 0 specular, 1 depolarizer, 2 null
        is_spec = torch.from_numpy(kind == 0)
        is_null = torch.from_numpy(kind == 2)
        f = rnd()
        M = tmu.specular_sandwich_soa(A, B, Cc, S, ci2[:, None],
                                      si2[:, None], co2[:, None],
                                      so2[:, None])
        depol = torch.zeros_like(M)
        depol[0, 0] = 1.0
        M = torch.where(is_spec[:, None], M,
                        torch.where(is_null[:, None],
                                    tmu.msoa_identity(zeros), depol))
        dense = tmu.msoa_product(dense, M * f)

        cc, cs = tmu.rot2_compose(pend[0], pend[1], co2, so2)
        spec = tmu.msoa_apply_fresnel_cols(
            tmu.msoa_apply_rotator_cols(stored, cc[:, None], cs[:, None]),
            A * f, B * f, Cc * f, S * f)
        other = stored * f
        other = torch.cat([other[:, :1],
                           other[:, 1:] * is_null[:, None].float()], dim=1)
        stored = torch.where(is_spec[:, None], spec, other)
        pend = (torch.where(is_spec, ci2, torch.where(is_null, pend[0], 1.0)),
                torch.where(is_spec, si2, torch.where(is_null, pend[1], 0.0)))

        colP = torch.stack([rnd(), rnd(), rnd(), rnd()])
        want = tmu.msoa_matvec(dense, colP)
        got = tmu.msoa_matvec(stored, tmu.stokes_rotate(
            colP, pend[0][:, None], pend[1][:, None]))
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                                   atol=2e-5)
        np.testing.assert_allclose(stored[:, 0].numpy(), dense[:, 0].numpy(),
                                   rtol=2e-4, atol=2e-5)


def test_spectrum_helpers_match_jax(inputs):
    """core/spectrum.py's spectrum ops on polarized and unpolarized
    spectra."""
    from mitransient_tpu.core import spectrum as jsp
    from mitransient_tpu_torch.core import spectrum as tsp

    x = inputs
    (jM, jM2, js), (tM, tM2, ts) = _both(x["M"], x["M2"], x["s"])
    lanes = jnp.asarray(x["cos"])
    for v in ("mono", "rgb_polarized", "spectral"):
        jv, tv = jsp._KNOWN[v], tsp._KNOWN[v]
        assert tuple(jv) == tuple(tv)
        _close(tsp.spec_zeros(tv, (5,)), jsp.spec_zeros(jv, (5,)))
        _close(tsp.spec_identity(tv, (5,)), jsp.spec_identity(jv, (5,)))
    for ja, jb, ta, tb in ((jM, jM2, tM, tM2), (jM, js, tM, ts),
                           (js, jM, ts, tM), (js, js, ts, ts)):
        _close(tsp.spec_mul(ta, tb), jsp.spec_mul(ja, jb))
    for j, t in ((jM, tM), (js, ts)):
        assert tsp.is_polarized_spec(t) == jsp.is_polarized_spec(j)
        _close(tsp.spec_scale(t, torch.from_numpy(x["cos"])),
               jsp.spec_scale(j, lanes))
        _close(tsp.unpolarized(t), jsp.unpolarized(j))
        _close(tsp.luminance(t), jsp.luminance(j))
    _close(tsp.to_stokes(tM), jsp.to_stokes(jM))
    with pytest.raises(ValueError, match="polarized"):
        tsp.to_stokes(ts)


# --------------------------------------------------------------------------
# bsdf/polarized.py
# --------------------------------------------------------------------------

def _lobes_scene(pkg):
    """Every polarization class: diffuse walls, a rough gold and a smooth
    copper conductor, a glass box and a null back wall."""
    d = small_cbox(pkg, 4, 4, 10, 2)
    d["small-box"]["bsdf"] = dict(GOLD_GGX_BOX)
    d["large-box"]["bsdf"] = {"type": "dielectric"}
    d["ceiling"]["bsdf"] = {"type": "conductor", "material": "Cu"}
    d["back"]["bsdf"] = {"type": "null"}
    return d


@pytest.mark.parametrize("variant", ["mono_polarized", "rgb_polarized"])
def test_polarized_bsdf_matches_jax(variant):
    desc = _lobes_scene(mt)
    with with_variant(mitr, variant):
        jsc = mitr.load_dict(copy.deepcopy(desc))
    with with_variant(mt, variant):
        tsc = mt.load_dict(desc, device="cpu")
    rng = np.random.default_rng(5)
    n = 512
    rows = tsc.data.bsdf.kind.shape[0]
    ids = rng.integers(0, rows, n).astype(np.int32)
    p_in, p_out = _unit(rng, n), _unit(rng, n)
    p_out[:16] = -p_in[:16]  # degenerate planes of incidence
    cos = rng.uniform(-1, 1, n).astype(np.float32)
    trans = rng.random(n) < 0.3
    jlb = jbsdf.gather_lane_bsdf(jsc.data.bsdf, jnp.asarray(ids))
    tlb = tbsdf.gather_lane_bsdf(tsc.data.bsdf, torch.from_numpy(ids), None,
                                 tsc.data.bsdf_kinds)
    assert sorted(set(tlb.kind.tolist())) == [0, 1, 2, 3, 4]
    (jpi, jpo, jc, jt), (tpi, tpo, tc, tt) = _both(p_in, p_out, cos, trans)
    _close(tpol.polarization_factor(tlb, tpi, tpo, tc, tt),
           jpol.polarization_factor(jlb, jpi, jpo, jc, jt))
    _close(tpol.polarization_factor_soa(tlb, tpi, tpo, tc, tt),
           _soa(jpol.polarization_factor_soa(jlb, jpi, jpo, jc, jt)))
    _close(tpol.polarization_factor_col0(tlb, tpi, tpo, tc),
           jpol.polarization_factor_col0(jlb, jpi, jpo, jc))
    _close(tpol.polarization_factor_col0_soa(tlb, tpi, tpo, tc),
           _soa(jpol.polarization_factor_col0_soa(jlb, jpi, jpo, jc)))
    got = tpol.specular_params_soa(tlb, tpi, tpo, tc, tt)
    want = jpol.specular_params_soa(jlb, jpi, jpo, jc, jt)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        _close(g, w)
    vert = np.array([0.0, 1.0, 0.0], np.float32)
    (jd, jv), (td, tv) = _both(p_in, vert)
    for g, w in zip(tpol.sensor_alignment_angles(td, tv),
                    jpol.sensor_alignment_angles(jd, jv)):
        _close(g, w)
    _close(tpol.sensor_alignment_soa(td, tv, 3),
           _soa(jpol.sensor_alignment_soa(jd, jv, 3)))
    _close(tpol.sensor_alignment_mueller(td, tv),
           jpol.sensor_alignment_mueller(jd, jv))


# --------------------------------------------------------------------------
# vis_polarized.py
# --------------------------------------------------------------------------

def test_vis_polarized_matches_jax():
    rng = np.random.default_rng(8)
    s = rng.normal(size=(9, 7, 4)).astype(np.float32)
    s[..., 0] = np.abs(s[..., 0]) + 1.0
    s[0, 0, 1:] = 0.0  # an unpolarized pixel: zero saturation
    for f in ("degree_of_polarization", "degree_of_linear_polarization",
              "degree_of_circular_polarization",
              "angle_of_linear_polarization"):
        np.testing.assert_array_equal(getattr(tvis, f)(s),
                                      getattr(jvis, f)(s))
    for mode in ("dop", "aolp", "top", "chirality"):
        got = tvis.polarization_generate_false_color(s, mode)
        np.testing.assert_array_equal(
            got, jvis.polarization_generate_false_color(s, mode))
        assert got.shape == (9, 7, 3) and 0 <= got.min() <= got.max() <= 1
    video = rng.uniform(size=(5, 4, 6, 4)).astype(np.float32)
    for norm in (True, False):
        np.testing.assert_array_equal(
            tvis.tonemap_transient(video, 2.0, norm),
            jvis.tonemap_transient(video, 2.0, norm))
    with pytest.raises(ValueError, match="unknown mode"):
        tvis.polarization_generate_false_color(s, "hue")


# --------------------------------------------------------------------------
# Renders
# --------------------------------------------------------------------------

def test_set_variant_accepts_every_variant():
    old = mt.variant()
    try:
        for name in ("mono", "rgb", "mono_polarized", "rgb_polarized",
                     "spectral", "spectral_polarized",
                     "llvm_ad_mono_polarized", "cuda_spectral_polarized"):
            mt.set_variant(name)
            mitr.set_variant(name)
            assert mt.variant() == tuple(mitr.variant()), name
            assert mt.variant().name == mitr.variant().name
            assert (mt.is_polarized(), mt.is_monochromatic(), mt.is_rgb()) \
                == (mitr.is_polarized(), mitr.is_monochromatic(),
                    mitr.is_rgb())
        mt.set_variant(mt.core.spectrum.Variant(3, True, True))
        assert mt.variant().name == "spectral_polarized"
        with pytest.raises(ValueError, match="unknown variant"):
            mt.set_variant("hyperspectral")
    finally:
        mt.set_variant(old)
        mitr.set_variant("rgb")


def test_cbox_polarized_golden():
    g = np.load(GOLDEN)
    with with_variant(mt, "mono_polarized"):
        scene = mt.load_dict(small_cbox(mt, 8, 8, 80, 4), device="cpu")
    s, t = mt.render(scene, spp=4, seed=0)
    for key, got in (("steady", s), ("transient", t)):
        m = golden_mismatch(got.numpy(), g[key])
        assert m["shape_ok"] and m["n_bad"] == 0, (key, m)


@pytest.fixture(scope="module")
def jax_renders():
    cache = {}

    def get(name, multipass):
        if (name, multipass) not in cache:
            s, t, stats = variant_render(mitr, name, multipass)
            cache[name, multipass] = (np.asarray(s), np.asarray(t),
                                      float(np.asarray(stats["rays"])))
        return cache[name, multipass]

    return get


@pytest.mark.parametrize("multipass", [False, True])
@pytest.mark.parametrize("name", VARIANT_REGEN)
def test_render_matches_jax(jax_renders, name, multipass):
    js, jt, jrays = jax_renders(name, multipass)
    s, t, stats = variant_render(mt, name, multipass, device="cpu")
    C = 4 if name == "mono_polarized" else 12
    assert s.shape == (8, 8, C) and t.shape == (8, 8, 40, C)
    for got, want in ((s, js), (t, jt)):
        m = golden_mismatch(got.numpy(), want)
        assert m["shape_ok"] and m["n_bad"] == 0, m
    assert abs(int(stats["rays"]) - jrays) <= 1e-3 * jrays
    # the gold box polarizes: Q and U are not zero (2.9e-4 to 1.6e-3 of I
    # here, over the color channels), and the Stokes vectors are physical
    pol = stokes_checks(s.numpy().reshape(8, 8, 4, C // 4).sum(-1))
    assert pol["qu_share"] > 1e-4 and pol["dop_q95"] <= DOP_Q95_MAX


def _pol_cbox(box_bsdf=None, w=16, bins=300, max_depth=4):
    """tests/test_polarized.py:pol_cbox."""
    d = small_cbox(mt, w, w, bins, max_depth)
    if box_bsdf is not None:
        d["small-box"]["bsdf"] = box_bsdf
    return d


def _render_pol(desc, spp, variant="mono_polarized", **kw):
    with with_variant(mt, variant):
        scene = mt.load_dict(desc, device="cpu")
    s, t = mt.render(scene, spp=spp, seed=0, **kw)
    return s.numpy(), t.numpy()


def test_stokes_validity_and_diffuse_scene():
    """tests/test_polarized.py:32-59: shapes, finite, I >= 0, DoP <= 1 up
    to noise; an all-diffuse box leaves Q, U, V near 0."""
    s, t = _render_pol(_pol_cbox(), 16)
    assert s.shape == (16, 16, 4) and t.shape == (16, 16, 300, 4)
    assert np.all(np.isfinite(s)) and np.all(np.isfinite(t))
    assert s[..., 0].min() >= -1e-6 and s[..., 0].sum() > 0
    assert stokes_checks(s)["dop_q95"] <= DOP_Q95_MAX
    s, _t = _render_pol(_pol_cbox(), 32)
    assert np.abs(s[..., 1:]).sum() / max(s[..., 0].sum(), 1e-9) < 1e-3


def test_gold_box_polarizes():
    """tests/test_polarized.py:62-77."""
    s, _t = _render_pol(_pol_cbox({"type": "roughconductor",
                                   "material": "Au", "alpha": 0.1},
                                  max_depth=5), 64)
    dop = np.hypot(s[..., 1], s[..., 2]) / np.maximum(s[..., 0], 1e-6)
    assert np.quantile(dop[s[..., 0] > 1e-3], 0.99) > 0.02


def test_intensity_matches_unpolarized_render():
    """tests/test_polarized.py:80-96: the Stokes I of a depolarizing scene
    is the mono render's (the same sample stream)."""
    s_p, t_p = _render_pol(_pol_cbox(), 32)
    s_u, t_u = _render_pol(_pol_cbox(), 32, variant="mono")
    np.testing.assert_allclose(s_p[..., 0], s_u[..., 0], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(t_p[..., 0], t_u[..., 0], rtol=1e-3,
                               atol=1e-6)


@pytest.mark.parametrize("variant", ["mono_polarized", "spectral"])
def test_variant_refusals(monkeypatch, variant):
    """The calls the port once refused under a polarized or spectral
    variant (ROADMAP item 16b) now render and differentiate: NLOS and
    volumetric renders, and render_backward (default and full AD) and
    render_forward of a box, a fog box and an NLOS capture, each finite
    and of the variant's shape, by the JAX package's route: a polarized
    fog and every NLOS capture through full AD, a spectral fog through
    the PRB replay, forward mode through the whole primal."""
    seen = spy_routes(monkeypatch, mt)
    with with_variant(mt, variant):
        nlos = mt.load_dict(nlos_scene(sx=2, sy=2), device="cpu")
        vol = mt.load_dict(vol_cbox(mt, sigma_t=2.0), device="cpu")
        box = mt.load_dict(small_cbox(mt, 4, 4, 10, 2), device="cpu")
    mt.nlos.focus_emitter_at_relay_wall_pixel([1.0, 1.0], nlos)
    C = 4 if variant == "mono_polarized" else 3
    for scene, hw, bins in ((nlos, (2, 2), 300), (vol, (8, 8), 100)):
        for kw in ({}, {"regenerate": False}):
            s, t = mt.render(scene, spp=2, **kw)
            assert s.shape == hw + (C,) and t.shape == hw + (bins, C)
            assert torch.isfinite(t).all() and float(s[..., 0].sum()) > 0
    vol_route = "fullad" if variant == "mono_polarized" else "prb_vol"
    for sc, route in ((box, "fullad"), (vol, vol_route), (nlos, "fullad")):
        seen.clear()
        g = mt.render_backward(sc, (None, None), spp=2)
        g_ad = mt.render_backward(sc, (None, None), spp=2, method="fullad")
        d_s, d_t = mt.render_forward(sc, {}, spp=2)
        assert seen == [route, "fullad", "jvp"]
        for grads in (g, g_ad):
            assert "__tables__" in grads and all(
                torch.isfinite(v).all() for k, v in grads.items()
                if k != "__tables__")
        fc = sc.sensors[0].film
        assert d_t.shape == (fc.height, fc.width, fc.temporal_bins, C)
        assert torch.isfinite(d_s).all() and torch.isfinite(d_t).all()


@pytest.mark.parametrize("name, multipass", [
    ("mono_polarized", False), ("mono_polarized", True),
    ("spectral_polarized", True)])
def test_splat_values_are_contiguous(monkeypatch, name, multipass):
    """K3's wrapper takes only contiguous (N, C) values on the card; the
    Stokes packing of a mono Stokes vector could otherwise hand it a
    strided view."""
    from mitransient_tpu_torch.film import transient_film as tf

    seen = []
    splat = tf.splat_accumulate

    def check(film, *events, spp):
        seen.extend(e.is_contiguous() for e in events if e is not None)
        splat(film, *events, spp=spp)

    monkeypatch.setattr(tf, "splat_accumulate", check)
    variant_render(mt, name, multipass, device="cpu")
    assert seen and all(seen)
