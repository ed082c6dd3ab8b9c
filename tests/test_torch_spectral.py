"""The port's spectral variants against the JAX package on the CPU.

- ``core/spectra.py``: the wavelength draw of ``SpectralCtx.make`` is
  bit-equal to ``jax.random``; the hero wavelengths agree within
  ``WL_ULPS`` float32 ulps and their pdf within ``PDF_RTOL`` (XLA:CPU's
  float32 ``atanh`` and ``cosh`` are not correctly rounded, the port's go
  through float64), and the CIE fits, D65, the Smits uplift, the IOR
  interpolation and the sRGB conversions within rtol 1e-5 (atol 1e-6 of
  the largest value).
- The physics of tests/test_spectral.py:14-41, 123-177 on the port: the
  proposal pdf is normalized, the uplift round-trips, the spectral box
  agrees with the rgb box, spectral_polarized's S0 with spectral, and a
  gold box polarizes under spectral_polarized.
- Renders: the ``cbox_spectral`` golden with no element out under
  test_golden's rule, and spectral and spectral_polarized with a gold GGX
  small box (``torch_cases.variant_case``, multi-pass: the JAX package
  never sends a spectral scene to its regen loop) per sample under the
  same rule with no element out.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitransient_tpu as mitr
import mitransient_tpu_torch as mt
from mitransient_tpu.bsdf import api as jbsdf
from mitransient_tpu.core import rng as jrng
from mitransient_tpu.core import spectra as JS
from mitransient_tpu_torch.bsdf import api as tbsdf
from mitransient_tpu_torch.core import rng as trng
from mitransient_tpu_torch.core import spectra as TS
from torch_cases import (
    DOP_Q95_MAX,
    GOLD_GGX_BOX,
    golden_mismatch,
    small_cbox,
    stokes_checks,
    variant_render,
    with_variant,
)

torch.set_num_threads(1)

WL_ULPS = 2  # float32 ulps of the hero wavelengths (measured: 2)
PDF_RTOL = 5e-6  # the wavelength pdf (measured: 2.0e-6)
RTOL = 1e-5
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "cbox_spectral.npz")
LUMA = np.array([0.2126, 0.7152, 0.0722])


def _close(got, want, rtol=RTOL):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    atol = 1e-6 * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def ctx():
    """The same wavefront's hero wavelengths in both packages (seed 7,
    pass 3, 2^14 lanes)."""
    n = 1 << 14
    jk = jrng.Sampler(jnp.uint32(7), n, stream=jnp.uint32(3)).key
    tk = trng.Sampler(7, n, stream=3).key
    return n, jk, tk, JS.SpectralCtx.make(jk, n), TS.SpectralCtx.make(tk, n)


def test_wavelength_draw_matches_jax(ctx):
    import jax

    n, jk, tk, jc, tc = ctx
    u = jax.random.uniform(jax.random.fold_in(jk, jnp.uint32(0x57AC)), (n,))
    ut = trng.uniform(tk, TS.SPECTRAL_STREAM_TAG, (n,))
    assert np.array_equal(np.asarray(u), ut.numpy())
    jwl, twl = np.asarray(jc.wl), tc.wl.numpy()
    assert twl.shape == (n, TS.N_WL) and twl.dtype == np.float32
    ulp = np.spacing(np.maximum(np.abs(jwl), np.abs(twl)))
    assert np.all(np.abs(twl - jwl) <= WL_ULPS * ulp)
    np.testing.assert_allclose(tc.wl_pdf.numpy(), np.asarray(jc.wl_pdf),
                               rtol=PDF_RTOL)
    assert TS._Y_INT == JS._Y_INT and TS._D65_NORM == JS._D65_NORM


def test_colorimetry_matches_jax(ctx):
    """On the port's own wavelengths in both packages, so that only the
    function under test differs."""
    n, _jk, _tk, _jc, tc = ctx
    rng = np.random.default_rng(3)
    wl = tc.wl.numpy()
    wl[:8, 0] = [350.0, 360.0, 379.0, 380.0, 720.0, 721.0, 830.0, 840.0]
    jwl, twl = jnp.asarray(wl), torch.from_numpy(wl)
    _close(TS.cie_xyz(twl), JS.cie_xyz(jwl))
    _close(TS.d65(twl), JS.d65(jwl))
    rgb = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    rgb[:64] = rgb[:64, :1]  # grey: ties between the channels
    _close(TS.srgb_uplift(torch.from_numpy(rgb), twl),
           JS.srgb_uplift(jnp.asarray(rgb), jwl))
    eta = rng.uniform(0.1, 3.0, (n, 3)).astype(np.float32)
    _close(TS._interp_rgb(torch.from_numpy(eta), twl),
           JS._interp_rgb(jnp.asarray(eta), jwl))
    u = rng.uniform(0, 1, (n,)).astype(np.float32)
    _close(TS.sample_rgb_spectrum(torch.from_numpy(u)),
           JS.sample_rgb_spectrum(jnp.asarray(u)))
    _close(TS.pdf_rgb_spectrum(twl), JS.pdf_rgb_spectrum(jwl))
    pdf = TS.pdf_rgb_spectrum(twl)
    v = rng.uniform(0, 1, (n, TS.N_WL)).astype(np.float32)
    _close(TS.spectrum_to_srgb(torch.from_numpy(v), twl, pdf),
           JS.spectrum_to_srgb(jnp.asarray(v), jwl, jnp.asarray(pdf.numpy())))
    jc = JS.SpectralCtx(jwl, jnp.asarray(pdf.numpy()))
    tc = TS.SpectralCtx(twl, pdf)
    v16 = rng.normal(size=(n, 4 * TS.N_WL)).astype(np.float32)
    _close(tc.to_film_stokes(torch.from_numpy(v16)),
           jc.to_film_stokes(jnp.asarray(v16)))
    e1 = rng.uniform(0, 5, (n, 1)).astype(np.float32)
    _close(tc.emission(torch.from_numpy(e1)), jc.emission(jnp.asarray(e1)))


def test_uplift_lane_bsdf_matches_jax(ctx):
    n, _jk, _tk, _jc, tc = ctx
    d = small_cbox(mt, 4, 4, 10, 2)
    d["small-box"]["bsdf"] = dict(GOLD_GGX_BOX)
    with with_variant(mitr, "spectral"):
        jsc = mitr.load_dict(d)
    with with_variant(mt, "spectral"):
        tsc = mt.load_dict(d, device="cpu")
    ids = np.random.default_rng(4).integers(
        0, tsc.data.bsdf.kind.shape[0], n).astype(np.int32)
    jc = JS.SpectralCtx(jnp.asarray(tc.wl.numpy()),
                        jnp.asarray(tc.wl_pdf.numpy()))
    jlb = jc.uplift_lb(jbsdf.gather_lane_bsdf(jsc.data.bsdf,
                                              jnp.asarray(ids)))
    tlb = tc.uplift_lb(tbsdf.gather_lane_bsdf(
        tsc.data.bsdf, torch.from_numpy(ids), None, tsc.data.bsdf_kinds))
    for f in ("reflectance", "eta_re", "eta_im"):
        _close(getattr(tlb, f), getattr(jlb, f))


def test_pdf_normalized_and_uplift_roundtrip():
    """tests/test_spectral.py:14-41 on the port."""
    wl = torch.linspace(TS.WL_MIN, TS.WL_MAX, 2001)
    pdf = TS.pdf_rgb_spectrum(wl).numpy()
    assert abs(np.trapezoid(pdf, wl.numpy()) - 1.0) < 1e-3
    u = torch.from_numpy(np.random.RandomState(0).rand(100000)
                         .astype(np.float32))
    est = (1.0 / TS.pdf_rgb_spectrum(TS.sample_rgb_spectrum(u))).mean()
    assert abs(float(est) - (TS.WL_MAX - TS.WL_MIN)) < 0.01 * (
        TS.WL_MAX - TS.WL_MIN)
    n = 50000
    u = torch.from_numpy(np.random.RandomState(1).rand(n).astype(np.float32))
    wl, pdf = TS.sample_shifted(u)
    for rgb, tol in (((1.0, 1.0, 1.0), 0.02), ((0.2, 0.5, 0.8), 0.05),
                     ((0.7, 0.3, 0.1), 0.05)):
        refl = TS.srgb_uplift(torch.tensor(rgb).expand(n, 3), wl)
        out = TS.spectrum_to_srgb(refl * TS.d65(wl), wl, pdf).mean(0)
        np.testing.assert_allclose(out.numpy(), rgb, atol=tol)


def test_cbox_spectral_golden():
    g = np.load(GOLDEN)
    with with_variant(mt, "spectral"):
        scene = mt.load_dict(small_cbox(mt, 8, 8, 80, 4), device="cpu")
    s, t = mt.render(scene, spp=4, seed=0)
    for key, got in (("steady", s), ("transient", t)):
        m = golden_mismatch(got.numpy(), g[key])
        assert m["shape_ok"] and m["n_bad"] == 0, (key, m)


@pytest.mark.parametrize("name", ["spectral", "spectral_polarized"])
def test_render_matches_jax(name):
    js, jt, jstats = variant_render(mitr, name, True)
    s, t, stats = variant_render(mt, name, True, device="cpu")
    C = 12 if name == "spectral_polarized" else 3
    assert s.shape == (8, 8, C) and t.shape == (8, 8, 40, C)
    for got, want in ((s, js), (t, jt)):
        m = golden_mismatch(got.numpy(), np.asarray(want))
        assert m["shape_ok"] and m["n_bad"] == 0, m
    jrays = float(np.asarray(jstats["rays"]))
    assert abs(int(stats["rays"]) - jrays) <= 1e-3 * jrays


def _spectral_box(w, bins, depth, box=None):
    d = small_cbox(mt, w, w, bins, depth)
    if box is not None:
        d["small-box"]["bsdf"] = box
    return d


def _render(variant, desc, spp, **kw):
    with with_variant(mt, variant):
        scene = mt.load_dict(desc, device="cpu")
    s, t = mt.render(scene, spp=spp, seed=0, **kw)
    return s.numpy(), t.numpy()


def test_spectral_render_matches_rgb():
    """tests/test_spectral.py:43-71: luminance within 10 %, the red wall
    redder and the green wall greener, the transient energy within 12 %."""
    d = _spectral_box(16, 64, 4)
    a, ta = _render("rgb", d, 96, regenerate=False)
    b, tb = _render("spectral", d, 96)
    assert np.isfinite(b).all()
    la, lb = (a * LUMA).sum(-1).mean(), (b * LUMA).sum(-1).mean()
    assert abs(la - lb) / max(la, 1e-9) < 0.1
    assert b[:, :4, 0].mean() > b[:, :4, 1].mean()
    assert b[:, -4:, 1].mean() > b[:, -4:, 0].mean()
    assert abs(ta.sum() - tb.sum()) / max(ta.sum(), 1e-9) < 0.12


def test_spectral_polarized_s0_matches_spectral():
    """tests/test_spectral.py:123-154: the Stokes-0 rows of
    spectral_polarized are the spectral render (the same sample stream)."""
    d = _spectral_box(12, 48, 3)
    s_sp, _t = _render("spectral", d, 64)
    s_pol, t_pol = _render("spectral_polarized", d, 64)
    assert s_pol.shape == (12, 12, 12) and t_pol.shape == (12, 12, 48, 12)
    np.testing.assert_allclose(s_pol[..., 0:3], s_sp, rtol=2e-2, atol=1e-4)
    assert np.isfinite(t_pol).all() and t_pol[..., 0:3].sum() > 0


def test_spectral_polarized_gold_polarizes():
    """tests/test_spectral.py:157-176."""
    d = _spectral_box(8, 40, 4, {"type": "roughconductor", "material": "Au",
                                 "alpha": 0.05})
    s, _t = _render("spectral_polarized", d, 48)
    s0 = np.abs(s[..., 0:3]).sum()
    assert s0 > 0 and np.isfinite(s).all()
    assert np.abs(s[..., 3:9]).sum() > 1e-4 * s0
    assert stokes_checks(s.reshape(8, 8, 4, 3).sum(-1))["dop_q95"] \
        <= DOP_Q95_MAX


def test_spectral_regen_is_refused():
    """The JAX package's regen loop has no spectral branch (it renders
    plain RGB there); the port refuses ``regenerate=True`` instead."""
    with with_variant(mt, "spectral"):
        scene = mt.load_dict(small_cbox(mt, 4, 4, 10, 2), device="cpu")
    with pytest.raises(NotImplementedError, match="spectral"):
        mt.render(scene, spp=8, regenerate=True)
