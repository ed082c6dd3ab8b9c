"""NLOS capture under the polarized and spectral variants, the port against
the JAX package on the CPU.

- Every ``torch_cases.VARIANT_NLOS_CASES`` configuration (the captures of
  tests/test_polarized.py:123-187, tests/test_spectral.py:74-100, 178-
  and tests/test_nlos.py:404, and the plain-NEE, HG-with-RR and confocal
  routes under the variants) per sample under test_golden's rule (rtol
  5e-4, atol 5e-5 * max) with no element out, and the same ray count.
- The physics of those tests on the port: physical Stokes vectors under a
  gold relay wall, the Stokes I of a diffuse capture against the mono
  capture, the exhaustive capture's 6-D Stokes film, the confocal scan's
  S0 against the mono scan and against the per-point loop, and the
  spectral capture against the rgb one.
- The exhaustive capture sends the variants to its per-point route, and
  every splat hands K3 contiguous values.

Both packages draw the same threefry streams and hero wavelengths (within
``test_torch_spectral.WL_ULPS``).
"""
import copy

import numpy as np
import pytest
import torch

import mitransient_tpu as mitr
import mitransient_tpu_torch as mt
from torch_cases import (
    FILM_CHANNELS,
    VARIANT_NLOS_CASES,
    golden_mismatch,
    nlos_confocal,
    nlos_scene,
    variant_nlos_case,
    with_variant,
)

torch.set_num_threads(1)


def _render(pkg, name, **kw):
    variant, desc, run = variant_nlos_case(pkg, name)
    with with_variant(pkg, variant):
        scene = pkg.load_dict(copy.deepcopy(desc), **kw)
    s, t, stats = run(scene)
    return np.asarray(s), np.asarray(t), float(np.asarray(stats["rays"]))


@pytest.fixture(scope="module")
def renders():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = (_render(mitr, name),
                           _render(mt, name, device="cpu"))
        return cache[name]

    return get


@pytest.mark.parametrize("name", VARIANT_NLOS_CASES)
def test_capture_matches_jax(renders, name):
    (js, jt, jrays), (ts, tt, trays) = renders(name)
    for got, want in ((ts, js), (tt, jt)):
        m = golden_mismatch(got, want)
        assert m["shape_ok"] and m["n_bad"] == 0, (name, m)
    assert trays == jrays
    variant = variant_nlos_case(mt, name)[0]
    assert tt.shape[-1] == ts.shape[-1] == FILM_CHANNELS[variant]


def test_polarized_nlos_stokes_validity(renders):
    """tests/test_polarized.py:123-140 on the port's capture."""
    _j, (_s, tr, _r) = renders("pol_gold")
    assert tr.shape == (4, 4, 200, 4) and np.isfinite(tr).all()
    s0 = tr[..., 0]
    assert float(s0.sum()) > 0.0
    lin = np.sqrt((tr[..., 1:] ** 2).sum(-1))
    mask = s0 > 1e-6 * s0.max()
    assert float((lin[mask] <= s0[mask] * 1.05 + 1e-9).mean()) > 0.99
    assert float(lin[mask].max() / s0[mask].max()) > 1e-3


def test_polarized_nlos_intensity_matches_unpolarized(renders):
    """tests/test_polarized.py:142-161: the diffuse wall's Stokes I against
    the mono capture of the same samples."""
    _j, (_s, tr_p, _r) = renders("pol_diffuse")
    _variant, desc, run = variant_nlos_case(mt, "pol_diffuse")
    with with_variant(mt, "mono"):
        scene = mt.load_dict(desc, device="cpu")
    a = run(scene)[1].numpy()[..., 0]
    b = tr_p[..., 0]
    np.testing.assert_allclose(a.sum(), b.sum(), rtol=5e-2)
    np.testing.assert_allclose(a, b, rtol=0.35, atol=1e-4 * a.max())


def test_polarized_exhaustive_capture(renders):
    """tests/test_polarized.py:164-186: the 6-D film's trailing axis holds
    the 4 Stokes components."""
    _j, (_s, t, _r) = renders("pol_exhaustive")
    assert t.shape == (2, 2, 2, 2, 200, 4)
    assert np.isfinite(t).all() and t[..., 0].sum() > 0
    agg = t.sum(axis=(0, 1, 2, 3, 4))
    assert agg[0] >= abs(agg[1]) and agg[0] >= abs(agg[2])
    assert not np.allclose(t[:, :, 0, 0], t[:, :, 1, 1])


@pytest.mark.parametrize("variant", ["mono_polarized", "spectral"])
def test_exhaustive_variants_take_the_perpoint_route(monkeypatch, variant):
    """As the JAX package's nlos_path.py:1564-1568: a polarized or spectral
    exhaustive capture renders point by point, into 4 C Stokes channels
    when polarized; each slab is the single capture focused there."""
    from mitransient_tpu_torch.integrators import nlos_path as tn

    seen = []
    perpoint = tn._render_nlos_exhaustive_perpoint
    monkeypatch.setattr(tn, "_render_nlos_exhaustive_perpoint",
                        lambda *a, **k: seen.append(1) or perpoint(*a, **k))
    d = nlos_scene(sx=2, sy=2, bins=60, spp=4)
    d["integrator"]["capture_type"] = "exhaustive"
    d["relay_wall"]["nlos_sensor"]["film"].update(
        exhaustive_scan=True, laser_scan_width=2, laser_scan_height=1)
    with with_variant(mt, variant):
        scene = mt.load_dict(copy.deepcopy(d), device="cpu")
        single = mt.load_dict(copy.deepcopy(d), device="cpu")
    _s, t = mt.render(scene, spp=4, seed=0)
    assert seen == [1]
    assert t.shape == (2, 2, 1, 2, 60, 4 if variant == "mono_polarized"
                       else 3)
    single.integrator = single.integrator._replace(capture_type="single")
    mt.nlos.focus_emitter_at_relay_wall_pixel([1.5, 0.5], single)
    _s1, t1 = mt.render(single, spp=4, seed=0)
    assert torch.equal(t[:, :, 0, 1], t1)


def test_confocal_scan_polarized_matches_mono_and_perpoint(renders):
    """tests/test_nlos.py:404-455: the polarized scan's S0 equals the mono
    scan (the diffuse wall depolarizes the last bounce), and agrees with
    the per-point loop of focus + render point by point."""
    _j, (_s, t_b, _r) = renders("pol_scan_confocal")
    grid, spp = 2, 256
    d = nlos_confocal(nlos_scene(sx=1, sy=1), grid, grid)
    with with_variant(mt, "mono"):
        mono = mt.load_dict(copy.deepcopy(d), device="cpu")
    _s, t_mono = mt.nlos.scan_confocal(mono, spp=spp, seed=0)
    assert t_b.shape == (grid, grid, 300, 4) and t_b[..., 0].sum() > 0
    np.testing.assert_allclose(t_b[..., 0:1], t_mono.numpy(), rtol=1e-5)
    with with_variant(mt, "mono_polarized"):
        scene = mt.load_dict(copy.deepcopy(d), device="cpu")
    t_pp = np.zeros_like(t_b)
    for yy in range(grid):
        for xx in range(grid):
            mt.nlos.focus_emitter_at_relay_wall_pixel([xx + 0.5, yy + 0.5],
                                                      scene)
            t_pp[yy, xx] = mt.render(scene, spp=spp, seed=0)[1].numpy()[0, 0]
    pb = t_b[..., 0].sum(axis=2).ravel()
    pp = t_pp[..., 0].sum(axis=2).ravel()
    assert float((pb * pp).sum()) / float(
        np.sqrt((pb ** 2).sum() * (pp ** 2).sum())) > 0.999
    # tests/test_nlos.py:449-452: the per-point loop draws other samples;
    # a bright pixel spreads by ~10 % from seed to seed at this spp
    assert abs(pb.sum() - pp.sum()) / pp.sum() < 0.15


def test_spectral_nlos_matches_rgb(renders):
    """tests/test_spectral.py:74-98: 3 sRGB channels, the rgb capture's
    arrival bins and its energy within 20 %."""
    _j, (_s, tb, _r) = renders("spectral")
    _variant, desc, run = variant_nlos_case(mt, "spectral")
    ta = run(mt.load_dict(desc, device="cpu"))[1].numpy()
    assert tb.shape == ta.shape == (4, 4, 200, 3)
    assert np.isfinite(tb).all() and tb.sum() > 0
    pa, pb = ta.sum(axis=(0, 1, 3)), tb.sum(axis=(0, 1, 3))
    assert abs(int(np.nonzero(pa)[0][0]) - int(np.nonzero(pb)[0][0])) <= 2
    assert abs(pa.sum() - pb.sum()) / max(pa.sum(), 1e-9) < 0.2


@pytest.mark.parametrize("name", ["pol_gold", "pol_plain_nee",
                                  "spectral_polarized", "rgb_pol_confocal"])
def test_splat_values_are_contiguous(monkeypatch, name):
    """K3's wrapper takes only contiguous (N, C) values on the card: every
    NLOS splat of a variant capture hands it such values."""
    from mitransient_tpu_torch.film import transient_film as tf

    seen = []
    splat = tf.splat_accumulate

    def check(film, *events, spp):
        seen.extend(e.is_contiguous() for e in events if e is not None)
        splat(film, *events, spp=spp)

    monkeypatch.setattr(tf, "splat_accumulate", check)
    _render(mt, name, device="cpu")
    assert seen and all(seen)
