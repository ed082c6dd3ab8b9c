"""Volumetric rendering (``transient_prbvolpath``) under the polarized and
spectral variants, the port against the JAX package on the CPU.

- Every ``torch_cases.VARIANT_VOL_CASES`` configuration (the fog of
  tests/test_volumetric.py:159, tests/test_spectral.py:101-122 and 178-,
  the fog at test_prb_vol.py:111's depth with a gold GGX large box, and
  the seeded 8^3 grid under spectral and mono_polarized) per sample under
  test_golden's rule (rtol 5e-4, atol 5e-5 * max) with no element out,
  and the same ray count.  The small box stands 2 mm off the floor
  (``torch_cases.VOL_LIFT``): with its bottom coplanar with the floor,
  XLA:CPU's FMA-contracted hit distances part the packages
  (``torch_cases.VOLUMETRIC_TIES``, ROADMAP queue 3).
- The physics of those tests on the port: the polarized fog's Stokes I
  is the mono render's, its vectors are physical and the fog
  depolarizes; the spectral fog's luminance is the rgb fog's.
- Every splat hands K3 contiguous values.
"""
import copy

import numpy as np
import pytest
import torch

import mitransient_tpu as mitr
import mitransient_tpu_torch as mt
from torch_cases import (
    FILM_CHANNELS,
    VARIANT_VOL_CASES,
    golden_mismatch,
    variant_vol_case,
    with_variant,
)

torch.set_num_threads(1)

LUMA = np.array([0.2126, 0.7152, 0.0722])


def _render(pkg, name, variant=None, **kw):
    v, desc, rkw = variant_vol_case(pkg, name)
    with with_variant(pkg, variant or v):
        scene = pkg.load_dict(copy.deepcopy(desc), **kw)
    s, t, stats = pkg.render(scene, return_stats=True, **rkw)
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


@pytest.mark.parametrize("name", VARIANT_VOL_CASES)
def test_render_matches_jax(renders, name):
    (js, jt, jrays), (ts, tt, trays) = renders(name)
    for got, want in ((ts, js), (tt, jt)):
        m = golden_mismatch(got, want)
        assert m["shape_ok"] and m["n_bad"] == 0, (name, m)
    assert trays == jrays
    variant = variant_vol_case(mt, name)[0]
    assert ts.shape[-1] == tt.shape[-1] == FILM_CHANNELS[variant]


def test_polarized_volumetric_primal(renders):
    """tests/test_volumetric.py:159-193 on the port: Stokes I is the mono
    render's (the same samples), the vectors are physical and the fog's HG
    scatter leaves a low degree of polarization."""
    _j, (s_p, t_p, _r) = renders("mono_polarized")
    s_u = _render(mt, "mono_polarized", variant="mono", device="cpu")[0]
    assert s_p.shape == (12, 12, 4) and t_p.shape[-1] == 4
    assert np.isfinite(s_p).all() and np.isfinite(t_p).all()
    rel = abs(s_p[..., :1].sum() - s_u.sum()) / max(s_u.sum(), 1e-9)
    assert rel < 1e-3, rel
    dop_num = np.sqrt((s_p[..., 1:] ** 2).sum(-1))
    assert np.all(dop_num <= s_p[..., 0] + 1e-4)
    mask = s_p[..., 0] > np.quantile(s_p[..., 0], 0.5)
    dop = dop_num[mask] / np.maximum(s_p[..., 0][mask], 1e-9)
    assert float(np.median(dop)) < 0.05


def test_spectral_volumetric_matches_rgb(renders):
    """tests/test_spectral.py:101-120: the spectral fog's luminance within
    15 % of the rgb fog's."""
    _j, (b, _t, _r) = renders("spectral")
    a = _render(mt, "spectral", variant="rgb", device="cpu")[0]
    assert b.shape == a.shape and np.isfinite(b).all() and b.sum() > 0
    la, lb = (a * LUMA).sum(-1).mean(), (b * LUMA).sum(-1).mean()
    assert abs(la - lb) / max(la, 1e-9) < 0.15


def test_spectral_polarized_volumetric_runs(renders):
    """tests/test_spectral.py:178-: the variant corner's volumetric render:
    4 Stokes rows of 3 sRGB channels, finite."""
    _j, (s, t, _r) = renders("spectral_polarized")
    assert s.shape == (4, 4, 12) and t.shape == (4, 4, 32, 12)
    assert np.isfinite(t).all() and t[..., 0:3].sum() > 0


@pytest.mark.parametrize("name", ["mono_polarized", "spectral_polarized",
                                  "pol_grid"])
def test_splat_values_are_contiguous(monkeypatch, name):
    """K3's wrapper takes only contiguous (N, C) values on the card: every
    volumetric splat of a variant render hands it such values."""
    from mitransient_tpu_torch.film import transient_film as tf

    seen = []
    splat = tf.splat_accumulate

    def check(film, *events, spp):
        seen.extend(e.is_contiguous() for e in events if e is not None)
        splat(film, *events, spp=spp)

    monkeypatch.setattr(tf, "splat_accumulate", check)
    _render(mt, name, device="cpu")
    assert seen and all(seen)
