"""Texel recovery on the transient Cornell box with mitransient's
checkerboard floor (``torch_cases.CHECKER_FLOOR``; the benchmark's
configuration ``portbench/configs/cbox_textured.json``), the port against
the JAX package on the CPU and against the benchmark's plain reference of
textured scenes (``portbench/reference/textured.py``): the checkerboard's
bake, the floor's uv, the films and the PRB texel gradient on seeded
random texels; a texel write reaching the render; the texture's span and counters, and none of them inside a
captured pass; and, on the card, the multi-pass pass graph taking new
texels as the eager pass body does.

Tolerances: both packages draw the same streams, so films agree under
test_golden's rule (rtol 5e-4, atol 5e-5 * max, no element out) and the
texel gradient within 1e-4 of its largest |value| (float32 sums over the
lanes in another order, and XLA:CPU's FMA contraction), as
test_torch_grad.py holds the 8 x 8 texel case.  The same gradient on the
wrong texels (its u and v axes swapped) lies far outside.

The card test runs with ``python -m pytest
tests/test_torch_textured_grad.py -m cuda --noconftest``; it imports no
JAX there.
"""
import copy
import json
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import profile

import mitransient_tpu_torch as mt
from mitransient_tpu_torch import passgraph, trace
from mitransient_tpu_torch.bsdf import api
from mitransient_tpu_torch.core.records import Ray
from mitransient_tpu_torch.scene.scene import primal_sd, ray_intersect

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATH = "floor.bsdf.reflectance.data"
SEED = 2**31 + 91  # larger than a signed 32-bit seed
# tests/torch_cases.py:CHECKER_FLOOR, repeated so that the card test needs
# no test helper that imports the JAX package
CHECKER_FLOOR = {"type": "diffuse", "reflectance": {
    "type": "checkerboard",
    "color0": {"type": "rgb", "value": [0.7, 0.3, 0.2]},
    "color1": {"type": "rgb", "value": [0.2, 0.6, 0.7]}}}
GRAD_TOL = 1e-4


def _desc(res=16, max_depth=3):
    d = mt.cornell_box()
    d["sensor"]["film"].update(width=res, height=res)
    d["integrator"]["max_depth"] = max_depth
    d["floor"]["bsdf"] = copy.deepcopy(CHECKER_FLOOR)
    return d


def _random_texels(seed):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((64, 64, 3), generator=g)


def _both(desc, texels=None):
    """The scene in both packages, with ``texels`` written through each
    package's ``traverse`` and ``update()``."""
    import mitransient_tpu as mitr

    jsc = mitr.load_dict(copy.deepcopy(desc))
    tsc = mt.load_dict(copy.deepcopy(desc), device="cpu")
    if texels is not None:
        for pkg, sc in ((mitr, jsc), (mt, tsc)):
            p = pkg.traverse(sc)
            p[PATH] = texels.numpy()
            p.update()
    return mitr, jsc, tsc


def _golden(got, want):
    from torch_cases import golden_mismatch

    m = golden_mismatch(np.asarray(got), np.asarray(want))
    assert m["shape_ok"] and m["n_bad"] == 0, m


@pytest.mark.parametrize("texel_seed", [1, 2, 3])
def test_films_and_texel_gradient_match_jax(texel_seed):
    """16x16, 8 spp, depth 3, the atlas replaced by seeded random texels:
    the multi-pass film, the regen film (a target's route) and the PRB
    texel gradient of an adjoint that varies over the bins."""
    mitr, jsc, tsc = _both(_desc(), _random_texels(texel_seed))
    steady, img = mt.render(tsc, spp=8, seed=SEED, regenerate=False)
    js, jt = mitr.render(jsc, spp=8, seed=SEED, regenerate=False)
    assert float(img.sum()) > 0
    _golden(img.numpy(), jt)
    _golden(steady.numpy(), js)
    _s, target = mt.render(tsc, spp=8, seed=SEED + 1)
    _golden(target.numpy(), mitr.render(jsc, spp=8, seed=SEED + 1)[1])

    adj = 2.0 / img.numel() * (img - 1.3 * target)
    got = mt.render_backward(tsc, (None, adj), spp=8, seed=SEED)[PATH]
    want = np.asarray(mitr.render_backward(jsc, (None, adj.numpy()), spp=8,
                                           seed=SEED)[PATH], np.float64)
    assert got.shape == want.shape == (64, 64, 3)
    assert int((want != 0).any(-1).sum()) > 10
    scale = float(np.abs(want).max())
    assert float(np.abs(got.double().numpy() - want).max()) < GRAD_TOL * scale
    swapped = got.transpose(0, 1).double().numpy()
    assert float(np.abs(swapped - want).max()) > 0.1 * scale


def test_checkerboard_bake_is_both_packages_atlas():
    """Texel (row v, column u), centre ((u + 0.5) / 64, (v + 0.5) / 64),
    takes color1 where (u > 0.5) xor (v > 0.5), else color0."""
    mitr, jsc, tsc = _both(_desc())
    centre = (np.arange(64) + 0.5) / 64
    mask = (centre[None, :] > 0.5) ^ (centre[:, None] > 0.5)
    ref = CHECKER_FLOOR["reflectance"]
    want = np.where(mask[..., None], ref["color1"]["value"],
                    ref["color0"]["value"]).astype(np.float32)
    atlas = mt.traverse(tsc)[PATH]
    assert atlas.dtype == torch.float32
    assert np.array_equal(atlas.numpy(), want)
    assert np.array_equal(np.asarray(mitr.traverse(jsc)[PATH]), want)


def test_floor_uv_at_its_corners_and_centre():
    """Rays straight down onto the floor (world (2u - 1, -1, 1 - 2v)) just
    inside its four corners and at its centre, on the diagonal both of its
    triangles share: the hit's uv is the point's."""
    e = 1e-3
    uv = torch.tensor([[e, e], [1 - e, e], [1 - e, 1 - e], [e, 1 - e],
                       [0.5, 0.5]])
    o = torch.stack([2 * uv[:, 0] - 1, torch.full((5,), -0.5),
                     1 - 2 * uv[:, 1]], -1)
    d = torch.tensor([[0.0, -1.0, 0.0]]).expand(5, 3).contiguous()
    scene = mt.load_dict(_desc(), device="cpu")
    sd = primal_sd(scene.data)
    si = ray_intersect(sd, Ray.make(o, d), torch.ones(5, dtype=torch.bool))
    assert bool(si.valid.all())
    assert torch.allclose(si.t, torch.full((5,), 0.5), atol=1e-6)
    assert torch.allclose(si.uv, uv, atol=1e-6)


def test_texel_write_changes_only_pixels_that_see_the_floor():
    """Depth 2 (direct light only): after ``params.update()`` of darker
    texels a render of the same seed changes the pixels that the JAX
    package's renders change, all of them in the image's lower half where
    the floor is, and leaves every other pixel bit for bit."""
    mitr, jsc, tsc = _both(_desc(max_depth=2))
    changed = {}
    for pkg, sc in ((mitr, jsc), (mt, tsc)):
        params = pkg.traverse(sc)
        before = np.asarray(pkg.render(sc, spp=8, seed=SEED,
                                       regenerate=False)[0])
        params[PATH] = 0.5 * np.asarray(params[PATH])
        params.update()
        after = np.asarray(pkg.render(sc, spp=8, seed=SEED,
                                      regenerate=False)[0])
        changed[pkg] = (before != after).any(-1)
    got = changed[mt]
    assert np.array_equal(got, changed[mitr])
    assert not got[:8].any()
    assert int(got.sum()) > 16


def _reference():
    """The benchmark's plain reference of textured scenes
    (``portbench/reference/textured.py``: plain PyTorch that imports
    neither package) and the tracer it builds on."""
    bench = os.path.join(ROOT, "portbench")
    if bench not in sys.path:
        sys.path.insert(0, bench)
    from reference import textured, tracer
    from reference.streams import PassStreams
    return textured, tracer, PassStreams


def _config_desc(res=16, max_depth=3):
    with open(os.path.join(ROOT, "portbench", "configs",
                           "cbox_textured.json")) as f:
        desc = json.load(f)["scene"]
    desc["sensor"]["film"].update(width=res, height=res)
    desc["integrator"]["max_depth"] = max_depth
    return desc


def _rel(a, b):
    return float((a - b).abs().sum() / b.abs().sum())


def test_benchmark_configuration_is_the_checkerboard_box():
    """``portbench/configs/cbox_textured.json`` holds the box of
    ``cornell_box()`` with CHECKER_FLOOR as its floor, nothing else."""
    assert _config_desc(256, 8) == json.loads(json.dumps(_desc(256, 8)))


@pytest.mark.parametrize("texel_seed", [1, 2, 3])
def test_films_and_texel_gradient_match_the_benchmark_reference(texel_seed):
    """The same case against the benchmark's reference, which draws the
    same streams in the port's documented rounding order: films within
    float32 rounding (relative L1 below 1e-5, as
    portbench/tests/test_portbench_reference.py holds the untextured box;
    a path that rounding parts moves a whole sample, far above it), and
    the texel gradient, the port's float32 sum in K8's fixed order against
    the reference's float64 sum of the same terms, within a few float32
    roundings a term of its mass (the terms' absolute sum): below 1e-5."""
    textured, _tracer, _ps = _reference()
    desc = _config_desc()
    scene = mt.load_dict(copy.deepcopy(desc), device="cpu")
    params = mt.traverse(scene)
    texels = _random_texels(texel_seed)
    params[PATH] = texels
    params.update()
    ts = textured.TexturedScene(desc)
    ts.texels = texels.numpy()
    S, ref = ts.to("cpu"), ts.ref
    dims = dict(width=ref.width, height=ref.height, bins=ref.bins,
                start_opl=ref.start_opl, bin_width=ref.bin_width,
                max_depth=ref.max_depth, rr_depth=ref.rr_depth)
    hw, T = ref.width * ref.height, ref.bins
    every = torch.arange(hw)

    steady, img = mt.render(scene, spp=8, seed=SEED, regenerate=False)
    rs, rt = textured.render_multipass(S, dims, SEED, 8, every)
    assert float(rt.sum()) > 0
    assert _rel(img.reshape(hw, T, 3), rt) < 1e-5
    assert _rel(steady.reshape(hw, 3), rs) < 1e-5
    _s, target = mt.render(scene, spp=8, seed=SEED + 1)
    _rs, rt2 = textured.render_regen(S, dims, SEED + 1, 8, every)
    assert _rel(target.reshape(hw, T, 3), rt2) < 1e-5

    adj = 2.0 / img.numel() * (img - 1.3 * target)
    got = mt.render_backward(scene, (None, adj), spp=8, seed=SEED)[PATH]
    want, mass = textured.prb_texel_gradient(S, dims, SEED, 8,
                                             adj.reshape(hw, T, 3))
    assert got.shape == (64, 64, 3)
    assert int((want != 0).any(-1).sum()) > 10
    assert float((got.double() - want).abs().sum() / mass.sum()) < 1e-5
    swapped = got.transpose(0, 1).double()
    assert float((swapped - want).abs().sum() / mass.sum()) > 0.1


def test_checkerboard_bake_is_the_benchmark_references():
    textured, _tracer, _ps = _reference()
    desc = _config_desc()
    atlas = mt.traverse(mt.load_dict(copy.deepcopy(desc),
                                     device="cpu"))[PATH]
    assert np.array_equal(atlas.numpy(),
                          textured.TexturedScene(desc).texels)


def test_reference_floor_uv_is_the_ports():
    """The reference's uv at the floor's corners and centre (the rays of
    test_floor_uv_at_its_corners_and_centre) is the point's, on textured
    triangles."""
    textured, tracer, _ps = _reference()
    e = 1e-3
    uv = torch.tensor([[e, e], [1 - e, e], [1 - e, 1 - e], [e, 1 - e],
                       [0.5, 0.5]])
    o = torch.stack([2 * uv[:, 0] - 1, torch.full((5,), -0.5),
                     1 - 2 * uv[:, 1]], -1)
    d = torch.tensor([[0.0, -1.0, 0.0]]).expand(5, 3).contiguous()
    S = textured.TexturedScene(_config_desc()).to("cpu")
    t, tri = tracer.closest_hit(S, o, d, torch.ones(5, dtype=torch.bool))
    assert bool(S["textured"][tri].all())
    p = o + d * t[:, None]
    assert torch.allclose(textured.hit_uv(S, tri, p), uv, atol=1e-6)


def _traced_render(desc):
    scene = mt.load_dict(copy.deepcopy(desc), device="cpu")
    # a span opened with no profiler recording: the window below is a
    # session of its own
    with trace.span("mitr:render"):
        pass
    with profile():
        mt.render(scene, spp=4, seed=SEED, regenerate=False)
        mt.render_backward(scene, (None, torch.ones(16, 16, 300, 3)), spp=4,
                           seed=SEED)
    return trace.summary()


def test_texture_span_and_counters_only_where_a_texture_is():
    """A textured render and backward open ``mitr:texture`` and count every
    looked-up lane and the textured ones among them; the untextured box
    never enters the lookup."""
    s = _traced_render(_desc())
    assert s["spans"]["mitr:texture"]["count"] > 0
    c = s["counters"]
    assert 0 < c["texture.textured"] < c["texture.lookups"]
    # the multi-pass render's bounces and the two sweeps: one lookup a
    # bounce, two in the adjoint sweep's bounce (detached and attached)
    assert c["texture.lookups"] == 4 * c["lanes.launched"] // 3
    plain = _desc()
    plain["floor"]["bsdf"] = mt.cornell_box()["floor"]["bsdf"]
    s = _traced_render(plain)
    assert "mitr:texture" not in s["spans"]
    assert not {"texture.lookups", "texture.textured"} & set(s["counters"])


def test_captured_lookup_counts_nothing():
    """Inside a capture, with a profiler recording, the lookup gives the
    capture sink no counter: a replayed graph holds no counting work, so
    an untraced replay runs what it ran before the counters."""
    scene = mt.load_dict(_desc(), device="cpu")
    bp = scene.data.bsdf
    n = 256
    g = torch.Generator().manual_seed(5)
    idx = torch.randint(0, int(bp.tex_id.shape[0]), (n,), generator=g)
    uv = torch.rand((n, 2), generator=g)
    refl = torch.full((n, 3), 0.5)
    sink = trace.CaptureSink()
    with profile():
        with trace.capturing(sink):
            assert not trace.recording()
            got = api._apply_texture(bp, idx, refl, uv)
        assert trace.recording()
        want = api._apply_texture(bp, idx, refl, uv)
    assert torch.equal(got, want)
    assert not sink.ints and not sink.tensors and not sink.launches


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.cuda
def test_pass_graph_takes_new_texels_like_the_eager_body(cuda, monkeypatch):
    """Two steps' texels written between renders: the replayed passes of
    one capture give the films of the eager pass body bit for bit, and
    the capture's sink, which takes counts profiler or not, holds no
    texture lookup.  No profiler records here: a session that spans a
    graph capture makes later sessions of the process report fewer of a
    replayed graph's kernels, which test_torch_cuda.py counts."""
    scene = mt.load_dict(_desc(max_depth=8), device=cuda)
    params = mt.traverse(scene)
    kw = dict(spp=12, seed=SEED, regenerate=False, max_lanes=4 * 256)
    eligible = passgraph.eligible
    passgraph.clear()
    before = dict(passgraph.STATS)
    try:
        for step in (1, 2):
            params[PATH] = _random_texels(step).to(cuda)
            params.update()
            monkeypatch.setattr(passgraph, "eligible", eligible)
            got = mt.render(scene, **kw)
            monkeypatch.setattr(passgraph, "eligible", lambda *a: False)
            want = mt.render(scene, **kw)
            for a, b in zip(got, want):
                assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        made = {k: passgraph.STATS[k] - before[k] for k in before}
        assert made["captures"] == 1 and made["refusals"] == 0
        assert made["replays"] == 2 + 3
        (graph,) = passgraph._GRAPHS.values()
        counted = set(graph.sink.ints) | set(graph.sink.tensors)
        assert "lanes.active" in counted
        assert not {"texture.lookups", "texture.textured"} & counted
    finally:
        passgraph.clear()
