"""The multi-pass render's pass graph (``mitransient_tpu_torch/passgraph.py``)
on the CPU: the draws under a row of the per-pass key table are the
fold_in chain's, at every dimension; the route is taken by the cbox's
multi-pass RGB pass on a CUDA device and refused on the CPU and by the
routes that sync or upload; a CPU render is the eager pass body's, bit for
bit, also on the graph's own buffers, into each render's own film; which
errors refuse a capture; the capture's trace sink and the scalars a
capture keeps.  The graph itself runs only on the card
(``tests/test_torch_cuda.py``).
Tolerance: none, keys and films must be identical."""
import copy
import importlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import mitransient_tpu_torch as mt
from mitransient_tpu_torch import passgraph, trace
from mitransient_tpu_torch.core import math as tmath
from mitransient_tpu_torch.core import rng as trng
from mitransient_tpu_torch.core.spectra import SPECTRAL_STREAM_TAG
from mitransient_tpu_torch.core.spectrum import Variant
from mitransient_tpu_torch.film import transient_film as tf
from mitransient_tpu_torch.integrators.nlos_path import film_channels
from mitransient_tpu_torch.integrators.volpath import GRID_STREAM_TAG
from mitransient_tpu_torch.kernels import launch_counts
from mitransient_tpu_torch.ops import bvh
from mitransient_tpu_torch.parallel.distributed import tree_leaves
from mitransient_tpu_torch.scene.scene import primal_sd
from mitransient_tpu_torch.sensors.perspective import build_camera
from torch_cases import small_cbox, vol_cbox

torch.set_num_threads(1)

render_mod = importlib.import_module("mitransient_tpu_torch.render")
TAG = trng.BOUNCE_STREAM_TAG


@pytest.fixture(scope="module")
def scene():
    return mt.load_dict(small_cbox(mt), device="cpu")


def _host_draw(words, d, shape):
    """``uniform(fold_in(words, d), shape)`` on the CPU, the dimension
    folded into the host key words on Python ints."""
    n = int(np.prod(shape))
    return trng._uniform_plain(trng.fold_in(words, d), 0, n,
                               "cpu").reshape(shape)


def _same_bits(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("seed", [0, 7, 2**32 - 1])
@pytest.mark.parametrize("depth", [1, 8])
def test_stream_key_draws_are_the_fold_in_chain(seed, depth):
    """Row i of ``pass_keys``: the key of pass ``passes[i]``, under which
    the camera's ``Sampler`` and ``draw_bounce_block`` draw what the host
    chain ``fold_in(fold_in(make_key(seed), pass), dim)`` gives."""
    passes = [0, 1, 5, 31, 2**20]
    keys = trng.pass_keys(seed, passes)
    assert keys.dtype == torch.int32 and keys.shape == (len(passes), 2)
    for row, p in zip(keys, passes):
        host = trng.fold_in(trng.make_key(seed), p)
        sampler = trng.Sampler.on(row, 3)
        _same_bits(sampler.next_2d(), torch.stack(
            [_host_draw(host, 0, (3,)), _host_draw(host, 1, (3,))], dim=-1))
        for it in range(depth):
            _same_bits(trng.draw_bounce_block(sampler.key, it, 3, 6),
                       _host_draw(host, TAG + it, (3, 6)))


def test_any_dimension_draws_from_the_stream_key():
    """Past the sampler's and the bounce blocks' dimensions: the grid
    tracking and wavelength tags and the last uint32."""
    key = trng.pass_keys(11, [3])[0]
    host = trng.fold_in(trng.make_key(11), 3)
    for d in (64, GRID_STREAM_TAG + 3, SPECTRAL_STREAM_TAG, 2**32 - 1):
        _same_bits(trng.uniform(key, d, (5, 7)), _host_draw(host, d, (5, 7)))


def test_route_is_taken_by_the_cbox_multipass_pass_on_a_cuda_device():
    """The predicate reads the device and the scene's settings only."""
    cbox = mt.load_dict(mt.cornell_box(), device="cpu")
    icfg, film = cbox.integrator, cbox.sensors[0].film
    cuda = torch.device("cuda", 0)
    rgb = Variant(3)
    assert passgraph.eligible(cuda, icfg, film, rgb)
    assert passgraph.eligible(cuda, icfg, film, Variant(1, polarized=True))
    assert not passgraph.eligible("cpu", icfg, film, rgb)
    vol = mt.load_dict(vol_cbox(mt, sigma_t=2.0), device="cpu")
    assert vol.integrator.kind == "transient_prbvolpath"
    assert not passgraph.eligible(cuda, vol.integrator, film, rgb)
    assert not passgraph.eligible(cuda, icfg,
                                  film._replace(kind="phasor_hdr_film"), rgb)
    assert not passgraph.eligible(cuda, icfg, film, Variant(3, spectral=True))


def _eager_render(scene, spp, seed, max_lanes):
    """``render(regenerate=False)`` with the pass body called directly ->
    (steady, transient, rays)."""
    cfg, icfg = scene.sensors[0], scene.integrator
    fc = cfg.film
    hw = fc.width * fc.height
    chunk = max(1, min(spp, max_lanes // hw))
    n_passes = -(-spp // chunk)
    chunk = -(-spp // n_passes)
    sd, cam = primal_sd(scene.data), build_camera(cfg, device="cpu")
    film = tf.film_init_any(fc, film_channels(scene.variant), device="cpu")
    keys = trng.pass_keys(seed, range(n_passes))
    rays = 0
    for p in range(n_passes):
        film, n = render_mod._perspective_pass(
            sd, cam, film, keys[p], 1.0 / (chunk * n_passes), film_cfg=fc,
            icfg=icfg, width=fc.width, height=fc.height, spp_chunk=chunk,
            bvh_mode=bvh.BVH_MODE, variant=scene.variant)
        rays = rays + n
    return (*tf.develop_any(film, fc), int(rays))


def _bit_equal(got, want):
    for a, b in zip(got[:2], want[:2]):
        assert a.shape == b.shape
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert int(got[2]) == int(want[2])


def test_cpu_multipass_render_is_the_eager_body_bit_for_bit(scene):
    kw = dict(spp=12, seed=1, max_lanes=4 * 256)
    before = dict(passgraph.STATS)
    s, t, stats = mt.render(scene, regenerate=False, return_stats=True, **kw)
    _bit_equal((s, t, stats["rays"]), _eager_render(scene, **kw))
    assert {k: passgraph.STATS[k] - before[k] for k in before} == {
        "captures": 0, "replays": 0, "eager_passes": 3, "refusals": 0,
        "eager_blocks": 0}
    assert passgraph._GRAPHS == {}


def test_pass_graph_buffers_give_the_eager_films(scene):
    """The graph's own buffers (copies of the scene and camera, the scale
    as a tensor, the steady sums and counters) under the eager body, as the
    first pass of a capture runs on the card, splatting into each render's
    own transient film: an output kept from one render is left as it was
    by the next."""
    cfg, icfg = scene.sensors[0], scene.integrator
    fc = cfg.film
    sd, cam = primal_sd(scene.data), build_camera(cfg, device="cpu")
    g = passgraph.PassGraph(None, sd, cam, tf.film_init_any(fc, 3),
                            torch.device("cpu"))
    assert all(a is not b for a, b in zip(tree_leaves(g.sd),
                                          tree_leaves(sd)))
    assert set(g.fields) == {"steady", "steady_weight", "n_negative",
                             "n_invalid"}
    body = lambda *a: render_mod._perspective_pass(  # noqa: E731
        *a, film_cfg=fc, icfg=icfg, width=fc.width, height=fc.height,
        spp_chunk=4, bvh_mode=bvh.BVH_MODE, variant=scene.variant)
    kept = {}
    for seed in (2, 3):  # the steady sums are zeroed by begin
        own = tf.film_init_any(fc, 3)
        film = g.begin(sd, cam, own, 1.0 / 12)
        assert film.transient is own.transient
        assert int(g.film_at) == own.transient.data_ptr()
        keys = trng.pass_keys(seed, range(3))
        rays = sum(int(g.run(body, keys[p], more=p < 2)) for p in range(3))
        assert g.graph is None
        kept[seed] = (*tf.develop_any(g.film, fc), rays)
    for seed, got in kept.items():
        _bit_equal(got, _eager_render(scene, spp=12, seed=seed,
                                      max_lanes=4 * 256))


def test_only_a_captures_refusal_leaves_a_structure_eager():
    """``passgraph.refused``: the graph's own refusal and the errors that
    name the capture; not another error, nor one that a refused capture's
    end raised over it."""
    assert passgraph.refused(passgraph.GraphRefusal(
        "the pass made a new transient film"))
    assert passgraph.refused(RuntimeError(
        "CUDA error: operation not permitted when stream is capturing"))
    assert passgraph.refused(RuntimeError(
        "Cannot copy between CPU and CUDA tensors during CUDA graph capture "
        "unless the CPU tensor is pinned"))
    assert not passgraph.refused(RuntimeError("splat_accumulate: invalid "
                                              "argument"))
    with pytest.raises(RuntimeError) as info:
        try:
            raise ValueError("a wrapper's error")
        except ValueError:
            raise RuntimeError("operation failed due to a previous error "
                               "during capture")
    assert not passgraph.refused(info.value)


def test_capture_sink_stands_for_the_counts_of_each_replay():
    """Inside ``trace.capturing`` no span is opened and counts and launches
    go to the sink; ``replay_counts`` adds launches always and counters
    under a profiler."""
    sink = trace.CaptureSink()
    lanes = torch.tensor([True, False, True])
    before = launch_counts().get("graph_test_kernel", 0)
    with trace.span("mitr:render"):  # no profiler: the next span starts anew
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("mitr:render"):  # the session's one span
            pass
        with trace.capturing(sink):
            assert trace.span("mitr:bounce") is trace._NOOP
            for _ in range(3):
                trace.count("lanes.active", lanes.sum())
                trace.count("lanes.launched", 3)
            trace.count("mask", lanes)
            trace.count_launch("graph_test_kernel")
        recorded = trace.summary()
    assert list(recorded["spans"]) == ["mitr:render"]
    assert recorded["counters"] == {}
    assert launch_counts().get("graph_test_kernel", 0) == before
    assert sink.ints == {"lanes.launched": 9}
    assert sink.launches == {"graph_test_kernel": 1}
    assert {k: int(v) for k, v in sink.tensors.items()} == {
        "lanes.active": 6, "mask": 2}
    trace.replay_counts(sink)  # no profiler: the launches alone
    with trace.span("mitr:render"):  # ends the session
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        trace.replay_counts(sink)
        trace.replay_counts(sink)
    assert trace.summary()["counters"] == {
        "lanes.launched": 18, "lanes.active": 12, "mask": 4}
    assert launch_counts()["graph_test_kernel"] == before + 3


def test_divide_keeps_but_does_not_cache_the_scalars_of_a_capture():
    x = torch.tensor([1.0, 2.0])
    kept = []
    with tmath.keeping(kept):
        y = tmath.divide(x, 3.25)
    assert len(kept) == 1 and float(kept[0]) == 3.25
    assert (3.25, x.dtype, x.device) not in tmath._SCALARS
    assert torch.equal(y, x / torch.tensor(3.25))
    tmath.divide(x, 3.25)
    assert (3.25, x.dtype, x.device) in tmath._SCALARS
    with tmath.keeping(kept):  # a cached scalar is kept too
        tmath.divide(x, 3.25)
    assert len(kept) == 2 and kept[1] is tmath._SCALARS[(3.25, x.dtype,
                                                         x.device)]


def test_film_state_resume_on_the_cpu_takes_no_graph(scene):
    kw = dict(spp=12, seed=4, max_lanes=4 * 256, regenerate=False)
    states = []
    s0, t0 = mt.render(scene, checkpoint_callback=states.append, **kw)
    s1, t1 = mt.render(scene, film_state=copy.deepcopy(states[1]), **kw)
    assert torch.equal(s0, s1) and torch.equal(t0, t1)
    assert passgraph._GRAPHS == {}
