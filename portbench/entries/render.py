"""Entry ``render``: a closed loop of ``mitransient_tpu_torch.render``
calls on one scene, each with its own seed (a render or an NLOS capture).

What is checked: the films of calls drawn from the run's seed among those
the window completed (a reservoir sample), at pixels drawn from the seed,
against the plain reference rendering the same pixels from the same sample
streams at the same spp.  The numbers are the relative L1 gaps of the
steady image and of the transient video over those pixels.
"""
from __future__ import annotations

import copy
import time

import torch

from harness import roofline
from harness import traffic as traffic_mod
from reference import tracer
from reference.scene import RefScene


def film_of(desc: dict) -> dict:
    """The film dict of a scene dict's sensor (a perspective sensor's or
    the relay wall's capture meter's)."""
    for val in desc.values():
        if isinstance(val, dict):
            if val.get("type") == "perspective":
                return val["film"]
            if "nlos_sensor" in val:
                return val["nlos_sensor"]["film"]
    raise ValueError("the scene has no sensor")


def scene_desc(cell, shrink: dict | None) -> dict:
    """The configuration's scene dict; ``shrink`` (tests only) overrides
    film keys (``{"film": {"width": 16, "height": 16}}``), the traffic's and
    the laser's focus pixel."""
    desc = copy.deepcopy(cell.config["scene"])
    if shrink:
        film_of(desc).update(shrink.get("film", {}))
    return desc


class State:
    pass


def _render(st, params):
    return st.mt.render(st.scene, spp=params["spp"], seed=params["seed"],
                        regenerate=params.get("regenerate"),
                        return_stats=True)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def setup(ctx) -> State:
    st = State()
    st.mt, st.device, st.ctx = ctx.mt, ctx.device, ctx
    st.desc = scene_desc(ctx.cell, ctx.shrink)
    st.focus = (ctx.shrink or {}).get("focus_pixel",
                                      ctx.cell.config.get("focus_pixel"))
    st.scene = ctx.mt.load_dict(copy.deepcopy(st.desc), device=ctx.device)
    if st.focus is not None:
        ctx.mt.nlos.focus_emitter_at_relay_wall_pixel(st.focus, st.scene)
    film = film_of(st.desc)
    st.W, st.H, st.T = film["width"], film["height"], film["temporal_bins"]
    hw = st.W * st.H
    check = ctx.cell.cell["check"]
    n_pix = min(int(check["pixels"]), hw)
    pix = traffic_mod.rng(ctx.seed, 1).choice(hw, n_pix, replace=False)
    st.pixels = torch.as_tensor(sorted(pix.tolist()), device=ctx.device)
    st.n_kept = int(check["calls"])
    st.keep_rng = traffic_mod.rng(ctx.seed, 2)
    st.kept = []  # [(call seed, spp, regenerate, steady rows, transient rows)]
    st.rays = torch.zeros((), dtype=torch.int64, device=ctx.device)
    st.calls, st.samples, st.walls, st.loop_iters = 0, 0, [], []
    _s, transient, _stats = _render(st, ctx.traffic.call(-1))  # warm-up
    _sync(ctx.device)
    st.sectors = roofline.film_sectors(transient)
    st.channels = transient.shape[-1]
    del _s, transient, _stats
    return st


def call(st, index: int) -> None:
    params = st.ctx.traffic.call(index)
    t0 = time.perf_counter()
    steady, transient, stats = _render(st, params)
    st.rays += stats["rays"]
    st.loop_iters.append(int(stats["loop_iters"]))
    slot = (index if index < st.n_kept
            else int(st.keep_rng.integers(0, index + 1)))
    if slot < st.n_kept:
        hw = st.W * st.H
        rows = (params["seed"], params["spp"], params.get("regenerate"),
                steady.reshape(hw, -1).index_select(0, st.pixels),
                transient.reshape(hw, st.T, -1).index_select(0, st.pixels))
        if slot < len(st.kept):
            st.kept[slot] = rows
        else:
            st.kept.append(rows)
    del steady, transient, stats
    _sync(st.device)
    st.walls.append(time.perf_counter() - t0)
    st.calls += 1
    st.samples += st.W * st.H * params["spp"]


def work(st) -> dict:
    """What the window did, counted from the cell's own data: the calls,
    samples and rays, each call's wall and bounces, and for the rooflines the scene's triangles (the
    reference's count of the scene dict), the film's channels and sectors
    and the cell's splat events a ray."""
    return dict(calls=st.calls, samples=st.samples, steps=0,
                rays=int(st.rays), sectors_per_call=st.sectors,
                triangles=RefScene(st.desc, focus_pixel=st.focus).triangles,
                channels=st.channels,
                events_per_ray=st.ctx.cell.cell.get("splat_events_per_ray",
                                                    1.0),
                walls=st.walls, loop_iters=st.loop_iters)


def release(st) -> None:
    """Drop the program's state before the reference runs."""
    st.kept = [(s, n, r, None, None) for s, n, r, _a, _b in st.kept]
    st.pixels = st.pixels.cpu()
    del st.scene


def reference_outputs(st, dtype, device):
    """The reference's films of the kept calls at the kept pixels."""
    ref = RefScene(st.desc, focus_pixel=st.focus)
    S = ref.to(device, dtype)
    dims = dict(width=ref.width, height=ref.height, bins=ref.bins,
                start_opl=ref.start_opl, bin_width=ref.bin_width,
                max_depth=ref.max_depth, rr_depth=ref.rr_depth)
    pix = st.pixels.to(device)
    out = []
    for seed, spp, regen, _a, _b in st.kept:
        if ref.laser is not None:
            films = tracer.render_nlos(S, dims, seed, spp, pix)
        elif regen:
            films = tracer.render_regen(S, dims, seed, spp, pix)
        else:
            films = tracer.render_multipass(S, dims, seed, spp, pix)
        out.append(tuple(f.cpu() for f in films))
    return out


def program_outputs(st):
    return [(a.float().cpu(), b.float().cpu())
            for _s, _n, _r, a, b in st.kept]


def _rel_l1(a, b) -> float:
    return float((a.double() - b.double()).abs().sum()
                 / b.double().abs().sum().clamp_min(1e-300))


def compare(outputs, reference) -> dict:
    """{number: value}, each the worst over the kept calls."""
    steady = max(_rel_l1(a[0], b[0]) for a, b in zip(outputs, reference))
    trans = max(_rel_l1(a[1], b[1]) for a, b in zip(outputs, reference))
    return {"steady_rel_l1": steady, "transient_rel_l1": trans}
