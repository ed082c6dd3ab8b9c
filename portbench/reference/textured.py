"""The plain reference of a diffuse scene with one textured reflectance, in
straightforward PyTorch: :mod:`reference.tracer`'s estimators with the
reflectance read per lane from a texture, and the PRB gradient of the
texture's texels.

Re-derived from the scene dict, as mitransient and the renderer under test
document them:

* the ``checkerboard`` texture baked into a 64 x 64 atlas: texel (row v,
  column u) has its centre at ((u + 0.5) / 64, (v + 0.5) / 64) and takes
  ``color1`` where (u > 0.5) xor (v > 0.5), else ``color0``;
* a rectangle's uv: (0, 0), (1, 0), (1, 1), (0, 1) at its corners (-1, -1),
  (1, -1), (1, 1), (-1, 1), interpolated at the hit with the barycentrics
  of the hit point in its triangle (the projection method);
* the lookup: bilinear over four texels with repeat wrapping, texel centres
  at (i + 0.5) / size (Mitsuba's bitmap defaults);
* :func:`prb_texel_gradient`: each vertex's reflectance cotangent, as
  :func:`reference.tracer.prb_gradient` defines it, spread onto its four
  taps' texels with the bilinear weights, summed in float64.

``tracer.trace_surface`` reads one reflectance a triangle, so the tracer's
wavefront is written out here again with the per-lane reflectance; every
other piece is the tracer's.  Every float is computed in the scene
tensors' dtype, as in the tracer.
"""
from __future__ import annotations

import copy
import math

import numpy as np
import torch

from .scene import RefScene, _RECT
from .streams import PassStreams, pcg_uniform
from .tracer import (
    INV_PI,
    RAY_EPS,
    Film,
    _chunks,
    _light_pdf_at_hit,
    _sample_light,
    camera_rays,
    closest_hit,
    cosine_hemisphere,
    div,
    dot,
    mis_weight,
    normalize,
    onb,
    pass_split,
    safe_div,
    shadow,
    time_bin,
)

CHECKER_RES = 64  # the renderer's bake of a checkerboard
# Mitsuba's checkerboard defaults
CHECKER_DEFAULTS = {"color0": 0.4, "color1": 0.2}
_RECT_UV = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], float)


def _rgb(spec) -> np.ndarray:
    value = spec["value"] if isinstance(spec, dict) else spec
    return np.broadcast_to(np.asarray(value, float), (3,))


def checkerboard(spec: dict, res: int = CHECKER_RES) -> np.ndarray:
    """The (res, res, 3) float32 texels of a ``checkerboard`` texture,
    rows v and columns u."""
    c0 = _rgb(spec.get("color0", CHECKER_DEFAULTS["color0"]))
    c1 = _rgb(spec.get("color1", CHECKER_DEFAULTS["color1"]))
    centre = (np.arange(res) + 0.5) / res
    mask = (centre[None, :] > 0.5) ^ (centre[:, None] > 0.5)
    return np.where(mask[..., None], c1, c0).astype(np.float32)


def _textured_bsdf(desc: dict):
    """-> (the BSDF's name as ``RefScene`` names it, the BSDF's dict in
    ``desc``): the one diffuse BSDF of the dict whose reflectance is a
    texture, top-level or inline on a shape."""
    found = []
    for key, val in desc.items():
        if not isinstance(val, dict):
            continue
        b = val.get("bsdf") if val.get("type") in ("rectangle", "cube") \
            else val
        if (isinstance(b, dict) and b.get("type") == "diffuse"
                and b.get("reflectance", {}).get("type") not in (None, "rgb")):
            found.append((key, b))
    if len(found) != 1:
        raise ValueError("one textured diffuse BSDF is covered")
    return found[0]


class TexturedScene:
    """:class:`RefScene` of a dict whose one textured BSDF lies on
    rectangles, with the triangles' uv and the texture's texels."""

    def __init__(self, desc: dict):
        plain = copy.deepcopy(desc)
        name, bsdf = _textured_bsdf(plain)
        tex = bsdf["reflectance"]
        if tex["type"] != "checkerboard" or "to_uv" in tex:
            raise ValueError(f"texture {tex!r} is not covered")
        # a placeholder for RefScene, never read on the textured triangles
        bsdf["reflectance"] = {"type": "rgb", "value": [0.5] * 3}
        self.ref = ref = RefScene(plain)
        self.textured = ref.bsdf_name == name
        shapes = [v for v in desc.values() if isinstance(v, dict)
                  and v.get("type") in ("rectangle", "cube")]
        if any(shapes[s]["type"] != "rectangle"
               for s in set(ref.shape_id[self.textured].tolist())):
            raise ValueError("a texture on a rectangle is covered")
        faces = _RECT[1]
        # the triangles of each rectangle are split (0, 1, 2), (0, 2, 3);
        # every shape holds an even count, so the parity of a triangle's
        # index is its parity in its rectangle
        local = np.arange(ref.triangles) % 2
        self.uv0 = _RECT_UV[faces[local, 0]]
        self.uv_e1 = _RECT_UV[faces[local, 1]] - self.uv0
        self.uv_e2 = _RECT_UV[faces[local, 2]] - self.uv0
        self.texels = checkerboard(tex)

    def to(self, device, dtype=torch.float32) -> dict:
        """The tracer's tensors (:meth:`RefScene.to`) with the texture's:
        ``textured`` (M,) bool, ``uv0``, ``uv_e1``, ``uv_e2`` (M, 2) and
        ``texels`` (H, W, 3), floats in ``dtype``."""
        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), dtype=dtype,
                                   device=device)

        S = self.ref.to(device, dtype)
        S.update(textured=torch.as_tensor(self.textured, device=device),
                 uv0=t(self.uv0), uv_e1=t(self.uv_e1), uv_e2=t(self.uv_e2),
                 texels=t(self.texels))
        return S


def hit_uv(S, k, p):
    """uv at the points ``p`` of the triangles ``k``: the barycentrics of
    ``p`` by projection onto the triangle's edges."""
    e1, e2 = S["e1"][k], S["e2"][k]
    w = p - S["v0"][k]
    d00, d01, d11 = dot(e1, e1), dot(e1, e2), dot(e2, e2)
    d20, d21 = dot(w, e1), dot(w, e2)
    denom = d00 * d11 - d01 * d01
    inv = safe_div(torch.ones_like(denom), denom)
    u = (d11 * d20 - d01 * d21) * inv
    v = (d00 * d21 - d01 * d20) * inv
    return (S["uv0"][k] + S["uv_e1"][k] * u[:, None]
            + S["uv_e2"][k] * v[:, None])


def lookup(texels, uv):
    """Bilinear lookup with repeat wrapping -> (value (N, 3), the four taps'
    flat texel indices (N, 4), their weights (N, 4))."""
    h, w = texels.shape[:2]
    u = uv[:, 0] - torch.floor(uv[:, 0])
    v = uv[:, 1] - torch.floor(uv[:, 1])
    x = u * w - 0.5
    y = v * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[:, None], (y - y0)[:, None]
    flat = texels.reshape(h * w, -1)
    rows, taps = [], []
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        xi = torch.remainder(x0 + dx, w).long()
        yi = torch.remainder(y0 + dy, h).long()
        rows.append(yi * w + xi)
        taps.append(flat[rows[-1]])
    c00, c10, c01, c11 = taps
    value = ((c00 * (1.0 - fx) + c10 * fx) * (1.0 - fy)
             + (c01 * (1.0 - fx) + c11 * fx) * fy)
    weights = torch.cat([(1.0 - fx) * (1.0 - fy), fx * (1.0 - fy),
                         (1.0 - fx) * fy, fx * fy], -1)
    return value, torch.stack(rows, -1), weights


def trace_surface(S, o, d, draw, max_depth, rr_depth, on_bounce=None):
    """``tracer.trace_surface`` with the reflectance of textured triangles
    looked up at each hit.  A bounce's record adds ``Lr_rho`` (Lr's
    derivative by the vertex's reflectance), ``textured``, ``taps`` and
    ``tap_weights``.  -> L (N, C)."""
    n = o.shape[0]
    dt, dev = S["dtype"], o.device
    beta = torch.ones((n, 3), dtype=dt, device=dev)
    L = torch.zeros_like(beta)
    distance = torch.zeros((n,), dtype=dt, device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    prev_p = o
    prev_pdf = torch.ones((n,), dtype=dt, device=dev)
    prev_delta = torch.ones_like(active)
    for it in range(max_depth):
        u = draw(it).to(dt)
        t, tri = closest_hit(S, o, d, active)
        hit = active & (tri >= 0)
        k = torch.clamp_min(tri, 0)
        th = torch.where(hit, t, torch.zeros_like(t))
        distance = distance + th * 1.0
        p = o + d * th[:, None]
        ng = S["ng"][k]
        nrm = normalize(ng)
        fs, ft = onb(nrm)
        wi_z = dot(-d, nrm)
        textured = hit & S["textured"][k]
        texel, taps, tap_weights = lookup(S["texels"], hit_uv(S, k, p))
        rho = torch.where(textured[:, None], texel, S["refl"][k])
        on_light = hit & S["is_emitter"][k]

        pdf_hit = torch.where(prev_delta, torch.zeros_like(t),
                              _light_pdf_at_hit(S, prev_p, p, ng, on_light))
        mis = mis_weight(prev_pdf, pdf_hit)
        front = (dot(ng, -d) > 0)[:, None]
        Le = torch.where((on_light[:, None] & front),
                         beta * mis[:, None] * S["radiance"],
                         torch.zeros_like(beta))

        cont = hit & (it + 1 < max_depth)
        w, ldist, lpdf, lrad = _sample_light(S, p, u[:, 0], u[:, 1])
        valid = cont & (lpdf > 0) & (torch.abs(lrad).sum(-1) > 0)
        valid = valid & ~shadow(S, p, w, ldist, valid)
        em_weight = torch.where(valid[:, None],
                                safe_div(lrad, lpdf[:, None]),
                                torch.zeros_like(lrad))
        lpdf = torch.where(valid, lpdf, torch.zeros_like(lpdf))
        co = dot(w, nrm)
        lit = valid & (wi_z > 0) & (co > 0)
        f_em = torch.where(lit[:, None], rho * div(co, math.pi)[:, None],
                           torch.zeros_like(rho))
        pdf_b = torch.where(lit, torch.clamp_min(co, 0.0) * INV_PI,
                            torch.zeros_like(co))
        mis_em = mis_weight(lpdf, pdf_b)[:, None]
        Lr = torch.where(valid[:, None], beta * mis_em * f_em * em_weight,
                         torch.zeros_like(beta))
        Lr_rho = torch.where((valid & lit)[:, None], beta * mis_em
                             * div(co, math.pi)[:, None] * em_weight,
                             torch.zeros_like(beta))
        nee_dist = distance + ldist * 1.0

        wo = cosine_hemisphere(u[:, 3], u[:, 4])
        pdf_s = torch.clamp_min(wo[:, 2], 0.0) * INV_PI
        ok = (cont & (wi_z > 0) & (pdf_s > 0)
              & (rho != 0).any(-1))
        if on_bounce is not None:
            on_bounce(it, dict(active=active, hit=hit, distance=distance,
                               Le=Le, Lr=Lr, Lr_rho=Lr_rho,
                               nee_dist=nee_dist, tri=k, sampled=ok,
                               rho=rho, textured=textured, taps=taps,
                               tap_weights=tap_weights))
        L = L + Le + Lr
        dw = (fs * wo[:, 0:1] + ft * wo[:, 1:2] + nrm * wo[:, 2:3])
        side = torch.sign(dot(ng, dw))[:, None]
        o_next = p + ng * side * RAY_EPS
        beta = torch.where(cont[:, None],
                           beta * torch.where(ok[:, None], rho,
                                              torch.zeros_like(rho)), beta)
        bmax = beta.amax(-1)
        cont = cont & (bmax != 0)
        q = torch.clamp_max(bmax, 0.95)
        cont = cont & (q > 0)
        if it >= rr_depth:
            scale = 1.0 / torch.clamp_min(q, 1e-30)
            beta = torch.where(cont[:, None], beta * scale[:, None], beta)
            cont = cont & (u[:, 5] < q)
        prev_p = torch.where(hit[:, None], p, prev_p)
        prev_pdf = torch.where(cont, torch.where(ok, pdf_s, 0.0), prev_pdf)
        prev_delta = prev_delta & ~cont
        o, d, active = o_next, dw, cont
    return L


def _film_splat(film, slot, spp):
    def splat(it, r):
        film.splat(slot, r["distance"], torch.where(
            r["active"][:, None], r["Le"] / spp, 0.0))
        film.splat(slot, r["nee_dist"], torch.where(
            r["active"][:, None], r["Lr"] / spp, 0.0))
    return splat


def _film(dims, pixels, dtype):
    return Film(pixels.shape[0], dims["bins"], dims["start_opl"],
                dims["bin_width"], 3, dtype, pixels.device)


def render_regen(S, dims, seed, spp, pixels, chunk=1 << 20):
    """``tracer.render_regen`` of the textured scene (PCG streams)."""
    hw = dims["width"] * dims["height"]
    P = pixels.shape[0]
    film = _film(dims, pixels, S["dtype"])
    for a, b in _chunks(P * spp, chunk):
        li = torch.arange(a, b, device=pixels.device)
        slot, s = li % P, li // P
        pix = pixels[slot]
        sid = s * hw + pix
        o, d = camera_rays(S, dims["width"], dims["height"], pix,
                           pcg_uniform(seed, sid, 0),
                           pcg_uniform(seed, sid, 1))

        def draw(it):
            base = 2 + 8 * it
            return torch.stack([pcg_uniform(seed, sid, base + j)
                                for j in range(6)], -1)

        L = trace_surface(S, o, d, draw, dims["max_depth"], dims["rr_depth"],
                          _film_splat(film, slot, spp))
        film.steady.index_add_(0, slot, L)
    return film.result(spp)


def render_multipass(S, dims, seed, spp, pixels, max_lanes=1 << 21,
                     chunk=1 << 20):
    """``tracer.render_multipass`` of the textured scene (threefry)."""
    hw = dims["width"] * dims["height"]
    per, passes = pass_split(spp, hw, max_lanes)
    total = per * passes
    P = pixels.shape[0]
    film = _film(dims, pixels, S["dtype"])
    for ps in range(passes):
        for a, b in _chunks(P * per, chunk):
            li = torch.arange(a, b, device=pixels.device)
            slot, s = li % P, li // P
            pix = pixels[slot]
            st = PassStreams(seed, ps, s * hw + pix, 6)
            o, d = camera_rays(S, dims["width"], dims["height"], pix,
                               st.scalar_dim(0), st.scalar_dim(1))
            L = trace_surface(S, o, d, st.bounce, dims["max_depth"],
                              dims["rr_depth"], _film_splat(film, slot, total))
            film.steady.index_add_(0, slot, L)
    return film.result(total)


def prb_texel_gradient(S, dims, seed, spp, adjoint, max_lanes=1 << 23,
                       chunk=1 << 20):
    """d<adjoint, transient film>/d(texels) as path replay backpropagation
    defines it (``tracer.prb_gradient``: the adjoint read once a vertex at
    its own time bin; at a vertex of reflectance rho the cotangent is
    Lr_dir's derivative by rho plus L_after / rho where the BSDF was
    sampled), spread onto each textured vertex's four taps with their
    bilinear weights.  ``adjoint`` is (HW, T, C).  -> (gradient (H, W, 3),
    its mass (H, W, 3): the sum of the absolute values of the terms),
    float64."""
    W, H, T = dims["width"], dims["height"], dims["bins"]
    hw = W * H
    per, passes = pass_split(spp, hw, max_lanes)
    total = per * passes
    dev = adjoint.device
    F = dict(bins=T, start_opl=dims["start_opl"],
             bin_width=dims["bin_width"])
    adj = adjoint.reshape(hw * T, -1).to(S["dtype"])
    th, tw = S["texels"].shape[:2]
    grad = torch.zeros((th * tw, 3), dtype=torch.float64, device=dev)
    mass = torch.zeros_like(grad)
    for ps in range(passes):
        for a, b in _chunks(hw * per, chunk):
            li = torch.arange(a, b, device=dev)
            pix = li % hw
            st = PassStreams(seed, ps, li, 6)
            o, d = camera_rays(S, W, H, pix, st.scalar_dim(0),
                               st.scalar_dim(1))
            recs = []
            L = trace_surface(S, o, d, st.bounce, dims["max_depth"],
                              dims["rr_depth"],
                              lambda it, r: recs.append(r))
            rest = L
            for r in recs:
                bn = time_bin(F, r["distance"])
                read = torch.where((bn < T)[:, None], adj[
                    pix * T + torch.clamp_max(bn, T - 1)],
                    torch.zeros_like(L))
                after = rest - r["Le"] - r["Lr"]
                rho = r["rho"]
                ind = torch.where(r["sampled"][:, None] & (rho != 0),
                                  after / torch.where(rho != 0, rho,
                                                      torch.ones_like(rho)),
                                  torch.zeros_like(after))
                keep = (r["active"] & r["textured"])[:, None]
                g = torch.where(keep, read * (r["Lr_rho"] + ind) / total,
                                torch.zeros_like(ind)).double()
                for j in range(4):
                    term = r["tap_weights"][:, j:j + 1].double() * g
                    grad.index_add_(0, r["taps"][:, j], term)
                    mass.index_add_(0, r["taps"][:, j], term.abs())
                rest = after
    return grad.view(th, tw, 3), mass.view(th, tw, 3)
