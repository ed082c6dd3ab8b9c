"""The plain reference of the benchmark's renders, in straightforward
PyTorch: brute-force ray / triangle tests against every triangle, one
dense wavefront a bounce, films accumulated with ``index_add_``.

It implements the estimators that the renderer under test documents and
that mitransient defines, from the same sample streams
(:mod:`reference.streams`), so that a correct renderer agrees with it
sample for sample, up to rounding and the rare discrete decision that
rounding flips:

* :func:`trace_surface`: the transient path tracer (``transient_path``)
  of diffuse scenes with one area light: next-event estimation with a
  shadow ray, power-heuristic MIS, cosine-hemisphere BSDF sampling,
  Russian roulette from ``rr_depth`` on the throughput's largest channel
  (at most 0.95, survivors divided by it), optical path lengths splatted
  into time bins; bounce dims 0-1 NEE, 2-4 BSDF, 5 roulette.
* :func:`trace_nlos`: the NLOS capture (``transient_nlos_path`` with laser
  sampling and hidden-geometry sampling, no roulette on it): sensor rays
  from the sensor origin to the scan points, the two-segment laser NEE
  through the illuminated wall point, hidden-geometry direction sampling;
  the sensor -> wall segment is not counted in the path length; bounce
  dims 4-5 the hidden point.
* :func:`prb_gradient`: the gradient of <adjoint, film> with respect to
  each diffuse reflectance as path replay backpropagation defines it (the
  adjoint read once per vertex at the vertex's own time bin, sampling and
  roulette detached): at a vertex on a surface of reflectance rho,
  d/drho = (Lr_dir + L_after) / rho, L_after the radiance the rest of the
  path brings back through the sampled direction.

Every float is computed in the scene tensors' dtype: the control of the
benchmark's comparison runs this same code in bfloat16.
"""
from __future__ import annotations

import math

import torch

from .streams import PassStreams, pcg_uniform

RAY_EPS = 1e-4
SHADOW_EPS = 1e-4
INV_PI = 1.0 / math.pi

# Arithmetic is written out in a fixed order (a dot product as ax*bx +
# ay*by + az*bz, one rounding an operation), square roots and cosines are
# taken correctly rounded (through float64) and a division by a constant
# divides: the order the renderer documents for its own bit-reproducible
# results on the card and the CPU.  Rounding alone then rarely parts this
# reference from a correct renderer; a path that parts (a hit on a shared
# edge, a roulette draw at the threshold, an event at a bin's edge) moves
# a whole sample, which the comparison's limits must absorb.


def dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def sqrt(x):
    return torch.sqrt(x.double()).to(x.dtype)


def cos_sin(x):
    xd = x.double()
    return torch.cos(xd).to(x.dtype), torch.sin(xd).to(x.dtype)


def div(x, c: float):
    """``x / c``, a division (not a product with a rounded 1 / c)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def normalize(a):
    return a / sqrt(torch.clamp_min(dot(a, a), 1e-24))[..., None]


def safe_div(a, b):
    small = torch.abs(b) < 1e-20
    return torch.where(small, torch.zeros_like(a), a / torch.where(
        small, torch.ones_like(b), b))


def mis_weight(a, b):
    a2 = a * a
    w = safe_div(a2, a2 + b * b)
    return torch.where(torch.isfinite(w), w, torch.zeros_like(w))


def onb(n):
    """Duff et al. 2017 tangent frame (s, t) of the unit normals ``n``."""
    sign = torch.where(n[:, 2] >= 0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + n[:, 2])
    b = n[:, 0] * n[:, 1] * a
    s = torch.stack([1.0 + sign * n[:, 0] * n[:, 0] * a, sign * b,
                     -sign * n[:, 0]], -1)
    t = torch.stack([b, sign + n[:, 1] * n[:, 1] * a, -n[:, 1]], -1)
    return s, t


def cosine_hemisphere(u, v):
    """Shirley-Chiu concentric disk lifted to the cosine hemisphere."""
    x, y = 2.0 * u - 1.0, 2.0 * v - 1.0
    zero = (x == 0) & (y == 0)
    first = torch.abs(x) > torch.abs(y)
    sx = torch.where(zero, torch.ones_like(x), x)
    sy = torch.where(zero, torch.ones_like(y), y)
    r = torch.where(zero, torch.zeros_like(x), torch.where(first, x, y))
    phi = torch.where(first, (math.pi / 4) * (sy / sx),
                      math.pi / 2 - (math.pi / 4) * (sx / sy))
    phi = torch.where(zero, torch.zeros_like(phi), phi)
    c, s = cos_sin(phi)
    px, py = r * c, r * s
    z = sqrt(torch.clamp_min(1.0 - px * px - py * py, 0.0))
    return torch.stack([px, py, z], -1)


def _moller_trumbore(S, o, d):
    """Every ray against every triangle -> (t (N, M), hit (N, M))."""
    v0, e1, e2 = S["v0"][None], S["e1"][None], S["e2"][None]
    dd = d[:, None, :]
    pvec = cross(dd, e2)
    det = dot(e1, pvec)
    ok = torch.abs(det) > 1e-12
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
    tvec = o[:, None, :] - v0
    u = dot(tvec, pvec) * inv
    qvec = cross(tvec, e1)
    v = dot(dd, qvec) * inv
    t = dot(e2, qvec) * inv
    return t, ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > RAY_EPS)


def closest_hit(S, o, d, active):
    """-> (t (N,), triangle (N,) int64, -1 on a miss)."""
    t, hit = _moller_trumbore(S, o, d)
    hit = hit & active[:, None]
    tm = torch.where(hit, t, torch.full_like(t, float("inf")))
    best = tm.amin(dim=1)
    tri = (tm == best[:, None]).to(torch.int8).argmax(dim=1)  # the lowest
    found = torch.isfinite(best)
    return best, torch.where(found, tri, torch.full_like(tri, -1))


def occluded(S, o, d, maxt, active):
    t, hit = _moller_trumbore(S, o, d)
    return (hit & (t < maxt[:, None])).any(dim=1) & active


def shadow(S, p, to, dist, active):
    """Whether the segment from ``p`` along unit ``to`` is blocked before
    ``dist``: offset 1e-4 at both ends, the far end shortened by 0.1 %."""
    return occluded(S, p + to * SHADOW_EPS, to,
                    (dist - 2 * SHADOW_EPS) * (1.0 - 1e-3), active)


def time_bin(F, dist):
    """OPL -> bin index, ``F["bins"]`` (the dropped slot) when outside."""
    pos = div(dist - F["start_opl"], F["bin_width"])
    ok = (pos >= 0) & (pos < F["bins"])
    return torch.where(ok, torch.floor(pos),
                       torch.full_like(pos, F["bins"])).long()


class Film:
    """Transient (slots, T + 1, C) and steady (slots, C) sums of a set of
    film slots (pixels or scan points)."""

    def __init__(self, slots, bins, start_opl, bin_width, channels, dtype,
                 device):
        self.F = dict(bins=bins, start_opl=start_opl, bin_width=bin_width)
        self.transient = torch.zeros((slots * (bins + 1), channels),
                                     dtype=dtype, device=device)
        self.steady = torch.zeros((slots, channels), dtype=dtype,
                                  device=device)
        self.slots, self.bins = slots, bins

    def splat(self, slot, dist, value):
        idx = slot * (self.bins + 1) + time_bin(self.F, dist)
        self.transient.index_add_(0, idx, value)

    def result(self, spp: int):
        """(steady mean (slots, C), transient (slots, T, C)), float32."""
        tr = self.transient.view(self.slots, self.bins + 1, -1)
        return ((self.steady.float() / spp),
                tr[:, :self.bins].float())


def camera_rays(S, width, height, pix, j0, j1):
    px = (pix % width).to(S["dtype"])
    py = (pix // width).to(S["dtype"])
    u = div(px + j0.to(S["dtype"]), width)
    v = div(py + j1.to(S["dtype"]), height)
    th = S["tan_half"]
    dc = torch.stack([(1.0 - 2.0 * u) * th[0], (1.0 - 2.0 * v) * th[1],
                      torch.ones_like(u)], -1)
    d = normalize(dc @ S["cam_R"].T)
    return S["cam_o"].expand_as(d), d


def _sample_light(S, p, u0, u1):
    """Area-proportional point on the light -> (dir, dist, pdf, radiance)."""
    cdf = S["light_cdf"]
    uc = torch.clamp(u0, 0.0, 1.0 - 1e-7)
    k = torch.clamp(torch.searchsorted(cdf, uc.contiguous()), 0,
                    cdf.shape[0] - 1)
    lo = torch.where(k > 0, cdf[torch.clamp_min(k - 1, 0)],
                     torch.zeros_like(uc))
    pmf = torch.clamp_min(cdf[k] - lo, 1e-30)
    ur = torch.clamp((uc - lo) / pmf, 0.0, 1.0 - 1e-7)
    su = sqrt(torch.clamp_min(ur, 0.0))
    q = (S["light_v0"][k] + S["light_e1"][k] * (1.0 - su)[:, None]
         + S["light_e2"][k] * (u1 * su)[:, None])
    dv = q - p
    dist = sqrt(torch.clamp_min(dot(dv, dv), 1e-20))
    w = dv / dist[:, None]
    cos_l = dot(S["light_ng"][k], -w)
    pdf = safe_div(dist * dist, torch.clamp_min(cos_l, 0.0)
                   * S["light_area"])
    rad = torch.where((cos_l > 0)[:, None], S["radiance"].expand(
        p.shape[0], -1), torch.zeros_like(p))
    return w, dist, pdf, rad


def _light_pdf_at_hit(S, prev_p, p, n, on_light):
    dv = p - prev_p
    d2 = dot(dv, dv)
    dist = sqrt(torch.clamp_min(d2, 1e-20))
    cos_l = dot(n, -(dv / dist[:, None]))
    pdf = safe_div(d2, torch.clamp_min(cos_l, 0.0) * S["light_area"])
    return torch.where(on_light & (cos_l > 0), pdf, torch.zeros_like(pdf))


def trace_surface(S, o, d, draw, max_depth, rr_depth, on_bounce=None):
    """One wavefront of camera rays through a diffuse scene with an area
    light.  ``draw(it)`` -> (N, 6) numbers of bounce ``it`` (NEE 0-1, BSDF
    2-4, roulette 5).  ``on_bounce(it, rec)`` sees each bounce's record.
    -> L (N, C), the path's total radiance."""
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
        rho = S["refl"][k]
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
        Lr = torch.where(valid[:, None],
                         beta * mis_weight(lpdf, pdf_b)[:, None] * f_em
                         * em_weight, torch.zeros_like(beta))
        nee_dist = distance + ldist * 1.0

        wo = cosine_hemisphere(u[:, 3], u[:, 4])
        pdf_s = torch.clamp_min(wo[:, 2], 0.0) * INV_PI
        ok = (cont & (wi_z > 0) & (pdf_s > 0)
              & (rho != 0).any(-1))
        if on_bounce is not None:
            on_bounce(it, dict(active=active, hit=hit, distance=distance,
                               Le=Le, Lr=Lr, nee_dist=nee_dist, tri=k,
                               sampled=ok, rho=rho))
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


def _chunks(n, size):
    for a in range(0, n, size):
        yield a, min(n, a + size)


def render_regen(S, dims, seed, spp, pixels, chunk=1 << 20):
    """Films of the path-regeneration render at ``pixels`` (int64 indices):
    sample s of pixel p draws dim k from PCG(seed, s * HW + p, k): dims 0-1
    the pixel jitter, bounce b's dim j at 2 + 8 b + j."""
    W, H, T = dims["width"], dims["height"], dims["bins"]
    hw = W * H
    P = pixels.shape[0]
    film = Film(P, T, dims["start_opl"], dims["bin_width"], 3, S["dtype"],
                pixels.device)
    lanes = P * spp
    for a, b in _chunks(lanes, chunk):
        li = torch.arange(a, b, device=pixels.device)
        slot, s = li % P, li // P
        pix = pixels[slot]
        sid = s * hw + pix
        o, d = camera_rays(S, W, H, pix, pcg_uniform(seed, sid, 0),
                           pcg_uniform(seed, sid, 1))

        def draw(it):
            base = 2 + 8 * it
            return torch.stack([pcg_uniform(seed, sid, base + j)
                                for j in range(6)], -1)

        def splat(it, r, slot=slot):
            film.splat(slot, r["distance"], torch.where(
                r["active"][:, None], r["Le"] / spp, 0.0))
            film.splat(slot, r["nee_dist"], torch.where(
                r["active"][:, None], r["Lr"] / spp, 0.0))

        L = trace_surface(S, o, d, draw, dims["max_depth"], dims["rr_depth"],
                          splat)
        film.steady.index_add_(0, slot, L)
    return film.result(spp)


def pass_split(spp, hw, max_lanes):
    """(spp a pass, passes): the renderer's split of an spp budget."""
    per = max(1, min(spp, max_lanes // max(hw, 1)))
    passes = (spp + per - 1) // per
    return (spp + passes - 1) // passes, passes


def render_multipass(S, dims, seed, spp, pixels, max_lanes=1 << 21,
                     chunk=1 << 20):
    """Films of the multi-pass render at ``pixels``: pass i traces lanes
    s * HW + p, s < spp a pass, under the threefry key fold_in(key(seed),
    i); dims 0-1 the jitter, a bounce's six numbers one block."""
    W, H, T = dims["width"], dims["height"], dims["bins"]
    hw = W * H
    per, passes = pass_split(spp, hw, max_lanes)
    total = per * passes
    P = pixels.shape[0]
    film = Film(P, T, dims["start_opl"], dims["bin_width"], 3, S["dtype"],
                pixels.device)
    for ps in range(passes):
        for a, b in _chunks(P * per, chunk):
            li = torch.arange(a, b, device=pixels.device)
            slot, s = li % P, li // P
            pix = pixels[slot]
            st = PassStreams(seed, ps, s * hw + pix, 6)
            o, d = camera_rays(S, W, H, pix, st.scalar_dim(0),
                               st.scalar_dim(1))

            def splat(it, r, slot=slot):
                film.splat(slot, r["distance"], torch.where(
                    r["active"][:, None], r["Le"] / total, 0.0))
                film.splat(slot, r["nee_dist"], torch.where(
                    r["active"][:, None], r["Lr"] / total, 0.0))

            L = trace_surface(S, o, d, st.bounce, dims["max_depth"],
                              dims["rr_depth"], splat)
            film.steady.index_add_(0, slot, L)
    return film.result(total)


def prb_gradient(S, dims, seed, spp, adjoint, rows, max_lanes=1 << 23,
                 chunk=1 << 20):
    """d<adjoint, transient film>/d(reflectance) of each triangle's
    reflectance, summed by ``rows`` (int64 (M,) -> row index), for the
    whole film: chunks of the spp budget as the renderer splits them (at
    most ``max_lanes`` lanes a chunk), each under its own threefry key.
    ``adjoint`` is (HW, T, C).  -> (gradient (R, 3), its mass (R, 3): the
    sum of the absolute values of the vertices' terms), float64."""
    W, H, T = dims["width"], dims["height"], dims["bins"]
    hw = W * H
    per, passes = pass_split(spp, hw, max_lanes)
    total = per * passes
    dev, dt = adjoint.device, S["dtype"]
    F = dict(bins=T, start_opl=dims["start_opl"],
             bin_width=dims["bin_width"])
    adj = adjoint.reshape(hw * T, -1).to(dt)
    n_rows = int(rows.max()) + 1
    grad = torch.zeros((n_rows, 3), dtype=torch.float64, device=dev)
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
                inb = bn < T
                read = torch.where(inb[:, None], adj[
                    pix * T + torch.clamp_max(bn, T - 1)],
                    torch.zeros_like(L))
                after = rest - r["Le"] - r["Lr"]
                rho = torch.where(r["rho"] != 0, r["rho"],
                                  torch.ones_like(r["rho"]))
                dl = (r["Lr"] + torch.where(r["sampled"][:, None], after,
                                            torch.zeros_like(after))) / rho
                g = torch.where(r["active"][:, None], read * dl / total,
                                torch.zeros_like(dl))
                grad.index_add_(0, rows[r["tri"]], g.double())
                mass.index_add_(0, rows[r["tri"]], g.double().abs())
                rest = after
    return grad, mass


def render_nlos(S, dims, seed, spp, pixels, max_lanes=1 << 21,
                chunk=1 << 20):
    """Films of the NLOS single capture at the scan points ``pixels``."""
    hw = dims["width"] * dims["height"]
    per, passes = pass_split(spp, hw, max_lanes)
    total = per * passes
    P = pixels.shape[0]
    film = Film(P, dims["bins"], dims["start_opl"], dims["bin_width"], 3,
                S["dtype"], pixels.device)
    for ps in range(passes):
        for a, b in _chunks(P * per, chunk):
            li = torch.arange(a, b, device=pixels.device)
            slot, s = li % P, li // P
            pix = pixels[slot]
            st = PassStreams(seed, ps, s * hw + pix, 10)
            L = trace_nlos(S, pix, st.bounce, dims["max_depth"],
                           dims["rr_depth"],
                           lambda dist, v, slot=slot: film.splat(
                               slot, dist, v / total))
            film.steady.index_add_(0, slot, L)
    return film.result(total)


def _laser_constants(S):
    """The illuminated wall point's outgoing factor: the direction and
    distance to the laser, whether that segment is clear, and the laser's
    irradiance there."""
    to_laser = S["laser_origin"] - S["laser_target"]
    dist = sqrt(dot(to_laser, to_laser))
    d2 = to_laser / dist
    clear = ~shadow(S, S["laser_target"][None], d2[None], dist[None],
                    torch.ones((1,), dtype=torch.bool,
                               device=d2.device))[0]
    em = S["irradiance"] / torch.clamp_min(dist * dist, 1e-20)
    return d2, clear, em


def trace_nlos(S, pix, draw, max_depth, rr_depth, splat):
    """One wavefront of sensor rays of a confocal-free single capture:
    ``splat(dist, value)`` takes each bounce's laser-NEE events."""
    n = pix.shape[0]
    dt, dev = S["dtype"], pix.device
    o = S["sensor_origin"].expand(n, 3)
    d = normalize(S["scan"][pix] - o)
    d2, clear, em = _laser_constants(S)
    wall_n = normalize(S["wall_n"][None])[0]
    beta = torch.ones((n, 3), dtype=dt, device=dev)
    L = torch.zeros_like(beta)
    distance = torch.zeros((n,), dtype=dt, device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    for it in range(max_depth):
        u = draw(it).to(dt)
        t, tri = closest_hit(S, o, d, active)
        hit = active & (tri >= 0)
        k = torch.clamp_min(tri, 0)
        th = torch.where(hit, t, torch.zeros_like(t))
        if it > 0:
            distance = distance + th * 1.0
        p = o + d * th[:, None]
        ng = S["ng"][k]
        nrm = normalize(ng)
        fs, ft = onb(nrm)
        wi_z = dot(-d, nrm)
        rho = S["refl"][k]
        nxt = hit & (it + 1 < max_depth)

        # laser NEE: vertex -> illuminated wall point -> laser
        v1 = S["laser_target"] - p
        dist1 = sqrt(torch.clamp_min(dot(v1, v1), 1e-20))
        d1 = v1 / dist1[:, None]
        ae = nxt & ~shadow(S, p, d1, dist1, nxt) & clear
        co1 = dot(d1, nrm)
        ae = ae & (wi_z > 0) & (co1 > 0)
        f1 = torch.where(ae[:, None], rho * div(co1, math.pi)[:, None],
                         torch.zeros_like(rho))
        ae = ae & (f1.amax(-1) > 1e-7)
        cos_w = dot(wall_n.expand_as(d1), -d1)
        ae = ae & (cos_w > 0)
        pdf_w = dist1 * dist1 / torch.clamp_min(cos_w, 1e-9)
        f1 = torch.where(ae[:, None], f1 / torch.clamp_min(
            pdf_w, 1e-9)[:, None], torch.zeros_like(f1))
        wi2 = dot(-d1, wall_n.expand_as(d1))
        co2 = dot(d2, wall_n)
        f2 = torch.where((ae & (wi2 > 0) & (co2 > 0))[:, None],
                         S["wall_refl"] * div(co2, math.pi),
                         torch.zeros_like(rho))
        Lr = torch.where(ae[:, None], beta * f1 * f2 * em,
                         torch.zeros_like(beta))
        splat(distance + torch.where(ae, dist1, torch.zeros_like(dist1)),
              torch.where(active[:, None], Lr, torch.zeros_like(Lr)))
        L = L + Lr

        # hidden-geometry sampling (dims 4-5)
        cdf = S["hidden_cdf"]
        kk = torch.clamp(torch.searchsorted(cdf, u[:, 4].contiguous()), 0,
                         cdf.shape[0] - 1)
        lo = torch.where(kk > 0, cdf[torch.clamp_min(kk - 1, 0)],
                         torch.zeros_like(u[:, 4]))
        ur = torch.clamp((u[:, 4] - lo) / torch.clamp_min(cdf[kk] - lo,
                                                          1e-30),
                         0.0, 1.0 - 1e-7)
        su = sqrt(torch.clamp_min(ur, 0.0))
        q = (S["hidden_v0"][kk] + S["hidden_e1"][kk] * (1.0 - su)[:, None]
             + S["hidden_e2"][kk] * (u[:, 5] * su)[:, None])
        vh = q - p
        dh_len = sqrt(torch.clamp_min(dot(vh, vh), 1e-20))
        dh = vh / dh_len[:, None]
        cos_g = dot(S["hidden_ng"][kk], -dh)
        ok = nxt & (dot(ng, dh) > 1e-7) & (cos_g > 1e-7)
        wo = torch.stack([dot(dh, fs), dot(dh, ft), dot(dh, nrm)], -1)
        ok_f = ok & (wi_z > 0) & (wo[:, 2] > 0)
        f_h = torch.where(ok_f[:, None],
                          rho * div(wo[:, 2], math.pi)[:, None],
                          torch.zeros_like(rho))
        pdf_h = (1.0 / torch.full((), S["hidden_area"], dtype=dt, device=dev)
                 * dh_len * dh_len / torch.clamp_min(torch.abs(cos_g), 1e-9))
        ok = ok & (pdf_h > 1e-9)
        w_h = f_h * torch.where(ok, 1.0 / torch.clamp_min(pdf_h, 1e-9),
                                torch.zeros_like(pdf_h))[:, None]
        dw = fs * wo[:, 0:1] + ft * wo[:, 1:2] + nrm * wo[:, 2:3]
        side = torch.sign(dot(ng, dw))[:, None]
        o = p + ng * side * RAY_EPS
        d = dw
        beta = torch.where(nxt[:, None], beta * w_h, beta)
        bmax = beta.amax(-1)
        nxt = nxt & (bmax != 0) & (torch.clamp_max(bmax, 0.95) > 0)
        if it >= rr_depth:
            qr = torch.clamp_max(bmax, 0.95)
            scale = 1.0 / torch.clamp_min(qr, 1e-6)
            beta = torch.where(nxt[:, None], beta * scale[:, None], beta)
            nxt = nxt & (u[:, 9] < qr)
        active = nxt
    return L
