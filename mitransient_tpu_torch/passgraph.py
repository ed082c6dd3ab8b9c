"""The multi-pass renders' pass loop, and the pass as one CUDA graph,
captured once and replayed.

A multi-pass render (``render.py:_multipass_render``,
``integrators/nlos_path.py:render_nlos`` and
``render_nlos_confocal_scan``) runs its passes through :func:`run_passes`:
pass p runs a body ``(sd, ctx, film, key, scale) -> (film, n_rays)`` on
the scene, the camera or NLOS context, the film, the pass's stream key
(row p of the render's ``rng.pass_keys``, one upload a render) and the
splat scale (1 / total spp), eagerly or as a replay of a graph.

The graph: every pass of a perspective multi-pass render runs one body,
``render._perspective_pass``: the camera rays, the ``max_depth`` bounces
of ``integrators/path.py`` (K1, K2, K3, a threefry block and the eager
arithmetic of each) and the steady splat, over lanes of one shape.  On the
card the host issues that body as some 4,100 launches a pass of 2^21
lanes, more slowly than the card runs them.  A render that takes this
route (:func:`route`, :func:`eligible`) instead captures the body once
into a ``torch.cuda.CUDAGraph`` and replays it for every later pass of
every render of the same structure: one graph launch a pass, after one
copy of the pass's key.  The graph replays the same kernels with the same
arguments in the same order, so its films are bit for bit the eager
body's.

* **What the graph reads.**  A graph keeps the addresses and arguments of
  its capture, so the body runs on buffers that a :class:`PassGraph`
  owns: copies of the scene's tensors and of the camera's, the splat scale
  as a 0-dim tensor, the film's steady sums and counters, which a pass
  makes anew and the graph copies back into them, and one stream key,
  which the threefry kernel reads when it runs (``csrc/rng.cu``).  A
  render copies its scene, camera, scale, steady sums and counters into
  them once, before its first pass; before each replay the pass's row of
  the render's key table is copied into the key (8 bytes, on the device).
* **The film.**  K3 splats into the transient film in place, and every
  render splats into a film of its own, as the eager body does: the
  graph's K3 launches read the film's address from a device slot when they
  run (``film/transient_film.py:splatting_at``), which a render sets to
  its film's before its first pass.  So a render's output is never a
  buffer that the next render overwrites, and a caller may keep it.
* **When it captures.**  A render that finds no graph of its structure
  runs its first pass eagerly on those buffers (which also loads every
  kernel the body launches), then captures the body for the passes that
  remain.  The structure is what the body was built from: the shapes,
  strides, dtypes and devices of the scene's, the camera's and the film's
  tensors and the host facts beside them (``bsdf_kinds``,
  ``emitter_kinds``, an accel or none), the integrator and film settings,
  the variant, the data window, ``spp_chunk`` (so n) and ``bvh_mode``.
  One graph is kept a device; a render of another structure frees it.
  The graph's private memory pool holds about one eager pass's
  intermediates as reserved memory (``torch.cuda.memory_reserved``), which
  ``max_memory_allocated`` does not count.  A capture that a captured
  operation refuses (a host sync, an upload, a new transient film:
  :func:`refused`) leaves the structure to the eager body, counted as
  ``graph.refusals``; any other error is raised.
* **Tracing.**  The capture runs inside ``trace.capturing``: no span is
  opened (a span records CUDA events), and the body's counts go to the
  graph's sink, its active-lane sum to a device accumulator the graph
  fills on every replay.  Each replay is one ``mitr:graph`` span, after
  which ``trace.replay_counts`` adds the lanes, draws and launches that
  the eager body would have counted; ``mitr:bounce`` and ``mitr:rng`` are
  not entered in a replayed pass.  The counters ``graph.captures``,
  ``graph.replays``, ``graph.eager_passes`` and ``graph.refusals`` say how
  often the route engages (:data:`STATS` counts them always).

The regen loop's block graph (``regengraph.py``) shares :data:`STATS`
(and its ``eager_blocks``) and a device's slot in ``_GRAPHS``, under a
structure of its own, so one graph is kept a device across both routes.
"""
from __future__ import annotations

import logging

import torch

from . import trace
from .core import math as tmath
from .core import rng
from .film.transient_film import splatting_at

STATS = {"captures": 0, "replays": 0, "eager_passes": 0, "refusals": 0,
         "eager_blocks": 0}
_GRAPHS: dict = {}  # device -> its PassGraph or regengraph.RegenGraph


def eligible(device, icfg, film_cfg, variant) -> bool:
    """Whether a multi-pass render takes the graph route: on a CUDA device,
    the ``transient_path`` integrator into a transient film under a mono
    or RGB variant, polarized or not.  Those bodies make no host sync and
    draw only through ``rng.uniform``.  Every other render runs the same
    body eagerly: on the CPU, ``transient_prbvolpath`` (``volpath.py``),
    the phasor film (it uploads its frequencies at each splat) and the
    spectral variants (they upload wavelength tables each pass)."""
    return (torch.device(device).type == "cuda"
            and icfg.kind == "transient_path"
            and film_cfg.kind == "transient_hdr_film"
            and not variant.spectral)


class GraphRefusal(Exception):
    """A pass body did what its graph cannot replay."""


def refused(e: BaseException) -> bool:
    """Whether the error ``e``, raised in a capture, is the capture's
    refusal of an operation: :class:`GraphRefusal`, or an error of the CUDA
    runtime or of PyTorch that names the capture ("operation not permitted
    when stream is capturing", "... during CUDA graph capture ...").  The
    first error of the chain decides: a refused capture's end raises one
    that names the capture whatever the body raised."""
    while e.__context__ is not None:
        e = e.__context__
    return isinstance(e, GraphRefusal) or "captur" in str(e).lower()


def count(name: str) -> None:
    """Count one ``graph.<name>`` event (``STATS`` and the trace)."""
    STATS[name] += 1
    trace.count(f"graph.{name}", 1)


def clear() -> None:
    """Free every pass graph and its buffers."""
    _GRAPHS.clear()


def _describe(t: torch.Tensor):
    return ("tensor", tuple(t.shape), t.stride(), t.dtype, t.device)


def _trees():
    """``parallel/distributed.py``'s tree_leaves and tree_map, imported
    late: ``parallel/`` imports ``render.py``, which imports this module."""
    from .parallel.distributed import tree_leaves, tree_map

    return tree_leaves, tree_map


class PassGraph:
    """The buffers of one structure's pass body on one device, and the
    graph captured on them (None until captured)."""

    def __init__(self, structure, sd, cam, film, device):
        _, tree_map = _trees()
        self.structure = structure
        self.device = device
        self.sd = tree_map(torch.empty_like, sd)
        self.cam = tree_map(torch.empty_like, cam)
        # the film's fields that a pass makes anew; not the transient
        self.fields = {f: torch.empty_like(getattr(film, f))
                       for f in film._fields if f != "transient"}
        self.film_at = torch.zeros((1,), dtype=torch.int64, device=device)
        self.scale = torch.zeros((), dtype=torch.float32, device=device)
        self.key = torch.zeros((2,), dtype=torch.int32, device=device)
        self.graph = None
        self.refused = False  # a capture was refused: this structure is eager
        self.film = self.sink = self.n_rays = None
        self.kept = []  # the scalars the graph reads (core/math.py:divide)

    def begin(self, sd, cam, film, scale: float):
        """Load a render's inputs: its scene, camera, scale and film, whose
        transient its passes splat into.  -> the film the passes accumulate
        into: ``film``'s transient beside this graph's other fields."""
        tree_leaves, _ = _trees()
        for dst, src in zip(tree_leaves((self.sd, self.cam)),
                            tree_leaves((sd, cam))):
            dst.copy_(src)
        self.scale.fill_(scale)
        for name, dst in self.fields.items():
            dst.copy_(getattr(film, name))
        self.film_at.fill_(film.transient.data_ptr())
        self.film = film._replace(**self.fields)
        return self.film

    def run(self, body, key: torch.Tensor, more: bool):
        """One pass under the stream key ``key``: a replay, or the eager
        body on these buffers followed, where ``more`` passes remain, by
        the capture.  -> the pass's ray count (a device scalar, which the
        next replay overwrites)."""
        if self.graph is not None:
            self.key.copy_(key)
            with trace.span("mitr:graph"):
                self.graph.replay()
            trace.replay_counts(self.sink)
            count("replays")
            return self.n_rays
        out, n_rays = body(self.sd, self.cam, self.film, key, self.scale)
        self._store(out)
        count("eager_passes")
        if more and not self.refused and self.device.type == "cuda":
            self._capture(body)
        return n_rays

    def _store(self, out) -> None:
        """Copy the fields a pass made anew into this graph's (K3 splats
        the transient in place)."""
        if out.transient.data_ptr() != self.film.transient.data_ptr():
            raise GraphRefusal("the pass made a new transient film")
        for name, dst in self.fields.items():
            src = getattr(out, name)
            if src is not dst:
                dst.copy_(src)

    def _capture(self, body) -> None:
        """Capture the body on this graph's key; its film's address becomes
        a slot.  A refused capture (:func:`refused`) leaves this structure
        to the eager body."""
        sink = trace.CaptureSink()
        kept: list = []
        graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.current_stream(self.device)
        try:
            with trace.capturing(sink), tmath.keeping(kept), \
                    splatting_at(self.film.transient, self.film_at), \
                    torch.cuda.graph(graph, capture_error_mode="thread_local"):
                out, n_rays = body(self.sd, self.cam, self.film, self.key,
                                   self.scale)
                self._store(out)
        except (RuntimeError, GraphRefusal) as e:
            torch.cuda.set_stream(stream)
            if not refused(e):
                raise
            self.refused = True
            count("refusals")
            logging.getLogger("mitransient_tpu_torch").warning(
                "multi-pass render: the pass could not be captured as a CUDA "
                "graph (%s); its passes run eagerly", e)
            return
        self.graph, self.sink = graph, sink
        self.n_rays, self.kept = n_rays, kept
        count("captures")


def route(sd, cam, film, *, film_cfg, icfg, variant, width, height,
          spp_chunk, bvh_mode) -> PassGraph | None:
    """The pass graph of this multi-pass render into ``film``, or None
    where the render runs its passes eagerly (:func:`eligible`).  A graph
    of another structure is replaced."""
    dev = cam.origin.device
    if not eligible(dev, icfg, film_cfg, variant):
        return None
    _, tree_map = _trees()
    structure = (tree_map(_describe, (sd, cam, film)), film_cfg, icfg,
                 variant, width, height, spp_chunk, bvh_mode)
    g = _GRAPHS.get(dev)
    if g is None or g.structure != structure:
        _GRAPHS.pop(dev, None)
        g = _GRAPHS[dev] = PassGraph(structure, sd, cam, film, dev)
    return g


def run_passes(body, sd, ctx, film, *, seed: int, first: int, n_passes: int,
               scale: float, graph: PassGraph | None = None, rays=0,
               progress_callback=None, checkpoint_callback=None):
    """Passes ``first`` .. ``n_passes - 1`` of a multi-pass render into
    ``film``: pass p calls ``body(sd, ctx, film, key, scale) -> (film,
    n_rays)`` on its stream key, row p of ``rng.pass_keys(seed, ...)``,
    eagerly, or through ``graph`` (:func:`route`).  After each pass
    ``progress_callback(fraction done)`` and ``checkpoint_callback((film
    as host numpy copies, passes done, rays so far))``, where given.
    ``rays`` is the count of the passes before ``first``.  -> (film,
    rays)."""
    keys = rng.pass_keys(seed, range(first, n_passes), film.steady.device)
    if graph is not None:
        film = graph.begin(sd, ctx, film, scale)
    for p in range(first, n_passes):
        key = keys[p - first]
        if graph is None:
            film, n_rays = body(sd, ctx, film, key, scale)
            count("eager_passes")
        else:
            n_rays = graph.run(body, key, more=p + 1 < n_passes)
        # before the next replay overwrites the graph's n_rays
        rays = rays + n_rays
        if progress_callback is not None:
            progress_callback((p + 1) / n_passes)
        if checkpoint_callback is not None:
            checkpoint_callback((
                type(film)(*(a.detach().cpu().numpy().copy() for a in film)),
                p + 1, int(rays)))
    return film, rays
