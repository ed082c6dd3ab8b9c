"""The multi-pass render's pass as one CUDA graph, captured once and
replayed.

Every pass of a multi-pass render (``render.py:_multipass_render``) runs
one body, ``render._perspective_pass``: the camera rays, the
``max_depth`` bounces of ``integrators/path.py`` (K1, K2, K3, a threefry
block and the eager arithmetic of each) and the steady splat, over lanes
of one shape.  On the card the host issues that body as some 4,100
launches a pass of 2^21 lanes, more slowly than the card runs them.  A
render that takes this route (:func:`eligible`) instead captures the body
once into a ``torch.cuda.CUDAGraph`` and replays it for every later pass
of every render of the same structure: one graph launch a pass, after one
small copy of the pass's keys.  The graph replays the same kernels with
the same arguments in the same order, so its films are bit for bit the
eager body's.

* **What the graph reads.**  A graph keeps the addresses and arguments of
  its capture, so the body runs on buffers that a :class:`PassGraph`
  owns: copies of the scene's tensors and of the camera's, the splat scale
  (1 / total spp) as a 0-dim tensor, the film's steady sums and counters,
  which a pass makes anew and the graph copies back into them, and the key
  slots its threefry draws read (``core/rng.py:KeyRecorder``).  A render
  copies its scene, camera, scale, steady sums and counters into them once,
  before its first pass; before each replay the pass's row of the render's
  key table (``rng.pass_key_table``, uploaded once a render) is copied into
  the slots.
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
  operation refuses (a host sync, an upload, a draw under a key the graph
  cannot derive: :func:`refused`) leaves the structure to the eager body,
  counted as ``graph.refusals``; any other error is raised.
* **Tracing.**  The capture runs inside ``trace.capturing``: no span is
  opened (a span records CUDA events), and the body's counts go to the
  graph's sink, its active-lane sum to a device accumulator the graph
  fills on every replay.  Each replay is one ``mitr:graph`` span, after
  which ``trace.replay_counts`` adds the lanes, draws and launches that
  the eager body would have counted; ``mitr:bounce`` and ``mitr:rng`` are
  not entered in a replayed pass.  The counters ``graph.captures``,
  ``graph.replays``, ``graph.eager_passes`` and ``graph.refusals`` say how
  often the route engages (:data:`STATS` counts them always).
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from . import trace
from .core import math as tmath
from .core import rng
from .film.transient_film import splatting_at

MAX_DRAWS = 64  # key slots: the threefry draws a pass may make
STATS = {"captures": 0, "replays": 0, "eager_passes": 0, "refusals": 0}
_GRAPHS: dict = {}  # device -> its PassGraph


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


def refused(e: BaseException) -> bool:
    """Whether the error ``e``, raised in a capture, is the capture's
    refusal of an operation: ``rng.GraphRefusal``, or an error of the CUDA
    runtime or of PyTorch that names the capture ("operation not permitted
    when stream is capturing", "... during CUDA graph capture ...").  The
    first error of the chain decides: a refused capture's end raises one
    that names the capture whatever the body raised."""
    while e.__context__ is not None:
        e = e.__context__
    return isinstance(e, rng.GraphRefusal) or "captur" in str(e).lower()


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

    def __init__(self, structure, sd, cam, film, max_depth, device):
        _, tree_map = _trees()
        self.structure = structure
        self.device = device
        self.max_depth = max_depth
        self.sd = tree_map(torch.empty_like, sd)
        self.cam = tree_map(torch.empty_like, cam)
        # the film's fields that a pass makes anew; not the transient
        self.fields = {f: torch.empty_like(getattr(film, f))
                       for f in film._fields if f != "transient"}
        self.film_at = torch.zeros((1,), dtype=torch.int64, device=device)
        self.scale = torch.zeros((), dtype=torch.float32, device=device)
        self.slots = torch.zeros((MAX_DRAWS, 2), dtype=torch.int32,
                                 device=device)
        self.graph = None
        self.refused = False  # a capture was refused: this structure is eager
        self.film = self.sink = self.dims = self.n_rays = self.table = None
        self.kept = []  # the scalars the graph reads (core/math.py:divide)
        self.seed, self.passes = 0, range(0)

    def begin(self, sd, cam, film, scale: float, seed: int, passes):
        """Load a render's inputs: its scene, camera, scale and film, whose
        transient its passes splat into; ``passes`` (a range) are the
        passes it will run.  -> the film the passes accumulate into:
        ``film``'s transient beside this graph's other fields."""
        tree_leaves, _ = _trees()
        for dst, src in zip(tree_leaves((self.sd, self.cam)),
                            tree_leaves((sd, cam))):
            dst.copy_(src)
        self.scale.fill_(scale)
        for name, dst in self.fields.items():
            dst.copy_(getattr(film, name))
        self.film_at.fill_(film.transient.data_ptr())
        self.film = film._replace(**self.fields)
        self.seed, self.passes = seed, passes
        self.table = None
        if self.graph is not None:
            self._upload()
        return self.film

    def run(self, body, p: int, more: bool):
        """Pass ``p``: one replay, or the eager body on these buffers
        followed, where ``more`` passes remain, by the capture.  -> the
        pass's ray count (a device scalar, which the next replay
        overwrites)."""
        if self.graph is not None:
            self.slots[:len(self.dims)].copy_(
                self.table[p - self.passes.start])
            with trace.span("mitr:graph"):
                self.graph.replay()
            trace.replay_counts(self.sink)
            count("replays")
            return self.n_rays
        out, n_rays = body(self.sd, self.cam, self.film, self.seed, p,
                           self.scale)
        self._store(out)
        count("eager_passes")
        if more and not self.refused and self.device.type == "cuda":
            self._capture(body, p + 1)
        return n_rays

    def _store(self, out) -> None:
        """Copy the fields a pass made anew into this graph's (K3 splats
        the transient in place)."""
        if out.transient.data_ptr() != self.film.transient.data_ptr():
            raise rng.GraphRefusal("the pass made a new transient film")
        for name, dst in self.fields.items():
            src = getattr(out, name)
            if src is not dst:
                dst.copy_(src)

    def _capture(self, body, p: int) -> None:
        """Capture the body as pass ``p`` of the current seed would run it;
        its draws' keys become slots, its film's address a slot.  A refused
        capture (:func:`refused`) leaves this structure to the eager
        body."""
        sink = trace.CaptureSink()
        rec = rng.KeyRecorder(rng.fold_in(rng.make_key(self.seed), p),
                              self.slots, self.max_depth)
        kept: list = []
        graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.current_stream(self.device)
        try:
            with trace.capturing(sink), rng.recording(rec), \
                    tmath.keeping(kept), \
                    splatting_at(self.film.transient, self.film_at), \
                    torch.cuda.graph(graph, capture_error_mode="thread_local"):
                out, n_rays = body(self.sd, self.cam, self.film, self.seed,
                                   p, self.scale)
                self._store(out)
        except (RuntimeError, rng.GraphRefusal) as e:
            torch.cuda.set_stream(stream)
            if not refused(e):
                raise
            self.refused = True
            count("refusals")
            logging.getLogger("mitransient_tpu_torch").warning(
                "multi-pass render: the pass could not be captured as a CUDA "
                "graph (%s); its passes run eagerly", e)
            return
        self.graph, self.sink, self.dims = graph, sink, rec.dims
        self.n_rays, self.kept = n_rays, kept
        count("captures")
        self._upload()

    def _upload(self) -> None:
        """The render's key table on the device, one upload."""
        keys = rng.pass_key_table(self.seed, self.passes, self.dims)
        host = torch.from_numpy(np.ascontiguousarray(keys).view(np.int32))
        self.table = host.pin_memory().to(self.device, non_blocking=True)


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
        g = _GRAPHS[dev] = PassGraph(structure, sd, cam, film,
                                     icfg.max_depth, dev)
    return g
