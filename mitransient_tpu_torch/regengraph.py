"""A block of the regen loop as one CUDA graph, captured once and replayed.

The regen loop (``integrators/path_regen.py:sample_primal_regen``) checks
for live lanes every ``LIVE_CHECK_EVERY`` iterations, with one host sync;
the iterations between two checks are a block.  On the card the host
issues a block of 2^21 lanes as some 6,300 eager launches, more slowly
than the card runs them.  A render that takes this route (:func:`route`,
:func:`eligible`) instead captures the block once into a
``torch.cuda.CUDAGraph`` and replays it for every later block of every
render of the same structure: one graph launch and one live check a
block.  The graph replays the same kernels with the same arguments in the
same order, so its films are bit for bit the eager loop's.

* **What the graph reads.**  A graph keeps the addresses and arguments of
  its capture, so the blocks run on buffers that a :class:`RegenGraph`
  owns: copies of the scene's and camera's tensors, the stream keys
  (``path_regen.stream_keys``: the seed's hash on the device), the film's
  fields other than the transient, the per-lane constants and the loop's
  carried state (``path_regen.Carry``: about 21 floats, 4 int64 and 3
  bools a lane in RGB).  A render loads its scene, camera, keys, film
  fields and first samples into them once, by copies and fills on the
  device.  A block makes its state anew and copies it back into the
  owned buffers at its end: one set of copies a block, not a bounce.
  Between blocks the live check reads the owned ``lane_live``.
* **The film.**  K3 splats into each render's own transient film, as the
  eager loop does: the graph's K3 launches read the film's address from a
  device slot (``film/transient_film.py:splatting_at``) that the render
  sets.  So a caller may keep a render's output.
* **When it captures.**  A render that finds no graph of its structure
  runs its first block eagerly on the owned buffers (which also loads
  every kernel the block launches), then captures the block.  The
  structure is what the block was built from: the shapes, strides, dtypes
  and devices of the scene's, the camera's and the film's tensors and the
  host facts beside them (``bsdf_kinds``, ``emitter_kinds``, an accel or
  none), the integrator and film settings, ``polarized``, the spp budget,
  the lanes a pixel, ``bvh_mode`` and the block's length.  A last stretch
  shorter than a block runs eagerly on the same buffers.
* **One graph a device.**  The graph lives in the multi-pass pass graph's
  slot (``passgraph._GRAPHS``), under a structure of its own, so that a
  render of either route frees the other route's graph and buffers
  (``passgraph.route`` replaces a graph of another structure): a set-up
  that renders a target with the regen loop and then renders multi-pass
  holds one route's memory, not both.  A capture that a captured operation
  refuses (``passgraph.refused``) leaves the structure to eager blocks on
  the owned buffers, counted as ``graph.refusals``; any other error is
  raised.
* **Tracing.**  As in ``passgraph.py``: the capture runs inside
  ``trace.capturing``, each replay is one ``mitr:graph`` span followed by
  ``trace.replay_counts``, and ``mitr:bounce`` and ``mitr:rng`` are not
  entered in a replayed block.  ``graph.captures``, ``graph.replays`` and
  ``graph.refusals`` count as for the pass graph, ``graph.eager_blocks``
  each block run eagerly, by this route or by the plain loop
  (``passgraph.STATS`` counts them always).
"""
from __future__ import annotations

import logging

import torch

from . import passgraph, trace
from .core import math as tmath
from .film.transient_film import splatting_at
from .integrators import path_regen


def eligible(device, film_cfg) -> bool:
    """Whether a regen render takes the graph route: on a CUDA device, into
    a transient film (mono or RGB, polarized or not; the regen loop has no
    spectral branch).  The phasor film uploads its frequencies at each
    splat and runs the plain loop, as does every render on the CPU."""
    return (torch.device(device).type == "cuda"
            and film_cfg.kind == "transient_hdr_film")


class RegenGraph:
    """The buffers of one structure's regen loop on one device, and the
    graph of one block captured on them (None until captured)."""

    def __init__(self, structure, sd, cam, film, device, *, film_cfg, icfg,
                 spp_total, lanes_per_pixel, bvh_mode, polarized):
        tree_leaves, tree_map = passgraph._trees()
        self.structure = structure
        self.device = device
        self.block = path_regen.LIVE_CHECK_EVERY
        sd = tree_map(torch.empty_like, sd)
        cam = tree_map(torch.empty_like, cam)
        keys = torch.zeros((3,), dtype=torch.int64, device=device)
        self.lp = path_regen.regen_loop(
            sd, cam, keys, film_cfg, icfg, spp_total, lanes_per_pixel,
            bvh_mode, polarized)
        self.inputs = tree_leaves((sd, cam))
        # the film's fields a block may make anew; not the transient
        self.fields = {f: torch.empty_like(getattr(film, f))
                       for f in film._fields if f != "transient"}
        self.film_at = torch.zeros((1,), dtype=torch.int64, device=device)
        self.carry = None  # the loop's state, allocated by the first begin
        self.graph = None
        self.refused = False  # a capture was refused: this structure is eager
        self.film = self.sink = None
        self.kept = []  # the scalars the graph reads (core/math.py:divide)

    def begin(self, sd, cam, film, seed: int):
        """Load a render's inputs: its scene, camera, seed and film, whose
        transient its blocks splat into, and its first samples.  -> (the
        owned carry, the film the blocks accumulate into)."""
        tree_leaves, tree_map = passgraph._trees()
        for dst, src in zip(self.inputs, tree_leaves((sd, cam))):
            dst.copy_(src)
        self.lp.keys.copy_(path_regen.stream_keys(seed, self.device))
        for name, dst in self.fields.items():
            dst.copy_(getattr(film, name))
        self.film_at.fill_(film.transient.data_ptr())
        self.film = film._replace(**self.fields)
        first = path_regen.initial_carry(self.lp)
        if self.carry is None:
            self.carry = tree_map(torch.empty_like, first)
        for dst, src in zip(tree_leaves(self.carry), tree_leaves(first)):
            dst.copy_(src)
        return self.carry, self.film

    def run(self, k: int, more: bool):
        """``k`` iterations: a replay, or eager ones on these buffers
        followed, where the block is whole and ``more`` may follow, by the
        capture.  -> (the owned carry, the film)."""
        if k == self.block and self.graph is not None:
            with trace.span("mitr:graph"):
                self.graph.replay()
            trace.replay_counts(self.sink)
            passgraph.count("replays")
            return self.carry, self.film
        self._store(*path_regen.regen_block(self.lp, self.carry, self.film,
                                            k))
        passgraph.count("eager_blocks")
        if (k == self.block and more and not self.refused
                and self.device.type == "cuda"):
            self._capture()
        return self.carry, self.film

    def end(self):
        """-> (carry, film) of the render: copies of what it returns, which
        the next render's ``begin`` overwrites here, and its own
        transient."""
        c = self.carry
        film = self.film._replace(**{name: t.clone()
                                     for name, t in self.fields.items()})
        self.film = None  # the caller's to keep or free
        return c._replace(steady=c.steady.clone(), n_rays=c.n_rays.clone(),
                          iters=c.iters.clone()), film

    def _store(self, carry, film) -> None:
        """Copy the state a block made anew into this graph's (K3 splats
        the transient in place)."""
        if film.transient.data_ptr() != self.film.transient.data_ptr():
            raise passgraph.GraphRefusal("the block made a new transient "
                                         "film")
        tree_leaves, _ = passgraph._trees()
        for dst, src in zip(tree_leaves(self.carry), tree_leaves(carry)):
            if src is not dst:
                dst.copy_(src)
        for name, dst in self.fields.items():
            src = getattr(film, name)
            if src is not dst:
                dst.copy_(src)

    def _capture(self) -> None:
        """Capture one block on these buffers; the film's address becomes
        a slot.  A refused capture (``passgraph.refused``) leaves this
        structure to eager blocks."""
        sink = trace.CaptureSink()
        kept: list = []
        graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.current_stream(self.device)
        try:
            with trace.capturing(sink), tmath.keeping(kept), \
                    splatting_at(self.film.transient, self.film_at), \
                    torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self._store(*path_regen.regen_block(
                    self.lp, self.carry, self.film, self.block))
        except (RuntimeError, passgraph.GraphRefusal) as e:
            torch.cuda.set_stream(stream)
            if not passgraph.refused(e):
                raise
            self.refused = True
            passgraph.count("refusals")
            logging.getLogger("mitransient_tpu_torch").warning(
                "regen render: a block of the loop could not be captured as "
                "a CUDA graph (%s); its blocks run eagerly", e)
            return
        self.graph, self.sink, self.kept = graph, sink, kept
        passgraph.count("captures")


def route(sd, cam, film, *, film_cfg, icfg, spp_total, lanes_per_pixel,
          bvh_mode, polarized) -> RegenGraph | None:
    """The regen graph of this render into ``film``, or None where the
    render runs the plain loop (:func:`eligible`).  A graph of another
    structure, of either route, is replaced."""
    dev = cam.origin.device
    if not eligible(dev, film_cfg):
        return None
    _, tree_map = passgraph._trees()
    structure = ("regen", tree_map(passgraph._describe, (sd, cam, film)),
                 film_cfg, icfg, polarized, spp_total, lanes_per_pixel,
                 bvh_mode, path_regen.LIVE_CHECK_EVERY)
    g = passgraph._GRAPHS.get(dev)
    if g is None or g.structure != structure:
        passgraph._GRAPHS.pop(dev, None)
        g = passgraph._GRAPHS[dev] = RegenGraph(
            structure, sd, cam, film, dev, film_cfg=film_cfg, icfg=icfg,
            spp_total=spp_total, lanes_per_pixel=lanes_per_pixel,
            bvh_mode=bvh_mode, polarized=polarized)
    return g
