"""mitransient_tpu_torch - the transient renderer in PyTorch and CUDA.

The port of ``mitransient_tpu`` (JAX on a TPU) to PyTorch with kernels
written by hand for NVIDIA Hopper.  It keeps the JAX package's module
layout and function names; the JAX package is the reference it is tested
against.  This package imports torch and numpy, never jax.

Today it renders the transient path tracer (``transient_path`` and
``path``) through both of the JAX package's primal branches: the
path-regeneration loop and the multi-pass accumulator, with its threefry
sample streams, crop windows, ``camera_unwarp``, the gaussian temporal
and spatial filters and checkpoint/resume; and NLOS captures
(``transient_nlos_path``: single, confocal and exhaustive, with laser and
hidden-geometry sampling; ``nlos`` holds the laser-focus helpers and
``scan_confocal``); and the volumetric path tracer
(``transient_prbvolpath``: homogeneous and grid media inside null-bounded
shapes, with a Henyey-Greenstein phase function).  Scenes are
rectangles, cubes and triangle meshes
with every BSDF of the JAX package (diffuse, conductor and mirror,
anisotropic rough conductor, plastic and rough plastic, dielectric and
thin dielectric, null; the two-sided, mask and blend wrappers; bitmap
and checkerboard textures; bump and normal maps), area, angulararea,
projector and point emitters, seen through a perspective sensor or an
NLOS capture meter into a transient film or a phasor film; above 4096
triangles through a chunked acceleration structure.  ``transient_path``
renders under all six variants of the JAX package: ``mono``, ``rgb``,
their polarized forms (Mueller-matrix throughput, Stokes films of 4 C
channels; ``vis_polarized`` holds the polarization maps) and
``spectral`` / ``spectral_polarized`` (hero wavelengths, sRGB films), and
so do NLOS captures, volumetric renders and both differentiation modes,
each on the JAX package's route for every variant.  Scenes come from a
dict (:func:`load_dict`) or a Mitsuba XML file (:func:`load_file`).
:func:`render_aovs` gives first-hit AOVs.  It differentiates them:
:func:`render_backward` (the PRB two-sweep replay, surface or
volumetric, or full AD through the wavefront for NLOS captures and
``method="fullad"``) and :func:`render_forward` give gradients and
derivative videos with respect to the parameters that :func:`traverse`
names (reflectance, roughness, texels, emitter radiance and position,
media albedo and extinction, shape poses).  Scenes load onto the card unless the caller asks for
``device="cpu"``.
On a CUDA device the ray queries and the film splat run in the kernels of
``csrc/``; on the CPU they run their plain PyTorch versions.  ``vis`` and
``io_exr`` tonemap transient videos and write them as EXR frames; ``log``
is the leveled logger; ``trace`` holds the spans and counters that a
``torch.profiler`` session records.
"""
from . import nlos, trace, vis, vis_polarized  # noqa: F401
from .log import LogLevel, log, set_log_level  # noqa: F401
from .core.spectrum import (  # noqa: F401
    is_monochromatic,
    is_polarized,
    is_rgb,
    set_variant,
    variant,
)
from .render import (  # noqa: F401
    load_film_state,
    render,
    render_aovs,
    render_backward,
    render_forward,
    save_film_state,
)
from .scene.schema import ParamMap, Scene, load_dict, traverse  # noqa: F401
from .scene.xml_loader import load_file  # noqa: F401
from .utils import cornell_box, speed_of_light  # noqa: F401
from .version import __version__  # noqa: F401
