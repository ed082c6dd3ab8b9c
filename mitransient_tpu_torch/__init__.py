"""mitransient_tpu_torch - the transient renderer in PyTorch and CUDA.

The port of ``mitransient_tpu`` (JAX on a TPU) to PyTorch with kernels
written by hand for NVIDIA Hopper.  It keeps the JAX package's module
layout and function names; the JAX package is the reference it is tested
against.  This package imports torch and numpy, never jax.

Today it renders the transient path tracer's regen path: scenes of
rectangles and cubes with diffuse BSDFs and area emitters, seen through a
perspective sensor into a transient film.  On a CUDA device the ray
queries and the film splat run in the kernels of ``csrc/``; on the CPU
they run their plain PyTorch versions.
"""
from .core.spectrum import set_variant, variant  # noqa: F401
from .render import render  # noqa: F401
from .scene.schema import Scene, load_dict  # noqa: F401
from .utils import cornell_box, speed_of_light  # noqa: F401
