"""The integrators' wavefronts and the lane budget their renders share."""

# Lane budget: lanes = pixels * lanes per pixel (regen) or pixels * spp a
# pass (multi-pass, NLOS).  2^21 lanes * ~60 f32 of live state is about
# 0.5 GB.
DEFAULT_MAX_LANES = 1 << 21


def _split_spp(spp: int, hw: int, max_lanes: int):
    """The JAX package's pass split of ``spp`` samples over ``hw`` pixels
    into passes of at most ``max_lanes`` lanes -> (spp a pass, passes,
    total spp)."""
    spp_chunk = max(1, min(spp, max_lanes // max(hw, 1)))
    n_passes = (spp + spp_chunk - 1) // spp_chunk
    spp_chunk = (spp + n_passes - 1) // n_passes  # even-ish split
    return spp_chunk, n_passes, spp_chunk * n_passes
