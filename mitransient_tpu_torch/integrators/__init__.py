"""The integrators' wavefronts and the lane budget their renders share."""

# Lane budget: lanes = pixels * lanes per pixel (regen) or pixels * spp a
# pass (multi-pass, NLOS).  2^21 lanes * ~60 f32 of live state is about
# 0.5 GB.
DEFAULT_MAX_LANES = 1 << 21
