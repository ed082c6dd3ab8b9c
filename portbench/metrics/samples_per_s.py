"""Pixel samples completed a second over the window: H x W x spp a render,
scan points x spp a capture, counted from the cell's data."""
from harness.readers import samples_per_s as read  # noqa: F401
