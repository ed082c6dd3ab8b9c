"""Version info (a copy of ``mitransient_tpu/version.py``)."""

__version__ = "0.1.0"

# Capability target: feature parity with mitransient 1.3.0
TARGET_REFERENCE_VERSION = "1.3.0"
