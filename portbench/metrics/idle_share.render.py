"""Device idle share of a render cell's traced window."""
from harness.readers import idle_share as read  # noqa: F401
