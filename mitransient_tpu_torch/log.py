"""Leveled logging (a copy of ``mitransient_tpu/log.py``).

Mitsuba's ``mi.Log`` / ``mi.LogLevel`` as the reference uses them (the
invalid-sample warning of transient_image_block.py:106-125, the progress
logging of integrators/common.py), built on Python ``logging`` so that it
composes with host applications; the levels mirror Mitsuba's enum.

Usage::

    import mitransient_tpu_torch as mt
    mt.set_log_level(mt.LogLevel.Debug)
    mt.log(mt.LogLevel.Warn, "invalid sample value")

The film counts suspect samples on the device (``warn_negative`` /
``warn_invalid``) and the render functions report them once a render.
"""
from __future__ import annotations

import enum
import logging


class LogLevel(enum.IntEnum):
    """Mitsuba-compatible log levels (mi.LogLevel)."""

    Trace = 0
    Debug = 10
    Info = 20
    Warn = 30
    Error = 40


_LOGGER = logging.getLogger("mitransient_tpu_torch")
if not _LOGGER.handlers:  # host app may already configure logging
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("%(asctime)s %(levelname)s mitr: "
                                      "%(message)s"))
    _LOGGER.addHandler(_h)
    _LOGGER.setLevel(logging.INFO)
    _LOGGER.propagate = False


def set_log_level(level: LogLevel | int) -> None:
    """Set the minimum level that gets emitted (mi.set_log_level parity)."""
    _LOGGER.setLevel(int(level) if int(level) > 0 else 1)


def log_level() -> int:
    return _LOGGER.level


def log(level: LogLevel | int, msg: str, *args) -> None:
    """Emit a leveled message (mi.Log parity)."""
    lvl = int(level)
    if lvl >= LogLevel.Error:
        _LOGGER.error(msg, *args)
    elif lvl >= LogLevel.Warn:
        _LOGGER.warning(msg, *args)
    elif lvl >= LogLevel.Info:
        _LOGGER.info(msg, *args)
    else:
        _LOGGER.debug(msg, *args)


# Convenience aliases
def warn(msg: str, *args) -> None:
    log(LogLevel.Warn, msg, *args)


def info(msg: str, *args) -> None:
    log(LogLevel.Info, msg, *args)


def debug(msg: str, *args) -> None:
    log(LogLevel.Debug, msg, *args)
