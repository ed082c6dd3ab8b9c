"""Seconds a step of the inverse-rendering loop: the window over the
steps it completed."""


def read(run):
    if not run.steps:
        return None
    return run.window_s / run.steps
