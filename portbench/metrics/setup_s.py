"""Seconds from the start of the process to the first timed call:
imports, scene build, kernel load or build, the warm-up."""


def read(run):
    return run.setup_s
