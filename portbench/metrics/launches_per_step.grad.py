"""Device kernels launched in the traced window per step completed."""


def read(run):
    if run.trace is None or not run.steps:
        return None
    return run.trace.n_kernels / run.steps
