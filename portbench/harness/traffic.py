"""The one generator of the benchmark's traffic: a closed loop of one
client that makes its next call when the last has returned, each call with
the parameters of the traffic file and a seed of its own derived from the
run's seed, so that the same run seed gives the same calls."""
from __future__ import annotations

import numpy as np


def _word(seed: int) -> int:
    """Any whole number as the non-negative entropy ``SeedSequence`` takes."""
    return int(seed) % (1 << 64)


def call_seed(run_seed: int, index: int) -> int:
    """The 32-bit seed of call ``index`` of a run (index -1: the warm-up,
    other negative indices: set-up's own draws)."""
    ss = np.random.SeedSequence([_word(run_seed), index + (1 << 20)])
    return int(ss.generate_state(1)[0])


def rng(run_seed: int, stream: int) -> np.random.Generator:
    """A host generator of the run's other draws (the sampled pixels, the
    checked calls), one stream each."""
    return np.random.default_rng([_word(run_seed), stream])


class ClosedLoop:
    def __init__(self, spec: dict, run_seed: int):
        if spec.get("kind") != "closed_loop" or spec.get("clients", 1) != 1:
            raise ValueError("the generator makes closed loops of one client")
        self.spec = spec
        self.run_seed = run_seed

    def call(self, index: int) -> dict:
        params = {k: v for k, v in self.spec.items()
                  if k not in ("kind", "clients", "why")}
        params["seed"] = call_seed(self.run_seed, index)
        return params
