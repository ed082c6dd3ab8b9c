"""The port's stateless PCG hash is bit-equal to the JAX package's
(integrators/path_regen.py:45-57).  Tolerance: none, integers and the
float32 conversion must be identical."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitransient_tpu.integrators import path_regen as jreg
from mitransient_tpu_torch.integrators import path_regen as treg

torch.set_num_threads(1)


def _triples(n=100_000, seed=0):
    rng = np.random.default_rng(seed)
    u32 = np.iinfo(np.uint32).max
    seeds = rng.integers(0, u32, n, dtype=np.uint64, endpoint=True)
    samples = rng.integers(0, u32, n, dtype=np.uint64, endpoint=True)
    dims = rng.integers(0, 300, n, dtype=np.uint64)
    # the edges of the 32-bit range
    seeds[:4] = [0, 1, u32 - 1, u32]
    samples[:4] = [u32, 0, u32 - 1, 1 << 31]
    return seeds, samples, dims


def test_pcg_bit_exact():
    x = np.concatenate(_triples()[:2])
    want = np.asarray(jreg._pcg(jnp.asarray(x.astype(np.uint32))))
    got = treg._pcg(torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    assert int(got.max()) <= 0xFFFFFFFF and int(got.min()) >= 0


def test_pcg_python_int_matches_tensor():
    for v in (0, 1, 123456789, 0xFFFFFFFF):
        assert treg._pcg(v) == int(treg._pcg(torch.tensor([v]))[0])


def test_hash_uniform_bit_exact():
    seeds, samples, dims = _triples()
    want = np.asarray(jreg.hash_uniform(
        jnp.asarray(seeds.astype(np.uint32)),
        jnp.asarray(samples.astype(np.uint32)),
        jnp.asarray(dims.astype(np.uint32))))
    got = treg.hash_uniform(*(torch.from_numpy(a.astype(np.int64))
                              for a in (seeds, samples, dims)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    assert 0.0 <= float(got.min()) and float(got.max()) <= 1.0


@pytest.mark.parametrize("seed", [0, 5, 2**32 - 1])
def test_hash_uniform_scalar_seed_and_dim(seed):
    """The integrator passes the seed and the jitter dims as Python ints."""
    sid = np.arange(0, 4096, dtype=np.int64) * 977
    for dim in (0, 1, 2 + 8 * 7 + 5):
        want = np.asarray(jreg.hash_uniform(
            jnp.uint32(seed), jnp.asarray(sid.astype(np.uint32)),
            jnp.uint32(dim)))
        got = treg.hash_uniform(seed, torch.from_numpy(sid), dim)
        np.testing.assert_array_equal(got.numpy(), want)
