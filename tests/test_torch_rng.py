"""The port's random streams are bit-equal to the JAX package's: the
stateless PCG hash of the regen loop (integrators/path_regen.py:45-57) and
the threefry streams of core/rng.py (``Sampler``, ``draw_bounce_block``,
drawn by ``jax.random`` with ``jax_threefry_partitionable`` on).  Past
2^32 counters, where no test can afford a JAX draw, the plain path is held
to ``threefry2x32`` on Python ints, as the card's kernel is
(tests/test_torch_cuda.py).
Tolerance: none, integers and the float32 conversion must be identical."""
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mitransient_tpu.core import rng as jrng
from mitransient_tpu.integrators import path_regen as jreg
from mitransient_tpu_torch.core import rng as trng
from mitransient_tpu_torch import trace
from mitransient_tpu_torch.integrators import path_regen as treg
from mitransient_tpu_torch.kernels import _build

torch.set_num_threads(1)


def _key(words) -> torch.Tensor:
    """The host key words ``(k0, k1)`` as a stream key (``rng.uniform``'s
    ``(2,)`` int32 tensor on the CPU)."""
    return torch.from_numpy(np.array(words, np.uint32).view(np.int32))


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


SEEDS = [0, 5, 2**32 - 1]
LANES = (1, 3, 1000, 4099)  # lane counts that are not powers of two (but 1)


def _same_bits(got: torch.Tensor, want):
    want = np.asarray(want)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


def test_threefry_known_answer():
    """Threefry-2x32, 20 rounds, against the Random123 known-answer
    vectors; Python ints and int64 tensors give the same words."""
    m = 0xFFFFFFFF
    for key, ctr, want in (((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
                           ((m, m), (m, m), (0x1CB996FC, 0xBB002BE7)),
                           ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
                            (0xC4923A9C, 0x483DF7A0))):
        assert trng.threefry2x32(*key, *ctr) == want
        a, b = trng.threefry2x32(*key, torch.tensor([ctr[0]]),
                                 torch.tensor([ctr[1]]))
        assert (int(a[0]), int(b[0])) == want


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("stream", range(4))
def test_sampler_bit_equal(seed, stream):
    """Keys, eval_1d / eval_2d at dims 0-7 and the next_* counter."""
    for n in LANES:
        js = jrng.Sampler(jnp.uint32(seed), n, stream=jnp.uint32(stream))
        ts = trng.Sampler(seed, n, stream)
        assert ts.key.dtype == torch.int32 and ts.key.shape == (2,)
        np.testing.assert_array_equal(ts.key.numpy().view(np.uint32),
                                      np.asarray(jax.random.key_data(js.key)))
        for dim in range(8):
            _same_bits(ts.eval_1d(dim), js.eval_1d(dim))
        for dim in range(7):
            _same_bits(ts.eval_2d(dim), js.eval_2d(dim))
        for step in ("2d", "1d", "2d", "1d", "1d"):
            if step == "2d":
                _same_bits(ts.next_2d(), js.next_2d())
            else:
                _same_bits(ts.next_1d(), js.next_1d())
        assert ts.dim == js.dim == 7


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("it", range(8))
def test_draw_bounce_block_bit_equal(seed, it):
    """The bounce block of bounce ``it`` at the integrator's 6 dims and at
    1-8 dims, keyed by a pass's sampler."""
    js = jrng.Sampler(jnp.uint32(seed), 1, stream=jnp.uint32(it % 4))
    ts = trng.Sampler(seed, 1, it % 4)
    for n, dims in ((1000, 6), (4099, 6), (3, 8), (777, 1)):
        _same_bits(trng.draw_bounce_block(ts.key, it, n, dims),
                   jrng.draw_bounce_block(js.key, it, n, dims))


def test_uniform_is_in_the_unit_interval():
    u = trng.uniform(_key(trng.make_key(3)), 1, (1 << 16,))
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.01


def _python_uniform(key, counters):
    """``uniform``'s numbers at the flat counters, on Python ints."""
    out = []
    for i in counters:
        a, b = trng.threefry2x32(key[0], key[1], i >> 32, i & 0xFFFFFFFF)
        bits = ((a ^ b) >> 9) | 0x3F800000
        out.append(struct.unpack("<f", struct.pack("<I", bits))[0] - 1.0)
    return np.asarray(out, dtype=np.float32)


@pytest.mark.parametrize("seed", SEEDS)
def test_plain_path_past_2_32_counters(seed):
    """A ``rows=`` slice of a (2^31, 4) draw whose counters cross 2^32:
    the high word of the counter turns from 0 to 1 at row 2^30."""
    r0, r1 = 2**30 - 2, 2**30 + 510
    got = trng.uniform(_key(trng.make_key(seed)), 11, (2**31, 4),
                       rows=(r0, r1))
    assert got.shape == (r1 - r0, 4)
    want = _python_uniform(trng.fold_in(trng.make_key(seed), 11),
                           range(4 * r0, 4 * r1))
    np.testing.assert_array_equal(got.reshape(-1).numpy().view(np.uint32),
                                  want.view(np.uint32))


def test_cpu_draw_never_loads_the_kernel_library(monkeypatch):
    def refuse():
        raise AssertionError("a CPU draw asked for the CUDA kernels")

    monkeypatch.setattr(_build, "library", refuse)
    key = trng.Sampler(3, 1, 2).key
    assert trng.draw_bounce_block(key, 1, 4099, 6).shape == (4099, 6)
    assert trng.uniform(key, 0, (9, 2), rows=(3, 3)).shape == (0, 2)
    assert trng.uniform(key, 0, ()).shape == ()


def test_draws_are_counted_and_none_launches_on_the_cpu():
    with trace.span("mitr:render"):  # a session of its own
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        s = trng.Sampler(0, 64, 1)
        s.next_2d()
        s.next_1d()
        trng.draw_bounce_block(s.key, 0, 64, 6)
    summary = trace.summary()
    assert summary["counters"]["rng.draws"] == 4
    assert summary["spans"]["mitr:rng"]["count"] == 4
    assert "rng.draws_kernel" not in summary["counters"]
