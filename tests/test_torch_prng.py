"""The port's threefry bridge against ``jax.random``: keys, splits and
uniform draws bit for bit; categorical draws equal wherever no two noisy
logits tie within an ulp (the two frameworks' ``log`` may differ by one)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import prng

SEEDS = (0, 1, 42, 2**31 - 1, -7, 2**33 + 5)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split_bitexact(seed):
    k = jax.random.PRNGKey(seed)
    tk = prng.PRNGKey(seed)
    np.testing.assert_array_equal(prng.key_to_numpy(tk), np.asarray(k))
    for num in (2, 3, 8):
        np.testing.assert_array_equal(prng.key_to_numpy(prng.split(tk, num)),
                                      np.asarray(jax.random.split(k, num)))
    # the split chains the fit uses: root -> (itis, backend) -> per level
    a, b = jax.random.split(k)
    ta, tb = prng.split(tk)
    for _ in range(3):
        a, sub = jax.random.split(a)
        ta, tsub = prng.split(ta)
        np.testing.assert_array_equal(prng.key_to_numpy(tsub), np.asarray(sub))


@pytest.mark.parametrize("shape", [(1,), (7,), (1000,), (3, 5)])
def test_uniform_bitexact(shape):
    for seed in (0, 3, 99):
        k = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.uniform(k, shape))
        got = prng.uniform(prng.PRNGKey(seed), shape).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
        want = np.asarray(jax.random.uniform(k, shape, minval=-2.0, maxval=3.0))
        got = prng.uniform(prng.PRNGKey(seed), shape, minval=-2.0,
                           maxval=3.0).numpy()
        # XLA contracts the scale and shift into an fma: one ulp apart
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-7)


def test_random_bits_bitexact():
    k = jax.random.PRNGKey(5)
    want = np.asarray(jax.random.bits(k, (257,)))
    got = prng.random_bits(prng.PRNGKey(5), 257).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, want)


def test_key_from_numpy_roundtrip():
    k = np.asarray(jax.random.split(jax.random.PRNGKey(11))[1])
    tk = prng.key_from_numpy(k)
    assert tk.dtype == torch.int64 and tk.shape == (2,)
    np.testing.assert_array_equal(prng.key_to_numpy(tk), k)
    with pytest.raises(ValueError):
        prng.key_from_numpy(np.zeros(3, np.uint32))


def _gumbel_budget(g64):
    """The f32 error budget of -log(-log(u)) for an exact u: one ulp of the
    output plus 2**-23, the inner log's rounding carried through the outer
    log (d(-log L) = -dL / L, and dL / L is at most one ulp of 1)."""
    return np.spacing(np.abs(g64).astype(np.float32)).astype(np.float64) + 2.0 ** -23


def test_gumbel_within_ulps():
    """Each side against the float64 value of the same uniform bits, so a
    drift names its side. The uniform draws on the Gumbel range are the
    reference's bit for bit; the port's Gumbel and the reference's stay
    within the f32 budget of ``_gumbel_budget`` (both with room to spare
    in every run of this file, serial, under xdist, and beside the whole
    port suite)."""
    k = jax.random.PRNGKey(3)
    tiny = np.finfo(np.float32).tiny
    u = prng.uniform(prng.PRNGKey(3), 4096, minval=prng._TINY_F32,
                     maxval=1.0).numpy()
    ju = np.asarray(jax.random.uniform(k, (4096,), minval=tiny, maxval=1.0))
    np.testing.assert_array_equal(u.view(np.uint32), ju.view(np.uint32))
    g64 = -np.log(-np.log(u.astype(np.float64)))
    budget = _gumbel_budget(g64)
    got = prng.gumbel(prng.PRNGKey(3), 4096).numpy()
    want = np.asarray(jax.random.gumbel(k, (4096,)))
    for side, g in (("port", got), ("jax", want)):
        over = np.abs(g.astype(np.float64) - g64) > budget
        assert not over.any(), (
            f"{side}: {int(over.sum())} of 4096 Gumbel draws outside the f32 "
            f"budget of the float64 value (worst "
            f"{float(np.abs(g - g64).max()):.3g})")


@pytest.mark.parametrize("seed", range(8))
def test_categorical_matches_at_untied_logits(seed):
    rng = np.random.default_rng(seed)
    logits = np.log(np.maximum(rng.random(300) * (rng.random(300) > 0.2),
                               1e-30)).astype(np.float32)
    k = jax.random.PRNGKey(seed)
    want = int(jax.random.categorical(k, jnp.asarray(logits)))
    tk = prng.PRNGKey(seed)
    got = int(prng.categorical(tk, torch.from_numpy(logits)))
    noisy = prng.gumbel(tk, 300).numpy() + logits
    top2 = np.sort(noisy)[-2:]
    if top2[1] - top2[0] > 1e-5 * max(1.0, abs(top2[1])):
        assert got == want


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_bitexact(seed):
    """fold_in over many data values, and the chains the engine and the KV
    compression derive: fold_in(fold_in(key, i-1), i) and fold_in(key, 100 + j)."""
    k = jax.random.PRNGKey(seed)
    tk = prng.PRNGKey(seed)
    for data in (0, 1, 2, 99, 100, 101, 2**31 - 1, 2**32 - 1, 12345678):
        np.testing.assert_array_equal(prng.key_to_numpy(prng.fold_in(tk, data)),
                                      np.asarray(jax.random.fold_in(k, data)))
    a, ta = k, tk
    for i in range(20):
        a, ta = jax.random.fold_in(a, i), prng.fold_in(ta, i)
    np.testing.assert_array_equal(prng.key_to_numpy(ta), np.asarray(a))
    # a folded key feeds the draws as any other key does
    np.testing.assert_array_equal(
        prng.uniform(prng.fold_in(tk, 7), (64,)).numpy(),
        np.asarray(jax.random.uniform(jax.random.fold_in(k, 7), (64,))))
