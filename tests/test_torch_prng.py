"""The port's threefry bridge against ``jax.random``: keys, splits and
uniform draws bit for bit; normal, exponential, Gumbel, Pareto and
Bernoulli draws bit for bit (XLA's ``log``, ``log1p``, ``erf_inv`` and
``exp``, ``repro_torch.xla_math``, held bitwise against ``jnp``'s on 2^21
inputs and their edges), and each within its ulp budget of the float64
value of the same uniform bits; categorical draws equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special as scipy_special
import torch

from repro_torch import prng, xla_math

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


def test_gumbel_within_ulps():
    """The uniform draws on the Gumbel range are the reference's bit for
    bit, and so are the Gumbel draws on them (both sides take XLA's
    ``log``)."""
    k = jax.random.PRNGKey(3)
    tiny = np.finfo(np.float32).tiny
    u = prng.uniform(prng.PRNGKey(3), 4096, minval=prng._TINY_F32,
                     maxval=1.0).numpy()
    ju = np.asarray(jax.random.uniform(k, (4096,), minval=tiny, maxval=1.0))
    np.testing.assert_array_equal(u.view(np.uint32), ju.view(np.uint32))
    got = prng.gumbel(prng.PRNGKey(3), 4096).numpy()
    want = np.asarray(jax.random.gumbel(k, (4096,)))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("seed", range(8))
def test_categorical_matches_at_untied_logits(seed):
    """The same noise bits, so the same draw at every seed."""
    rng = np.random.default_rng(seed)
    logits = np.log(np.maximum(rng.random(300) * (rng.random(300) > 0.2),
                               1e-30)).astype(np.float32)
    k = jax.random.PRNGKey(seed)
    want = int(jax.random.categorical(k, jnp.asarray(logits)))
    tk = prng.PRNGKey(seed)
    got = int(prng.categorical(tk, torch.from_numpy(logits)))
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


def _ulps_of(x64):
    return np.spacing(np.abs(x64).astype(np.float32)).astype(np.float64)


#: the draws of jax's formulas on the same uniform bits: (port's draw,
#: jax's draw, float64 truth from the f32 uniform bits, budget in output
#: ulps). XLA:CPU's erf_inv is a polynomial whose error reaches about 85
#: ulps in the tails (|u| near 1), and the port follows it bit for bit;
#: Pareto carries exp's conditioning (e / b up to ~12: an ulp of e is ~12
#: of the output)
def _draws(seed, n=20_000):
    k, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    u_n = prng.uniform(tk, n, minval=lo, maxval=1.0).numpy()
    u = prng.uniform(tk, n).numpy()
    e64 = -np.log1p(-u.astype(np.float64))
    b = np.float64(np.float32(1.3))
    return {
        "normal": (prng.normal(tk, n).numpy(), np.asarray(jax.random.normal(k, (n,))),
                   np.sqrt(2) * scipy_special.erfinv(u_n.astype(np.float64)), 128),
        "exponential": (prng.exponential(tk, n).numpy(),
                        np.asarray(jax.random.exponential(k, (n,))), e64, 2),
        "pareto": (prng.pareto(tk, 1.3, n).numpy(),
                   np.asarray(jax.random.pareto(k, 1.3, (n,))), np.exp(e64 / b), 16),
    }


@pytest.mark.parametrize("seed", [0, 5, 2**31 - 1])
def test_normal_exponential_pareto_within_ulps(seed):
    """The uniform bits under each draw are the reference's bit for bit,
    the port's draws are the reference's bit for bit, and they stay within
    the budget of the float64 value of those bits."""
    k, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    np.testing.assert_array_equal(
        prng.uniform(tk, 20_000, minval=lo, maxval=1.0).numpy().view(np.uint32),
        np.asarray(jax.random.uniform(k, (20_000,), minval=lo,
                                      maxval=1.0)).view(np.uint32))
    for name, (got, want, x64, budget) in _draws(seed).items():
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32),
                                      err_msg=name)
        err = np.abs(got.astype(np.float64) - x64) / _ulps_of(x64)
        assert err.max() <= budget, f"{name}: {err.max():.1f} ulps"


@pytest.mark.parametrize("seed", [0, 5, 2**31 - 1])
def test_bernoulli_bitexact(seed):
    for p in (0.1, 0.5, 0.9):
        want = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(seed), p, (4, 999)))
        got = prng.bernoulli(prng.PRNGKey(seed), p, (4, 999)).numpy()
        np.testing.assert_array_equal(got, want)


DRAW_N = 2**20


@pytest.mark.parametrize("seed", [0, 5, 2**31 - 1])
@pytest.mark.parametrize("name", ["normal", "exponential", "gumbel", "pareto"])
def test_draws_are_jax_random_s_bit_for_bit(name, seed):
    k, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    got, want = {
        "normal": lambda: (prng.normal(tk, DRAW_N), jax.random.normal(k, (DRAW_N,))),
        "exponential": lambda: (prng.exponential(tk, DRAW_N),
                                jax.random.exponential(k, (DRAW_N,))),
        "gumbel": lambda: (prng.gumbel(tk, DRAW_N), jax.random.gumbel(k, (DRAW_N,))),
        "pareto": lambda: (prng.pareto(tk, 1.3, DRAW_N),
                           jax.random.pareto(k, 1.3, (DRAW_N,))),
    }[name]()
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want).view(np.uint32))


#: the edges: zeros, denormals (XLA:CPU flushes them to zero), the smallest
#: normal, 1, ±(1 - 2^-24), both sides of √2 - 1 (log1p's branch) and of
#: 0.70710677 (log's mantissa fold), exp's clamps, infinities and NaN
EDGES = np.array(
    [0.0, -0.0, 1e-45, -1e-45, 1e-39, -1e-39, 1.1754944e-38, -1.1754944e-38,
     1e-30, 1e-20, 1e-10, 1.0, -1.0, 1 - 2**-24, -(1 - 2**-24), 1 + 2**-23,
     0.41421354, 0.41421357, 0.4142136, -0.41421354, -0.41421357, -0.4142136,
     0.70710677, 0.7071067, 0.7071068, 1.4142135, 1.4142137, 2.0, 0.5,
     88.8, 88.9, -87.8, -87.9, 100.0, -100.0, 3.4e38, -3.4e38,
     np.inf, -np.inf, np.nan], dtype=np.float32)


def _inputs(name):
    """2^21 inputs in each function's domain and beyond, then the edges."""
    rng = np.random.default_rng(11)
    u = rng.random(2**20, dtype=np.float32)
    anybits = rng.integers(0, 2**32, size=2**20, dtype=np.uint64).astype(np.uint32)
    wide = anybits.view(np.float32)
    x = {"log": [u, np.abs(wide)], "log1p": [-u, wide],
         "erf_inv": [(u * 2 - 1).astype(np.float32),
                     np.clip(wide, -1, 1).astype(np.float32)],
         "exp": [(u * 200 - 100).astype(np.float32), wide]}[name]
    return np.concatenate(x + [EDGES])


@pytest.mark.parametrize("name,jf", [("log", jnp.log), ("log1p", jnp.log1p),
                                     ("erf_inv", jax.lax.erf_inv), ("exp", jnp.exp)])
def test_xla_math_is_jnp_s_bit_for_bit(name, jf):
    """Each function against XLA's own on the CPU: the same bits, NaN where
    XLA gives NaN (its NaN payloads are not part of the contract)."""
    x = _inputs(name)
    got = getattr(xla_math, name)(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jf)(x))
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    bad = got.view(np.uint32)[~nan] != want.view(np.uint32)[~nan]
    assert not bad.any(), (f"{int(bad.sum())} of {x.size} differ, first at "
                           f"{x[~nan][bad][:4]}")
