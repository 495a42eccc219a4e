"""The port's IHTC KV-cache compression and serving engine on the CPU
against the JAX package's.

Compression is held bit for bit on dyadic-grid keys and values (every
distance and first-level sum is exact in f32) with ``n_blocks=1`` (one
row-order fold on both sides; ROADMAP.md, Queue 3, says why the jitted
8-block fold is not bit-stable in the reference): prototypes, mass and
``pos`` equal. The bias ``log(max(mass, 1e-9))`` is held to one f32 ulp:
XLA:CPU's ``log`` is not correctly rounded (``log(7)`` comes out one ulp
above PyTorch's, which is). Against the reference's Pallas route, the
segment sum is a one-hot matrix product whose fold order differs, so only
the first compression (whose sums are exact) is bitwise there.

The engine is held to the reference's on the gemma2 smoke config: the
same number of compressions and token shape, and, with the reference's
tokens forced on both engines, every step's logits within the bound of
``tests/test_torch_lm.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jruntime
from repro.configs import ARCHS as J_ARCHS
from repro.configs import smoke_config as j_smoke_config
from repro.kernels import ops as jops
from repro.models import build as j_build
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve.kv_compression import compress_cache as j_compress_cache
from repro.serve.kv_compression import compress_model_caches as j_compress_model_caches
from repro_torch import prng
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.kernels import knn_topk, ops, ref
from repro_torch.models import build
from repro_torch.models.convert import params_from_tree
from repro_torch.runtime import configure
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.serve.kv_compression import (
    compress_cache,
    compress_model_caches,
    find_attention_caches,
    layer_keys,
)
from test_torch_lm import ROUTE_ULPS, assert_logits_close

torch.set_num_threads(1)


def dyadic(rng, shape, lim=8):
    return (rng.integers(-lim, lim + 1, size=shape) * 0.25).astype(np.float32)


def _jcache(k, v, pos, dt):
    return {"k": jnp.asarray(k, dt), "v": jnp.asarray(v, dt),
            "pos": jnp.asarray(pos, jnp.int32)}


def _tcache(k, v, pos, dt):
    return {"k": torch.from_numpy(k).to(dt), "v": torch.from_numpy(v).to(dt),
            "pos": pos}


def assert_same_cache(got: dict, want: dict, what=""):
    assert got["pos"] == int(want["pos"]), what
    for name in ("k", "v", "mass"):
        np.testing.assert_array_equal(got[name].float().numpy(),
                                      np.asarray(want[name].astype(jnp.float32)),
                                      err_msg=f"{what} {name}")
    # one f32 ulp: XLA:CPU's log is not correctly rounded
    want_b = np.asarray(want["bias"])
    np.testing.assert_allclose(got["bias"].numpy(), want_b, rtol=2.4e-7, atol=0,
                               err_msg=f"{what} bias")
    assert ((got["bias"].numpy() <= -1e29) == (want_b <= -1e29)).all(), what


DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("t,m", [(2, 1), (2, 2), (3, 1)])
def test_compress_cache_matches_reference(rng, jdt, tdt, t, m):
    """Compress, then recompress the compressed cache (masses > 1)."""
    b, h, S, hd, pos = 2, 2, 40, 16, 33
    k, v = dyadic(rng, (b, h, S, hd)), dyadic(rng, (b, h, S, hd))
    with jruntime.configure(n_blocks=1):
        j1 = j_compress_cache(_jcache(k, v, pos, jdt), t, m, tail=4, impl="ref")
        j2 = j_compress_cache(j1, t, 1, tail=4, impl="ref")
    with configure(n_blocks=1):
        t1 = compress_cache(_tcache(k, v, pos, tdt), t, m, tail=4, impl="ref")
        t2 = compress_cache(t1, t, 1, tail=4, impl="ref")
    assert t1["k"].shape == (b, h, S // t ** m + 4, hd) and t1["k"].dtype == tdt
    assert_same_cache(t1, j1, "first")
    assert_same_cache(t2, j2, "recompressed")


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_compress_cache_matches_pallas_route(rng, jdt, tdt):
    """The reference's Pallas route (K2 and K3 in interpret mode) against
    the port's "auto" route (their plain versions on the CPU)."""
    k, v = dyadic(rng, (1, 2, 36, 16)), dyadic(rng, (1, 2, 36, 16))
    with jruntime.configure(n_blocks=1):
        want = j_compress_cache(_jcache(k, v, 30, jdt), 2, 1, tail=4,
                                impl="pallas")
    with configure(n_blocks=1):
        got = compress_cache(_tcache(k, v, 30, tdt), 2, 1, tail=4, impl="auto")
    assert_same_cache(got, want, "pallas")


def test_compress_model_caches_derives_the_reference_keys(rng):
    """A stand-alone layer and a stacked group of period 2, repeated twice:
    the reference's {"prefix", "stack"} layout against the port's layer
    list, every layer's cache bitwise (so every layer drew its key)."""
    b, h, S, hd, pos = 1, 2, 24, 8, 20
    n_layers = 5  # layer 0 stand-alone; layers 1..4 = 2 repeats of (j=0, j=1)
    kv = [(dyadic(rng, (b, h, S, hd)), dyadic(rng, (b, h, S, hd)))
          for _ in range(n_layers)]
    stack = []
    for j in range(2):
        layers = [kv[1 + r * 2 + j] for r in range(2)]
        stack.append({"k": jnp.asarray(np.stack([a for a, _ in layers])),
                      "v": jnp.asarray(np.stack([c for _, c in layers])),
                      "pos": jnp.full((2,), pos, jnp.int32)})
    jcaches = {"prefix": [_jcache(*kv[0], pos, jnp.float32)], "stack": stack}
    tcaches = {"layers": [_tcache(a, c, pos, torch.float32) for a, c in kv],
               "n_prefix": 1, "period": 2}
    with jruntime.configure(n_blocks=1):
        want = j_compress_model_caches(jcaches, 2, 1, tail=4, impl="ref")
    with configure(n_blocks=1):
        got = compress_model_caches(tcaches, 2, 1, tail=4, impl="ref")
    assert_same_cache(got["layers"][0], want["prefix"][0], "layer 0")
    for r in range(2):
        for j in range(2):
            sub = {n: a[r] for n, a in want["stack"][j].items()}
            assert_same_cache(got["layers"][1 + 2 * r + j], sub, f"r{r} j{j}")
    assert len(list(find_attention_caches(got))) == n_layers
    key = prng.PRNGKey(0)
    wants = [jax.random.fold_in(jax.random.PRNGKey(0), i) for i in (0, 100, 101,
                                                                    100, 101)]
    for lk, wk in zip(layer_keys(tcaches, key), wants, strict=True):
        np.testing.assert_array_equal(prng.key_to_numpy(lk), np.asarray(wk))


def test_duplicate_keys_exactness(rng):
    """Duplicated KV entries compress losslessly: attention over the
    prototypes with the log-mass bias equals attention over the raw cache
    (the port's copy of tests/test_kv_compression.py's property)."""
    hd, n_unique, dup = 8, 16, 2
    k_full = np.repeat(rng.normal(size=(n_unique, hd)).astype(np.float32), dup, 0)
    v_full = np.repeat(rng.normal(size=(n_unique, hd)).astype(np.float32), dup, 0)
    q = torch.from_numpy(rng.normal(size=(1, 1, 1, hd)).astype(np.float32))
    cache = _tcache(k_full[None, None], v_full[None, None], n_unique * dup,
                    torch.float32)
    comp = compress_cache(cache, t=2, m=1, tail=4, impl="ref")
    assert comp["k"].shape[2] == n_unique + 4
    out_full = ref.flash_attention(q, cache["k"], cache["v"], causal=False)
    total = comp["k"].shape[2]
    tail_mask = torch.where(torch.arange(total) < comp["pos"], 0.0, -1e30)
    out_comp = ref.flash_attention(q, comp["k"], comp["v"], causal=False,
                                   kv_bias=comp["bias"] + tail_mask)
    np.testing.assert_allclose(out_comp.numpy(), out_full.numpy(), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("n,d,k", [(40, 256, 1), (33, 512, 2), (65, 130, 1)])
def test_knn_at_head_widths_matches_reference(rng, n, d, k):
    """K2 at the compression's widths (head_dim 256, the [k‖v] width 512):
    the plain version against the Pallas kernel in interpret mode and the
    reference oracle, bitwise on a dyadic grid (ties included)."""
    x = dyadic(rng, (n, d))
    valid = rng.random(n) > 0.2
    for v in (None, valid):
        jv = None if v is None else jnp.asarray(v)
        tv = None if v is None else torch.from_numpy(v)
        want = jops.knn(jnp.asarray(x), k, valid=jv, impl="pallas")
        got = knn_topk.knn_topk(torch.from_numpy(x), k, tv)
        fused = ops.knn(torch.from_numpy(x), k, valid=tv, impl="fused")
        for g in (got, fused):
            np.testing.assert_array_equal(g[0].numpy(), np.asarray(want[0]))
            np.testing.assert_array_equal(g[1].numpy(), np.asarray(want[1]))


def _engines(jimpl, timpl, **kw):
    jcfg, cfg = j_smoke_config(J_ARCHS["gemma2-2b"]), smoke_config(ARCHS["gemma2-2b"])
    jb = j_build(jcfg)
    params = jb.init(jax.random.PRNGKey(0))
    model = params_from_tree(cfg, jax.tree_util.tree_map(np.array, params),
                             device="cpu")
    common = dict(max_new_tokens=12, compress=True, compress_t=2,
                  compress_m=1, compress_tail=8, **kw)
    return (JServeEngine(jb, params, JServeConfig(impl=jimpl, **common)),
            ServeEngine(build(cfg), model, ServeConfig(impl=timpl, **common)))


@pytest.mark.parametrize("jimpl,timpl", [("pallas", "auto"), ("xla", "ref")])
def test_engine_matches_reference(rng, jimpl, timpl):
    """Greedy, t = 2, tail 8: one in-flight recompression on both sides.
    Free runs: same compressions and token shape (random-init logits are
    near-flat, so their tokens are reported, not required to agree). Then
    the reference's tokens forced on both engines: every step's logits
    within the LM bound, through prefill, compress, decode and recompress."""
    jeng, teng = _engines(jimpl, timpl)
    prompts = rng.integers(0, 128, size=(2, 16)).astype(np.int32)
    jout = jeng.generate({"tokens": jnp.asarray(prompts)})
    tout = teng.generate({"tokens": prompts})
    assert tout["compressions"] == jout["compressions"] == 1
    assert tuple(tout["tokens"].shape) == tuple(jout["tokens"].shape) == (2, 12)
    assert tout["tokens"].dtype == torch.int32
    agree = float((tout["tokens"].numpy() == np.asarray(jout["tokens"])).mean())
    print(f"free-run token agreement with the reference: {agree}")
    tm = tout["timings"]
    assert [c["slots_before"] for c in tm["compress"]] == [28, 22]
    assert [c["slots_after"] for c in tm["compress"]] == [22, 19]

    forced = np.asarray(jout["tokens"])

    def forcing(record, wrap):
        calls = iter(range(10 ** 6))

        def sample(logits, key):
            record.append(np.asarray(logits[:, -1], np.float32))
            i = min(next(calls), forced.shape[1] - 1)
            return wrap(forced[:, i])
        return sample

    jl, tl = [], []
    jeng._sample = forcing(jl, lambda a: jnp.asarray(a, jnp.int32))
    teng._sample = forcing(tl, lambda a: torch.from_numpy(a.astype(np.int32)))
    jeng.generate({"tokens": jnp.asarray(prompts)})
    teng.generate({"tokens": prompts})
    assert len(jl) == len(tl) == 13
    for i, (g, w) in enumerate(zip(tl, jl, strict=True)):
        assert_logits_close(g, w, f"engine step {i}")


def test_engine_temperature_sampling_uses_the_reference_keys():
    """Temperature sampling draws with the same threefry keys: on equal
    logits the two engines pick equal tokens."""
    jeng, teng = _engines("xla", "ref", temperature=0.7)
    logits = np.random.default_rng(5).normal(size=(3, 1, 128)).astype(np.float32)
    key = prng.PRNGKey(11)
    jkey = jax.random.PRNGKey(11)
    for i in range(4):
        want = np.asarray(jeng._sample(jnp.asarray(logits), jkey))
        got = teng._sample(torch.from_numpy(logits), key).numpy()
        np.testing.assert_array_equal(got, want)
        key, jkey = prng.fold_in(key, i), jax.random.fold_in(jkey, i)


def test_engine_stops_at_eos():
    _, teng = _engines("xla", "ref")
    prompts = np.random.default_rng(1).integers(0, 128, size=(2, 16))
    free = teng.generate({"tokens": prompts})
    teng.scfg.eos_id = int(free["tokens"][0, 0])
    teng.scfg.compress = False
    out = teng.generate({"tokens": prompts})
    # stops once every row has emitted the eos id at least once
    assert 1 <= out["n_steps"] <= 12


def test_kernel_route_matches_plain_route(rng):
    """The port's two routes on one model, as chip_smoke.py's lm phase runs
    them on the card: prefill, each route compresses its own cache, then 8
    teacher-forced decode steps, the logits within the route bound."""
    cfg = smoke_config(ARCHS["gemma2-2b"])
    tb = build(cfg)
    model = tb.init(torch.Generator().manual_seed(0), device="cpu")
    B, S, N = 2, 24, 8
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B, S + N)))
    logits, caches = {}, {}
    with torch.inference_mode():
        for impl in ("auto", "ref"):
            c = tb.init_caches(B, S + N, device="cpu")
            logits[impl], c = tb.prefill(model, c, {"tokens": toks[:, :S]}, impl=impl)
            caches[impl] = compress_model_caches(c, 2, 1, tail=N, impl=impl)
        assert_logits_close(logits["auto"][:, -1], logits["ref"][:, -1],
                            "prefill", ulps=ROUTE_ULPS)
        for i in range(N):
            step = {"tokens": toks[:, S + i:S + i + 1]}
            for impl in ("auto", "ref"):
                logits[impl], caches[impl] = tb.decode_step(
                    model, caches[impl], step, impl=impl)
            assert_logits_close(logits["auto"][:, -1], logits["ref"][:, -1],
                                f"step {i}", ulps=ROUTE_ULPS)
