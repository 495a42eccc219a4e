"""The port's LM (configs, layers, dense transformer) on the CPU against
the JAX package's, with the reference's own ``bundle.init`` parameters
carried across (``repro_torch.models.convert``).

Tolerance of the logits. Both sides run the model in bf16 with f32 norms,
rope, attention statistics and logits, but XLA:CPU and PyTorch round bf16
products and sums in other places, and a one-ulp difference in a bf16
activation travels through the layers. Measured on these smoke configs
(three seeds, prefill and 8 teacher-forced decode steps, both routes):
the largest |Δlogit| was 1.5 bf16 ulps of the largest |logit| for gemma2
(final softcap 30) and 3.75 for qwen2.5 (qkv bias). The bound held here
is 8 ulps, with top-1 agreement of at least 0.9 (1.0 in every case).

The port's two routes against each other (``ROUTE_ULPS``): the kernel
route ("auto": K5, f32 probabilities) and the plain route ("ref": bf16 PV
products) round differently, and after a compression each route clusters
its own cache, where a distance near-tie may fall another way. At the
full gemma2-2b on the card (``chip_smoke.py``'s ``lm`` phase, which holds
the same bound) they differed by 9.2 ulps at prefill and by up to 22.7
ulps in the 8 decode steps after the compression, with top-1 agreement
1.0; against K5's own plain version (f32 probabilities on both sides) by
8.9 and 23.3 ulps, so the spread comes from one-ulp differences of bf16
attention outputs travelling through 26 layers, not from the bf16 PV
product. The route bound is 32 ulps (4.0 at 16 ≤ |logit| < 32), top-1
≥ 0.9; one decode step with K5's bias dropped differed by 72 ulps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import smoke_config as j_smoke_config
from repro.models import build as j_build
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.models import build, layers, transformer
from repro_torch.models.convert import params_from_tree

torch.set_num_threads(1)

#: logits held to this many bf16 ulps of the largest |logit| (see above)
LOGIT_ULPS = 8
MIN_TOP1 = 0.9
#: the kernel route against the plain route of the port (see above)
ROUTE_ULPS = 32


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 values at magnitude x (8 significant bits)."""
    return float(2.0 ** (np.floor(np.log2(x)) - 7))


def assert_logits_close(got, want, what="", ulps=LOGIT_ULPS):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    bound = ulps * bf16_ulp(np.abs(want).max())
    err = np.abs(got - want).max()
    assert err <= bound, f"{what}: max |Δlogit| {err} > {bound}"
    top1 = (got.argmax(-1) == want.argmax(-1)).mean()
    assert top1 >= MIN_TOP1, f"{what}: top-1 agreement {top1}"


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_configs_are_the_reference_configs(name):
    cfg, jcfg = ARCHS[name], J_ARCHS[name]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(smoke_config(cfg)) == dataclasses.asdict(
        j_smoke_config(jcfg))
    assert cfg.padded_vocab_size == jcfg.padded_vocab_size
    assert cfg.param_count() == jcfg.param_count()
    for c in (cfg, smoke_config(cfg)):
        assert transformer.stack_plan(c) == jtransformer.stack_plan(
            J_ARCHS[name] if c is cfg else j_smoke_config(jcfg))
        assert [c.attn_type(l) for l in range(c.n_layers)] == [
            jcfg.attn_type(l) for l in range(c.n_layers)]


def test_gemma2_full_config():
    cfg = ARCHS["gemma2-2b"]
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size) == (
        26, 2304, 8, 4, 256, 9216, 256_000)
    assert transformer.stack_plan(cfg) == (0, 2, 13)
    assert [cfg.attn_type(l) for l in range(4)] == ["local", "global"] * 2


def test_norm_and_rope_match_reference(rng):
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32) * 3
    w = rng.normal(size=(16,)).astype(np.float32) * 0.1
    pos = np.broadcast_to(np.arange(7, 12), (2, 5))
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        tol = 1e-6 if dt == torch.float32 else 1e-2
        got = layers.rms_norm(torch.from_numpy(x).to(dt), torch.from_numpy(w), 1e-6)
        want = jlayers.rms_norm(jnp.asarray(x, jdt), jnp.asarray(w), 1e-6)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=tol, atol=tol)
        got = layers.rope(torch.from_numpy(x).to(dt), torch.from_numpy(pos.copy()),
                          10_000.0)
        want = jlayers.rope(jnp.asarray(x, jdt), jnp.asarray(pos), 10_000.0)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=tol, atol=tol * 10)


@pytest.mark.parametrize("kind", ["swiglu", "relu2", "gelu"])
def test_mlp_matches_reference(rng, kind):
    p = jlayers.init_mlp(jax.random.PRNGKey(1), 32, 64, kind)
    mlp = layers.MLP(32, 64, kind, device="cpu")
    for name, value in p.items():
        getattr(mlp, name).copy_(torch.from_numpy(np.array(value)))
    x = rng.normal(size=(3, 32)).astype(np.float32)
    want = np.asarray(jlayers.mlp_apply(p, jnp.asarray(x, jnp.bfloat16), kind)
                      .astype(jnp.float32))
    got = mlp(torch.from_numpy(x).bfloat16()).float().numpy()
    # bf16 activations: a few ulps of O(1) values
    np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2)


def _carry(arch, seed=0):
    jcfg, cfg = j_smoke_config(J_ARCHS[arch]), smoke_config(ARCHS[arch])
    jb = j_build(jcfg)
    params = jb.init(jax.random.PRNGKey(seed))
    model = params_from_tree(cfg, jax.tree_util.tree_map(np.array, params),
                             device="cpu")
    return jb, params, build(cfg), model


def test_convert_places_stacked_layers():
    """Stack entry j at repeat r is layer n_prefix + r·period + j."""
    jb, params, _, model = _carry("gemma2-2b")
    n_prefix, period, rep = transformer.stack_plan(model.cfg)
    assert (n_prefix, period, rep) == (0, 2, 2)
    for r in range(rep):
        for j in range(period):
            want = np.asarray(params["stack"][j]["attn"]["wq"][r]
                              .astype(jnp.bfloat16).astype(jnp.float32))
            got = model.layers[r * period + j].attn.wq.float().numpy()
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen2.5-32b"])
@pytest.mark.parametrize("jimpl,timpl", [("pallas", "auto"), ("xla", "ref")])
def test_prefill_and_decode_match_reference(rng, arch, jimpl, timpl):
    """Prefill logits and 8 teacher-forced decode steps, both routes
    (the port's "auto" is the reference's impl="pallas": K5 on windowless
    attention; "ref" is impl="xla": the chunked path)."""
    jb, params, tb, model = _carry(arch)
    B, S, N = 2, 24, 8
    toks = rng.integers(0, model.cfg.vocab_size, size=(B, S + N))
    jc = jb.init_caches(B, S + N)
    jl, jc = jb.prefill(params, jc, {"tokens": jnp.asarray(toks[:, :S], jnp.int32)},
                        impl=jimpl)
    tc = tb.init_caches(B, S + N, device="cpu")
    with torch.inference_mode():
        tl, tc = tb.prefill(model, tc, {"tokens": torch.from_numpy(toks[:, :S])},
                            impl=timpl)
    assert tuple(tl.shape) == (B, 1, model.cfg.padded_vocab_size)
    assert_logits_close(tl.numpy()[:, -1], np.asarray(jl)[:, -1], "prefill")
    for i in range(N):
        step = toks[:, S + i:S + i + 1]
        jl, jc = jb.decode_step(params, jc, {"tokens": jnp.asarray(step, jnp.int32)},
                                impl=jimpl)
        with torch.inference_mode():
            tl, tc = tb.decode_step(model, tc, {"tokens": torch.from_numpy(step)},
                                    impl=timpl)
        assert_logits_close(tl.numpy()[:, -1], np.asarray(jl)[:, -1], f"step {i}")
    assert transformer.cache_start_pos(tc) == S + N


def test_full_sequence_logits_match_last_only(rng):
    """Unembedding only the last position gives the last row of the full
    logits (the reference keeps logits[:, -1:] of the full set)."""
    _, _, tb, model = _carry("gemma2-2b")
    toks = torch.from_numpy(rng.integers(0, 128, size=(2, 9)))
    with torch.inference_mode():
        full, _ = model(toks, impl="ref")
        last, _ = model(toks, impl="ref", last_only=True)
    np.testing.assert_array_equal(full[:, -1:].numpy(), last.numpy())


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "phi-3-vision-4.2b"])
def test_unported_families_raise(arch):
    """The last two families build now; a family the port does not know
    (here the arch's own with another name) still raises."""
    cfg = smoke_config(ARCHS[arch])
    assert build(cfg).cfg is cfg
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build(dataclasses.replace(cfg, family=cfg.family + "-video"))


def test_random_init_is_seeded():
    cfg = smoke_config(ARCHS["gemma2-2b"])
    a = build(cfg).init(torch.Generator().manual_seed(3), device="cpu")
    b = build(cfg).init(torch.Generator().manual_seed(3), device="cpu")
    for (na, pa), (nb, pb) in zip(a.named_parameters(), b.named_parameters(),
                                  strict=True):
        assert na == nb and torch.equal(pa, pb)
    assert a.layers[0].attn.wq.dtype == torch.bfloat16
    assert a.layers[0].ln1.dtype == torch.float32


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the rule under test is the "
                    "no-GPU refusal")
    bundle = build(smoke_config(ARCHS["gemma2-2b"]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bundle.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bundle.init_caches(1, 8)
