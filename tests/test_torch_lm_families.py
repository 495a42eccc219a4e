"""The port's MoE, SSM and hybrid LMs (deepseek-moe-16b, llama4-scout,
mamba2-370m, jamba) on the CPU against the JAX package's, at
``smoke_config`` sizes, with the reference's own ``bundle.init``
parameters carried across (``repro_torch.models.convert``).

Logits are held to ``LOGIT_ULPS`` bf16 ulps of the largest |logit| with
top-1 agreement ≥ ``MIN_TOP1`` (``tests/test_torch_lm.py``; the top-1 over
the rows not within that bound of an argmax tie), on both routes
(the reference's ``impl="pallas"`` against the port's "auto", ``"xla"``
against "ref"). Routing is a step function: where a token's k-th and
(k+1)-th router probabilities nearly tie, a one-ulp bf16 difference
upstream picks another expert on one side (seen on these configs at
relative gaps of 3·10⁻⁴ to 1.6·10⁻²; one flip moved deepseek's logits by
61 ulps and, top-1 at llama4, by 197). So the MoE calls of the port run
pinned to the reference's choices (``chip_smoke.RoutingPin``): a token whose
own top-k differs from the reference's only among experts within 2⁻⁵ of
its top-k boundary takes the reference's; any other difference fails the
test. With that, the largest difference measured was 6.5 ulps (three
seeds, both routes, prefill and 8 decode steps).

Free-running greedy tokens are held bitwise against the reference's
engine up to the first step where the reference's own two best logits lie
within the logit bound (there a last-bit difference may pick the other
token; random-init logits are near-flat), and every token when no such
near-tie occurs.
"""
import contextlib
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jruntime
from repro.configs import ARCHS as J_ARCHS
from repro.configs import smoke_config as j_smoke_config
from repro.models import build as j_build
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve.kv_compression import compress_model_caches as j_compress_model_caches
from repro_torch import prng
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.models import build, moe, transformer
from repro_torch.models.convert import params_from_tree
from repro_torch.runtime import configure
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.serve.kv_compression import compress_model_caches, layer_keys
from repro_torch.utils.tree import param_path
from test_torch_kv_compression import assert_same_cache, dyadic
from test_torch_lm import LOGIT_ULPS, MIN_TOP1, bf16_ulp

sys.path.append(str(Path(__file__).resolve().parent.parent))
from chip_smoke import RoutingPin  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
FAMILIES = ["deepseek-moe-16b", "llama4-scout-17b-a16e", "mamba2-370m",
            "jamba-v0.1-52b"]
CONFIG_MODULES = {"deepseek-moe-16b": "deepseek_moe_16b",
                  "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
                  "mamba2-370m": "mamba2_370m",
                  "jamba-v0.1-52b": "jamba_v0_1_52b",
                  "gemma2-2b": "gemma2_2b", "granite-20b": "granite_20b",
                  "minitron-8b": "minitron_8b", "qwen2.5-32b": "qwen2_5_32b",
                  "phi-3-vision-4.2b": "phi_3_vision_4_2b",
                  "seamless-m4t-large-v2": "seamless_m4t_large_v2"}
ROUTES = [("pallas", "auto"), ("xla", "ref")]


@contextlib.contextmanager
def reference_routing(pin: RoutingPin):
    """While the block runs, every reference MoE call appends its top-k
    indices to ``pin.calls`` (in call order, jitted calls included)."""
    real = jmoe.moe_apply

    def recorded(p, x, cfg, **kw):
        xt = x.reshape(-1, x.shape[-1]).astype(jnp.float32)
        _, idx = jax.lax.top_k(jax.nn.softmax(xt @ p["router"], axis=-1),
                               cfg.n_experts_per_tok)
        jax.debug.callback(lambda a: pin.calls.append(np.array(a)), idx,
                           ordered=True)
        return real(p, x, cfg, **kw)

    jmoe.moe_apply = recorded
    try:
        yield pin
    finally:
        jmoe.moe_apply = real


def _carry(arch, seed=0):
    jcfg, cfg = j_smoke_config(J_ARCHS[arch]), smoke_config(ARCHS[arch])
    jb = j_build(jcfg)
    params = jb.init(jax.random.PRNGKey(seed))
    model = params_from_tree(cfg, jax.tree_util.tree_map(np.array, params),
                             device="cpu")
    return jb, params, build(cfg), model


def assert_logits_close(got, want, what=""):
    """Max |Δlogit| within LOGIT_ULPS bf16 ulps of the largest |logit|;
    top-1 agreement ≥ MIN_TOP1 over the rows whose reference's two best
    logits are further apart than that bound (a row nearer a tie may flip
    under any difference the bound allows; with B = 2 one such row would
    read 0.5)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    bound = LOGIT_ULPS * bf16_ulp(np.abs(want).max())
    err = np.abs(got - want).max()
    assert err <= bound, f"{what}: max |Δlogit| {err} > {bound}"
    top2 = -np.sort(-want, axis=-1)[..., :2]
    decided = (top2[..., 0] - top2[..., 1]) > bound
    if decided.any():
        top1 = (got.argmax(-1) == want.argmax(-1))[decided].mean()
        assert top1 >= MIN_TOP1, f"{what}: top-1 agreement {top1}"


# ------------------------------------------------------------ structure
@pytest.mark.parametrize("arch", sorted(CONFIG_MODULES))
def test_config_modules_are_the_reference_s(arch):
    """Every config module of the reference, and ``get_config`` with its
    unknown-name KeyError."""
    import importlib

    from repro.configs import get_config as j_get_config
    from repro_torch.configs import get_config

    mod = importlib.import_module(f"repro_torch.configs.{CONFIG_MODULES[arch]}")
    jmod = importlib.import_module(f"repro.configs.{CONFIG_MODULES[arch]}")
    assert dataclasses.asdict(mod.CONFIG) == dataclasses.asdict(jmod.CONFIG)
    assert dataclasses.asdict(mod.SMOKE) == dataclasses.asdict(jmod.SMOKE)
    assert mod.CONFIG is ARCHS[arch] is get_config(arch)
    assert dataclasses.asdict(j_get_config(arch)) == dataclasses.asdict(get_config(arch))
    with pytest.raises(KeyError, match="unknown arch"):
        get_config(arch + "-x")


def test_config_modules_cover_the_reference_s():
    import repro.configs as jconfigs

    jdir = Path(jconfigs.__file__).parent
    mods = {p.stem for p in jdir.glob("*.py")} - {"__init__", "archs", "base"}
    assert mods == set(CONFIG_MODULES.values())
    assert set(CONFIG_MODULES) == set(ARCHS)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_every_arch_builds(arch):
    """``build(smoke_config(cfg))`` for every arch: ``check_supported``
    raises for none, and the model's forward gives finite logits."""
    cfg = smoke_config(ARCHS[arch])
    transformer.check_supported(cfg)
    tb = build(cfg)
    model = tb.init(torch.Generator().manual_seed(0), device="cpu")
    b, s = 1, 6
    batch = {"tokens": torch.arange(b * s).reshape(b, s) % cfg.vocab_size}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = torch.zeros((b, 256, cfg.d_model))
    if cfg.frontend == "audio":
        batch["frames"] = torch.zeros((b, s, cfg.d_model))
    with torch.inference_mode():
        logits, _ = tb.forward(model, batch)
    assert tuple(logits.shape) == (b, s, cfg.padded_vocab_size)
    assert torch.isfinite(logits[..., :cfg.vocab_size]).all()


@pytest.mark.parametrize("arch", FAMILIES)
def test_full_width_parameters_are_the_reference_s(arch):
    """On the meta device, every parameter of the full-width model has the
    shape of its reference leaf (a stacked leaf per repeat) and the counts
    agree (``jax.eval_shape`` of the reference's ``init_lm``)."""
    cfg, jcfg = ARCHS[arch], J_ARCHS[arch]
    tree = jax.eval_shape(lambda: jtransformer.init_lm(jax.random.PRNGKey(0), jcfg))
    want = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(tree))
    model = transformer.LM(cfg, device="meta")
    got = 0
    for name, p in model.named_parameters():
        path, r = param_path(cfg, name)
        node = tree
        for part in path.split("/"):
            node = node[int(part)] if isinstance(node, (list, tuple)) else node[part]
        shape = node.shape[1:] if r is not None else node.shape
        assert tuple(p.shape) == tuple(shape), name
        got += p.numel()
    assert got == want
    expect = {"deepseek-moe-16b": 16.4e9, "llama4-scout-17b-a16e": 108e9,
              "mamba2-370m": 0.37e9, "jamba-v0.1-52b": 51.6e9}[arch]
    assert abs(got / expect - 1) < 0.03, got


def test_convert_places_moe_and_mamba_leaves():
    """deepseek: layer 0 stand-alone (dense), layers 1-3 one stacked MoE
    layer; jamba: a stacked (Mamba + MLP, attention + MoE) pair."""
    _, params, _, model = _carry("deepseek-moe-16b")
    assert transformer.stack_plan(model.cfg) == (1, 1, 3)
    np.testing.assert_array_equal(
        model.layers[0].mlp.gate.float().numpy(),
        np.asarray(params["prefix"][0]["mlp"]["gate"].astype(jnp.bfloat16)
                   .astype(jnp.float32)))
    for r in range(3):
        lay = model.layers[1 + r]
        np.testing.assert_array_equal(
            lay.moe.up.float().numpy(),
            np.asarray(params["stack"][0]["moe"]["up"][r].astype(jnp.bfloat16)
                       .astype(jnp.float32)))
        np.testing.assert_array_equal(
            lay.moe.router.numpy(), np.asarray(params["stack"][0]["moe"]["router"][r]))
        assert lay.moe.router.dtype == torch.float32
        assert not hasattr(lay, "mlp")
    _, params, _, model = _carry("jamba-v0.1-52b")
    assert transformer.stack_plan(model.cfg) == (0, 2, 2)
    for r in range(2):
        mb, at = model.layers[2 * r], model.layers[2 * r + 1]
        assert hasattr(mb, "mamba") and hasattr(mb, "mlp") and not hasattr(mb, "attn")
        assert hasattr(at, "attn") and hasattr(at, "moe")
        np.testing.assert_array_equal(
            mb.mamba.A_log.numpy(), np.asarray(params["stack"][0]["mamba"]["A_log"][r]))
        np.testing.assert_array_equal(
            mb.mamba.conv_w.float().numpy(),
            np.asarray(params["stack"][0]["mamba"]["conv_w"][r].astype(jnp.bfloat16)
                       .astype(jnp.float32)))
    _, _, _, model = _carry("mamba2-370m")
    assert all(not hasattr(b, "ln2") and not hasattr(b, "mlp") for b in model.layers)


def test_random_init_draws_experts_at_their_fan_in():
    """The port's own seeded draw: the router at 1/sqrt(d) (as the
    reference), each routed expert's (E, d_in, d_out) weights at
    1/sqrt(d_in) (the reference's ``_dense_init`` takes the expert count
    for the fan-in; ROADMAP.md, Queue 3), Mamba's constants as the
    reference sets them."""
    cfg = dataclasses.replace(smoke_config(ARCHS["jamba-v0.1-52b"]), d_model=256,
                              d_ff=512, n_experts=8)
    model = build(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    m = model.layers[1].moe
    for w, fan_in in ((m.router, 256), (m.gate, 256), (m.up, 256), (m.down, 512)):
        std = float(w.float().std())
        assert abs(std * fan_in ** 0.5 - 1) < 0.05, (tuple(w.shape), std)
    mb = model.layers[0].mamba
    assert (mb.A_log == 0).all() and (mb.D == 1).all() and (mb.dt_bias == -2).all()
    assert (mb.norm == 0).all() and (mb.conv_b == 0).all()
    assert abs(float(mb.conv_w.float().std()) / 0.5 - 1) < 0.05


# ------------------------------------------------------------ parity
@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("jimpl,timpl", ROUTES)
def test_prefill_and_decode_match_reference(rng, arch, jimpl, timpl):
    """Prefill logits and 8 teacher-forced decode steps, routing pinned to
    the reference's at near-ties (module docstring)."""
    jb, params, tb, model = _carry(arch)
    B, S, N = 2, 24, 8
    toks = rng.integers(0, model.cfg.vocab_size, size=(B, S + N))
    pin = RoutingPin()
    want = []
    with reference_routing(pin):
        jc = jb.init_caches(B, S + N)
        jl, jc = jb.prefill(params, jc, {"tokens": jnp.asarray(toks[:, :S], jnp.int32)},
                            impl=jimpl)
        want.append(np.asarray(jl)[:, -1])
        for i in range(N):
            jl, jc = jb.decode_step(params, jc, {"tokens": jnp.asarray(
                toks[:, S + i:S + i + 1], jnp.int32)}, impl=jimpl)
            want.append(np.asarray(jl)[:, -1])
    tc = tb.init_caches(B, S + N, device="cpu")
    got = []
    with torch.inference_mode(), pin.replay():
        tl, tc = tb.prefill(model, tc, {"tokens": torch.from_numpy(toks[:, :S])},
                            impl=timpl)
        got.append(tl.numpy()[:, -1])
        for i in range(N):
            tl, tc = tb.decode_step(model, tc, {"tokens": torch.from_numpy(
                toks[:, S + i:S + i + 1])}, impl=timpl)
            got.append(tl.numpy()[:, -1])
    assert pin.far == 0, f"{pin.far} routing differences beyond a near-tie"
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        assert_logits_close(g, w, f"step {i}")
    kinds = [model.cfg.layer_kind(l) for l in range(model.cfg.n_layers)]
    if "attn" in kinds:
        assert transformer.cache_start_pos(tc) == S + N
    for c, kind in zip(tc["layers"], kinds, strict=True):
        assert set(c) == ({"k", "v", "pos"} if kind == "attn" else {"ssm", "conv"})


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_and_aux_match_reference(rng, arch):
    """``bundle.forward``: the full (b, s, V) logits and the summed MoE aux
    loss (0 for mamba2), routing pinned as above."""
    jb, params, tb, model = _carry(arch)
    toks = rng.integers(0, model.cfg.vocab_size, size=(2, 20))
    pin = RoutingPin()
    with reference_routing(pin):
        jl, jaux = jb.forward(params, {"tokens": jnp.asarray(toks, jnp.int32)})
        jl, jaux = np.asarray(jl), float(jaux)
    with torch.no_grad(), pin.replay():
        tl, aux = tb.forward(model, {"tokens": torch.from_numpy(toks)})
    assert pin.far == 0
    assert tl.shape == (2, 20, model.cfg.padded_vocab_size)
    assert_logits_close(tl.numpy().reshape(40, -1), jl.reshape(40, -1), "forward")
    if model.cfg.n_experts:
        # the same counts (pinned) times mean router probabilities of bf16
        # activations that differ by ulps: within 2^-8 (one bf16 ulp)
        np.testing.assert_allclose(float(aux), jaux, rtol=2.0 ** -8)
    else:
        assert float(aux) == jaux == 0.0


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_matches_forward(arch):
    """The port alone (tests/test_decode_consistency.py's cases): prefill
    of 9 tokens and 2 decode steps give the full forward's logits at those
    positions, within LOGIT_ULPS of the largest |logit| in place of the
    reference test's absolute 0.05 (deepseek's decode read 0.0547 here:
    bf16 activations of one-token and 12-token calls round apart). The
    prefill's and the steps' MoE calls are pinned, at near-ties, to the
    forward's routing of the same tokens (llama4's top-1 routing flipped
    one token at a near-tie and moved its logits by 0.98)."""
    cfg = smoke_config(ARCHS[arch])
    tb = build(cfg)
    model = tb.init(torch.Generator().manual_seed(0), device="cpu")
    B, S = 2, 12
    npre = S - 3
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                              size=(B, S)))
    pin = RoutingPin()
    with torch.inference_mode():
        with pin.record():
            full, _ = tb.forward(model, {"tokens": toks})
        # the forward's (B·S, k) choices, per layer, cut to the calls of the
        # prefill (B·npre tokens) and of each decode step (B tokens)
        per_layer = [c.reshape(B, S, -1) for c in pin.calls]
        pin.calls = ([c[:, :npre].reshape(B * npre, -1) for c in per_layer]
                     + [c[:, t] for t in range(npre, S - 1) for c in per_layer])
        caches = tb.init_caches(B, S, device="cpu")
        with pin.replay():
            lg, caches = tb.prefill(model, caches, {"tokens": toks[:, :npre]})
            outs = [lg[:, -1]]
            for t in range(npre, S - 1):
                lg, caches = tb.decode_step(model, caches,
                                            {"tokens": toks[:, t:t + 1]})
                outs.append(lg[:, -1])
    assert pin.far == 0
    dec = torch.stack(outs, dim=1)
    assert_logits_close(dec.reshape(-1, dec.shape[-1]).numpy(),
                        full[:, npre - 1:S - 1].reshape(-1, dec.shape[-1]).numpy(),
                        "decode vs forward")


# ------------------------------------------------------------ compression
def test_compression_passes_mamba_caches_and_keys_attention_layers(rng):
    """jamba's smoke layout (a stacked Mamba + attention pair, 2 repeats):
    the Mamba states come back as the same tensors, bitwise; each
    attention layer is compressed with the key of its stacked position,
    bitwise against the reference's {"prefix", "stack"} compression."""
    cfg = smoke_config(ARCHS["jamba-v0.1-52b"])
    assert transformer.stack_plan(cfg) == (0, 2, 2)
    b, S, pos = 1, 24, 20
    h, hd = cfg.n_kv_heads, cfg.head_dim
    kv = {l: (dyadic(rng, (b, h, S, hd)), dyadic(rng, (b, h, S, hd))) for l in (1, 3)}
    tcaches = transformer.init_lm_caches(cfg, b, S, device="cpu")
    for l, c in enumerate(tcaches["layers"]):
        if l in kv:
            c["k"] = torch.from_numpy(kv[l][0])
            c["v"] = torch.from_numpy(kv[l][1])
            c["pos"] = pos
        else:
            c["ssm"] = torch.from_numpy(rng.normal(size=c["ssm"].shape).astype(np.float32))
            c["conv"] = torch.from_numpy(rng.normal(size=c["conv"].shape)
                                         .astype(np.float32)).bfloat16()
    before = [dict(c) for c in tcaches["layers"]]
    snap = [{n: (a.clone() if torch.is_tensor(a) else a) for n, a in c.items()}
            for c in tcaches["layers"]]
    mamba = {"ssm": jnp.asarray(np.stack([snap[l]["ssm"].numpy() for l in (0, 2)])),
             "conv": jnp.asarray(np.stack([snap[l]["conv"].float().numpy()
                                           for l in (0, 2)]), jnp.bfloat16)}
    att = {"k": jnp.asarray(np.stack([kv[l][0] for l in (1, 3)])),
           "v": jnp.asarray(np.stack([kv[l][1] for l in (1, 3)])),
           "pos": jnp.full((2,), pos, jnp.int32)}
    with jruntime.configure(n_blocks=1):
        want = j_compress_model_caches({"prefix": [], "stack": [mamba, att]}, 2, 1,
                                       tail=4, impl="ref")
    with configure(n_blocks=1):
        got = compress_model_caches(tcaches, 2, 1, tail=4, impl="ref")
    for l in (0, 2):
        c = got["layers"][l]
        assert c is before[l]["ssm"] or c["ssm"] is before[l]["ssm"]
        for name in ("ssm", "conv"):
            np.testing.assert_array_equal(c[name].float().numpy(),
                                          snap[l][name].float().numpy())
            np.testing.assert_array_equal(
                c[name].float().numpy(),
                np.asarray(want["stack"][0][name][l // 2].astype(jnp.float32)))
    for l in (1, 3):
        sub = {n: a[l // 2] for n, a in want["stack"][1].items()}
        assert_same_cache(got["layers"][l], sub, f"layer {l}")
    keys = [prng.key_to_numpy(k) for k in layer_keys(tcaches, prng.PRNGKey(0))]
    for l, j in zip(range(4), (0, 1, 0, 1), strict=True):
        np.testing.assert_array_equal(
            keys[l], np.asarray(jax.random.fold_in(jax.random.PRNGKey(0), 100 + j)))


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "jamba-v0.1-52b"])
def test_smoke_holds_every_attention_call_and_catches_a_dropped_bias(
        arch, monkeypatch):
    """The card's family parity (``chip_smoke.py``) on the CPU, where every
    attention call is K5's plain version: ``_attention_held`` sees each
    attention layer's prefill and every teacher-forced step, each within
    its tolerance of the plain version on the same inputs (here the same
    code: ratio 0); with K5's bias dropped (the planted fault: the
    compressed cache's log-masses and masked slots) the same reading
    exceeds the tolerance."""
    import chip_smoke
    from repro_torch.kernels import flash_attention as fa

    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    cfg = smoke_config(ARCHS[arch])
    tb = build(cfg)
    model = tb.init(torch.Generator().manual_seed(0), device="cpu")
    traffic = dict(new_tokens=8, t=2, m=1, tail=4)
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 24)))
    steps = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 3)))
    held, f_held = [], []
    with configure(n_blocks=1):
        out, _, start = chip_smoke._forced_route(
            tb, model, tok, steps, impl="auto", compress_impl="auto",
            traffic=traffic, held=held)
        with torch.inference_mode(), chip_smoke._attention_as(
                lambda q, k, v, kv_bias, **kw: fa.flash_attention_plain(q, k, v, None,
                                                                        **kw)), \
                chip_smoke._attention_held(f_held):
            tb.decode_step(model, start, {"tokens": steps[:, :1]}, impl="auto")
    n_attn = sum(cfg.layer_kind(l) == "attn" for l in range(cfg.n_layers))
    att = chip_smoke._held_summary(held)
    assert len(out) == 1 + steps.shape[1]
    assert att["prefill"]["calls"] == n_attn
    assert att["decode"]["calls"] == n_attn * steps.shape[1]
    assert att["prefill"]["ratio"] == att["decode"]["ratio"] == 0.0
    assert chip_smoke._held_summary(f_held)["decode"]["ratio"] > 1.0


def test_top1_over_rows_reads_every_row():
    """The card's top-1 reading: the share of agreeing rows over the
    prefill and every step (a step at batch 4 reads 0.75 for one flip)."""
    import chip_smoke

    want = torch.tensor([[0.0, 1.0, 0.5], [2.0, 0.0, 1.0]])
    errs = [chip_smoke._family_logit_diff(want, want, 3),
            chip_smoke._family_logit_diff(want.flip(-1), want, 3)]
    assert [e["top1"] for e in errs] == [1.0, 0.5]
    assert chip_smoke._top1_over_rows(errs) == 0.75


def test_compress_on_a_model_without_attention_raises():
    cfg = smoke_config(ARCHS["mamba2-370m"])
    tb = build(cfg)
    model = tb.init(torch.Generator().manual_seed(0), device="cpu")
    prompts = np.zeros((1, 8), np.int64)
    eng = ServeEngine(tb, model, ServeConfig(max_new_tokens=2, compress=True))
    with pytest.raises(ValueError, match="mamba2-370m"):
        eng.generate({"tokens": prompts})
    eng.scfg.compress = False
    out = eng.generate({"tokens": prompts})
    assert tuple(out["tokens"].shape) == (1, 2)


@pytest.mark.parametrize("jimpl,timpl", ROUTES)
@pytest.mark.parametrize("seed", [0, 1])
def test_engine_tokens_match_reference_on_jamba(jimpl, timpl, seed):
    """Greedy generation with IHTC compression (t 2, tail 8: one in-flight
    recompression) on jamba's smoke config: the same compressions and
    slots, and tokens bitwise up to the first near-tie of the reference's
    logits (module docstring)."""
    jb, params, tb, model = _carry("jamba-v0.1-52b")
    common = dict(max_new_tokens=12, compress=True, compress_t=2, compress_m=1,
                  compress_tail=8)
    jeng = JServeEngine(jb, params, JServeConfig(impl=jimpl, **common))
    teng = ServeEngine(tb, model, ServeConfig(impl=timpl, **common))
    jlog = []
    jsample = jeng._sample

    def record(logits, key):
        jax.debug.callback(lambda a: jlog.append(np.array(a)), logits[:, -1],
                           ordered=True)
        return jsample(logits, key)

    jeng._sample = record
    prompts = np.random.default_rng(seed).integers(0, 128, size=(2, 16)).astype(np.int32)
    pin = RoutingPin()
    with reference_routing(pin):
        jout = jeng.generate({"tokens": jnp.asarray(prompts)})
    with pin.replay():
        tout = teng.generate({"tokens": prompts})
    assert tout["compressions"] == jout["compressions"] == 1
    tm = tout["timings"]["compress"]
    assert [(c["slots_before"], c["slots_after"]) for c in tm] == [(28, 22), (22, 19)]
    want, got = np.asarray(jout["tokens"]), tout["tokens"].numpy()
    assert got.shape == want.shape == (2, 12)
    for row in range(2):
        for i in range(12):
            top2 = np.sort(jlog[i][row])[::-1][:2]
            bound = LOGIT_ULPS * bf16_ulp(np.abs(jlog[i]).max())
            if top2[0] - top2[1] <= bound:
                break  # a near-tie: the rest of the row may part
            assert got[row, i] == want[row, i], f"row {row} step {i}"
    if (got == want).all():
        assert pin.far == 0


# ------------------------------------------------------------ launcher
@pytest.mark.parametrize("arch,extra", [
    ("deepseek-moe-16b", ["--compress", "--compress-tail", "8"]),
    ("mamba2-370m", []),
    ("jamba-v0.1-52b", ["--compress", "--compress-tail", "8"]),
    ("phi-3-vision-4.2b", ["--compress", "--compress-tail", "8"]),
    ("seamless-m4t-large-v2", [])])
def test_launch_serve_runs_the_family_on_the_cpu(arch, extra):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch, "--smoke",
         "--device", "cpu", "--batch", "2", "--prompt-len", "16", "--new-tokens",
         "12", *extra],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "generated (2, 12) on cpu" in out.stdout
    if extra:
        assert "2 compressions (1 in flight" in out.stdout
