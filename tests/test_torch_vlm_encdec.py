"""The port's VLM (phi-3-vision-4.2b) and audio encoder-decoder
(seamless-m4t-large-v2) on the CPU against the JAX package's, at
``smoke_config`` sizes (4 decoder layers, 2 encoder layers for seamless,
d 64, head_dim 16), with the reference's own ``bundle.init`` parameters
carried across (``repro_torch.models.convert``) and inputs from a numpy
seed.

Logits are held to ``LOGIT_ULPS`` bf16 ulps of the largest |logit| with
top-1 agreement ≥ ``MIN_TOP1`` over the rows whose reference's two best
logits lie further apart than that bound (``tests/test_torch_lm.py``'s
rule, as ``test_torch_lm_families.py`` reads it). Both routes: the
reference's ``impl="pallas"`` against the port's "auto" (K5's plain
version on the CPU), ``"xla"`` against "ref". The VLM's 256-token patch
prefix stands before the prompt in every prefill; seamless's encoder
takes the frames (non-causal) and its decoder cross-attends to them.
"""
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
from repro.data.pipeline import make_batch as j_make_batch
from repro.models import attention as jattention
from repro.models import build as j_build
from repro.models import frontends as jfrontends
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve.kv_compression import compress_model_caches as j_compress_model_caches
from repro_torch import prng
from repro_torch.configs import ARCHS, SHAPES, smoke_config
from repro_torch.data import make_batch
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention, build, encdec, frontends, transformer
from repro_torch.models.convert import params_from_tree
from repro_torch.runtime import configure
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.serve.kv_compression import compress_model_caches
from test_torch_kv_compression import assert_same_cache, dyadic
from test_torch_lm import LOGIT_ULPS, MIN_TOP1, bf16_ulp

sys.path.append(str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

VLM, ENCDEC = "phi-3-vision-4.2b", "seamless-m4t-large-v2"
ARCH_LIST = [VLM, ENCDEC]
ROUTES = [("pallas", "auto"), ("xla", "ref")]


def assert_logits_close(got, want, what=""):
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


def _carry(arch, seed=0):
    jcfg, cfg = j_smoke_config(J_ARCHS[arch]), smoke_config(ARCHS[arch])
    jb = j_build(jcfg)
    params = jb.init(jax.random.PRNGKey(seed))
    model = params_from_tree(cfg, jax.tree_util.tree_map(np.array, params),
                             device="cpu")
    return jb, params, build(cfg), model


def _inputs(rng, cfg, b, s):
    """(numpy batch, reference batch, port batch, cache kwargs): the
    prompt, and the VLM's patch prefix or seamless's s frames (f32 draws
    × 0.02: both sides round them to bf16)."""
    toks = rng.integers(0, cfg.vocab_size, size=(b, s))
    extra = {}
    if cfg.frontend == "vision":
        extra["patch_embeds"] = (rng.normal(size=(b, frontends.VISION_PREFIX_TOKENS,
                                                  cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.frontend == "audio":
        extra["frames"] = (rng.normal(size=(b, s, cfg.d_model)) * 0.02).astype(np.float32)
    jbatch = {"tokens": jnp.asarray(toks, jnp.int32),
              **{k: jnp.asarray(v) for k, v in extra.items()}}
    tbatch = {"tokens": torch.from_numpy(toks),
              **{k: torch.from_numpy(v) for k, v in extra.items()}}
    kw = {"enc_len": s} if "frames" in extra else {}
    return toks, jbatch, tbatch, kw


# ------------------------------------------------------------ structure
def test_every_arch_builds_and_none_is_refused():
    for name, cfg in ARCHS.items():
        transformer.check_supported(cfg)
        model = build(smoke_config(cfg)).init(torch.Generator().manual_seed(0),
                                               device="cpu")
        want = encdec.EncDec if cfg.family == "encdec-audio" else transformer.LM
        assert type(model) is want, name


def test_encdec_parameters_are_the_reference_s():
    """Every port parameter has its reference leaf (stacked per layer) and
    the counts agree, at full width on the meta device."""
    cfg, jcfg = ARCHS[ENCDEC], J_ARCHS[ENCDEC]
    from repro.models import encdec as jencdec
    from repro_torch.utils.tree import param_path

    tree = jax.eval_shape(lambda: jencdec.init_encdec(jax.random.PRNGKey(0), jcfg))
    want = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(tree))
    model = encdec.EncDec(cfg, device="meta")
    got = 0
    for name, p in model.named_parameters():
        path, r = param_path(cfg, name)
        node = tree
        for part in path.split("/"):
            node = node[part]
        assert r is not None or not name.startswith(("enc.", "dec.")), name
        shape = node.shape[1:] if r is not None else node.shape
        assert tuple(shape) == tuple(p.shape), name
        got += p.numel()
    assert got == want


def test_convert_places_encdec_layers():
    jb, params, _, model = _carry(ENCDEC)
    for side, n in (("enc", 2), ("dec", 4)):
        for i in range(n):
            for leaf in (("attn" if side == "enc" else "cross_attn"), "wk"), ("mlp", "up"):
                want = np.asarray(params[side][leaf[0]][leaf[1]][i]
                                  .astype(jnp.bfloat16).astype(jnp.float32))
                layer = getattr(model, side)[i]
                got = getattr(getattr(layer, leaf[0]), leaf[1]).float().numpy()
                np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(model.ln_enc.numpy(), np.asarray(params["ln_enc"]))


# ------------------------------------------------------------ parity
@pytest.mark.parametrize("arch", ARCH_LIST)
def test_forward_matches_reference(rng, arch):
    """``bundle.forward``: the VLM's (b, s, V) logits with the prefix's
    dropped, the enc-dec's decoder logits over the frames."""
    jb, params, tb, model = _carry(arch)
    toks, jbatch, tbatch, _ = _inputs(rng, model.cfg, 2, 20)
    jl, jaux = jb.forward(params, jbatch)
    with torch.inference_mode():
        tl, aux = tb.forward(model, tbatch)
    assert tl.shape == (2, 20, model.cfg.padded_vocab_size)
    assert float(aux) == float(jaux) == 0.0
    assert_logits_close(tl.numpy().reshape(40, -1), np.asarray(jl).reshape(40, -1),
                        "forward")


@pytest.mark.parametrize("arch", ARCH_LIST)
@pytest.mark.parametrize("jimpl,timpl", ROUTES)
def test_prefill_and_decode_match_reference(rng, arch, jimpl, timpl):
    """Prefill (with the prefix or the frames) and three teacher-forced
    decode steps; the decode position comes from the self cache."""
    jb, params, tb, model = _carry(arch)
    B, S, N = 2, 16, 3
    toks, jbatch, tbatch, kw = _inputs(rng, model.cfg, B, S + N)
    jpre = {**jbatch, "tokens": jbatch["tokens"][:, :S]}
    tpre = {**tbatch, "tokens": tbatch["tokens"][:, :S]}
    jc = jb.init_caches(B, S + N, **kw)
    jl, jc = jb.prefill(params, jc, jpre, impl=jimpl)
    tc = tb.init_caches(B, S + N, device="cpu", **kw)
    with torch.inference_mode():
        tl, tc = tb.prefill(model, tc, tpre, impl=timpl)
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
    if arch == VLM:
        assert transformer.cache_start_pos(tc) == frontends.VISION_PREFIX_TOKENS + S + N
    else:
        assert encdec.cache_start_pos(tc) == S + N
        assert ServeEngine._cache_size(tc) == S + N  # the self caches' slots
        c0 = tc["layers"][0]
        assert set(c0) == {"self", "cross_k", "cross_v"}
        hkv, hd = model.cfg.n_kv_heads, model.cfg.head_dim
        assert tuple(c0["cross_k"].shape) == (B, hkv, S + N, hd)
        # the cached cross keys: the reference's (b, s, h, d) heads first,
        # apart from the ulps the encoder output differs by (the logits' rule)
        got_k = c0["cross_k"].float().numpy()
        want_k = np.asarray(jc["cross_k"][0].astype(jnp.float32)).transpose(0, 2, 1, 3)
        assert np.abs(got_k - want_k).max() <= LOGIT_ULPS * bf16_ulp(np.abs(want_k).max())


@pytest.mark.parametrize("arch", ARCH_LIST)
def test_decode_matches_forward(arch):
    """The port alone (tests/test_decode_consistency.py's cases): a
    prefill of 9 tokens and 2 decode steps give the full forward's logits
    at those positions, within LOGIT_ULPS of the largest |logit|."""
    cfg = smoke_config(ARCHS[arch])
    tb = build(cfg)
    model = tb.init(torch.Generator().manual_seed(0), device="cpu")
    B, S = 2, 12
    npre = S - 3
    _, _, batch, kw = _inputs(np.random.default_rng(0), cfg, B, S)
    toks = batch["tokens"]
    with torch.inference_mode():
        full, _ = tb.forward(model, batch)
        caches = tb.init_caches(B, S, device="cpu", **kw)
        lg, caches = tb.prefill(model, caches, {**batch, "tokens": toks[:, :npre]})
        outs = [lg[:, -1]]
        for t in range(npre, S - 1):
            lg, caches = tb.decode_step(model, caches, {"tokens": toks[:, t:t + 1]})
            outs.append(lg[:, -1])
    dec = torch.stack(outs, dim=1)
    assert_logits_close(dec.reshape(-1, dec.shape[-1]).numpy(),
                        full[:, npre - 1:S - 1].reshape(-1, dec.shape[-1]).numpy(),
                        "decode vs forward")


@pytest.mark.parametrize("timpl", ["auto", "ref"])
def test_cross_attention_matches_reference(rng, timpl):
    """``attention_apply`` with ``cross_kv``: q projected, neither q nor k
    rotated, no mask, against the reference's; a rotated q (rope at the
    decoder positions, the fault of applying rope in the cross branch)
    must change the answer by more than the tolerance."""
    jb, params, _, model = _carry(ENCDEC)
    cfg = model.cfg
    b, s, s_enc = 2, 5, 11
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    x = (rng.normal(size=(b, s, cfg.d_model))).astype(np.float32)
    k = rng.normal(size=(b, s_enc, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, s_enc, hkv, hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s) + 7, (b, s))
    jp = jax.tree_util.tree_map(lambda a: a[0], params["dec"]["cross_attn"])
    want, _ = jattention.attention_apply(
        jp, jnp.asarray(x, jnp.bfloat16), jb.cfg,
        layer=0, positions=jnp.asarray(pos), causal=False,
        cross_kv=(jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)),
        impl="pallas" if timpl == "auto" else "xla")
    want = np.asarray(want.astype(jnp.float32))
    p = model.dec[0].cross_attn
    kt = torch.from_numpy(k).bfloat16().transpose(1, 2).contiguous()
    vt = torch.from_numpy(v).bfloat16().transpose(1, 2).contiguous()
    xt = torch.from_numpy(x).bfloat16()
    with torch.inference_mode():
        got, cache = attention.attention_apply(
            p, xt, cfg, layer=0, positions=torch.from_numpy(pos.copy()), causal=False,
            cross_kv=(kt, vt), impl=timpl)
    assert cache is None
    tol = dict(rtol=2 ** -7, atol=2 ** -9)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
    # the fault: q rotated at the decoder positions
    with torch.inference_mode():
        q = (xt @ p.wq).reshape(b, s, cfg.n_heads, hd)
        q = attention.rope(q, torch.from_numpy(pos.copy()), cfg.rope_theta)
        out = attention.attend(q.transpose(1, 2), kt, vt, causal=False, impl=timpl)
        bad = (out.transpose(1, 2).reshape(b, s, -1) @ p.wo).float().numpy()
    assert not np.allclose(bad, want, **tol)


# ------------------------------------------------------------ engine
@pytest.mark.parametrize("jimpl,timpl", ROUTES)
def test_engine_tokens_match_reference_on_seamless(jimpl, timpl):
    """Greedy generation with frames and ``enc_len``: tokens bitwise up to
    the first step where the reference's two best logits lie within the
    logit bound (there a last-bit difference may pick the other token)."""
    _engine_against_reference(ENCDEC, jimpl, timpl, compress=False)


@pytest.mark.parametrize("jimpl,timpl", ROUTES)
def test_engine_tokens_match_reference_on_phi3v(jimpl, timpl):
    """Greedy generation with the patch prefix and IHTC compression (t 2,
    tail 8: one compression after the prefill, one in flight): the same
    compressions and slots, tokens as above."""
    _engine_against_reference(VLM, jimpl, timpl, compress=True)


def _engine_against_reference(arch, jimpl, timpl, *, compress):
    jb, params, tb, model = _carry(arch)
    common = dict(max_new_tokens=12, compress=compress, compress_t=2,
                  compress_m=1, compress_tail=8)
    jeng = JServeEngine(jb, params, JServeConfig(impl=jimpl, **common))
    teng = ServeEngine(tb, model, ServeConfig(impl=timpl, **common))
    jlog = []
    jsample = jeng._sample

    def record(logits, key):
        jax.debug.callback(lambda a: jlog.append(np.array(a)), logits[:, -1],
                           ordered=True)
        return jsample(logits, key)

    jeng._sample = record
    _, jbatch, tbatch, kw = _inputs(np.random.default_rng(1), model.cfg, 2, 16)
    jout = jeng.generate(jbatch, **kw)
    tout = teng.generate(tbatch, **kw)
    assert tout["compressions"] == jout["compressions"] == (1 if compress else 0)
    if compress:
        total = frontends.VISION_PREFIX_TOKENS + 16 + 12
        first = total // 2 + 8
        assert [(c["slots_before"], c["slots_after"])
                for c in tout["timings"]["compress"]] == [(total, first),
                                                          (first, first // 2 + 8)]
    want, got = np.asarray(jout["tokens"]), tout["tokens"].numpy()
    assert got.shape == want.shape == (2, 12)
    for row in range(2):
        for i in range(12):
            top2 = np.sort(jlog[i][row])[::-1][:2]
            bound = LOGIT_ULPS * bf16_ulp(np.abs(jlog[i]).max())
            if top2[0] - top2[1] <= bound:
                break  # a near-tie: the rest of the row may part
            assert got[row, i] == want[row, i], f"row {row} step {i}"


def test_vlm_cache_compresses_as_the_reference(rng):
    """The VLM's cache after a prefill (prefix + prompt valid of prefix +
    prompt + new slots), compressed by the port and by the reference from
    the same (dyadic) keys and values: bitwise slots and masses, the bias
    within one f32 ulp of ``log(mass)`` (``test_torch_kv_compression.py``'s
    rule), each layer with the key of its stacked position."""
    cfg = smoke_config(ARCHS[VLM])
    n_prefix, period, rep = transformer.stack_plan(cfg)
    b, h, hd = 1, cfg.n_kv_heads, cfg.head_dim
    pos = frontends.VISION_PREFIX_TOKENS + 16
    S = pos + 12
    tcaches = build(cfg).init_caches(b, 28, device="cpu")
    assert tcaches["layers"][0]["k"].shape[2] == S
    kv = [(dyadic(rng, (b, h, S, hd)), dyadic(rng, (b, h, S, hd)))
          for _ in range(cfg.n_layers)]
    for c, (k, v) in zip(tcaches["layers"], kv, strict=True):
        c["k"], c["v"], c["pos"] = torch.from_numpy(k), torch.from_numpy(v), pos
    layers = [{"k": jnp.asarray(k), "v": jnp.asarray(v), "pos": jnp.asarray(pos)}
              for k, v in kv]
    jcaches = {"prefix": layers[:n_prefix], "stack": [
        {n: jnp.stack([layers[n_prefix + r * period + j][n] for r in range(rep)])
         for n in ("k", "v", "pos")} for j in range(period)]}
    with jruntime.configure(n_blocks=1):
        want = j_compress_model_caches(jcaches, 2, 1, tail=8, impl="ref")
    with configure(n_blocks=1):
        got = compress_model_caches(tcaches, 2, 1, tail=8, impl="ref")
    for l, c in enumerate(got["layers"]):
        if l < n_prefix:
            sub = want["prefix"][l]
        else:
            r, j = divmod(l - n_prefix, period)
            sub = {n: a[r] for n, a in want["stack"][j].items()}
        assert_same_cache(c, sub, f"layer {l}")


def test_compress_on_an_encdec_model_raises():
    """The port refuses ``compress=True`` on seamless before the prefill,
    naming the model; the reference's engine fails on the same input with
    a bare StopIteration (its compression returns the cache dict's keys,
    then finds no attention cache: ROADMAP.md, Queue 3)."""
    jb, params, tb, model = _carry(ENCDEC)
    _, jbatch, tbatch, kw = _inputs(np.random.default_rng(0), model.cfg, 1, 8)
    eng = ServeEngine(tb, model, ServeConfig(max_new_tokens=2, compress=True))
    calls = []
    real = tb.prefill
    object.__setattr__(tb, "prefill", lambda *a, **k: calls.append(1) or real(*a, **k))
    with pytest.raises(ValueError, match="seamless-m4t-large-v2"):
        eng.generate(tbatch, **kw)
    assert calls == []
    jeng = JServeEngine(jb, params, JServeConfig(max_new_tokens=2, compress=True))
    with pytest.raises(StopIteration):
        jeng.generate(jbatch, **kw)
    eng.scfg.compress = False
    out = eng.generate(tbatch, **kw)
    assert tuple(out["tokens"].shape) == (1, 2)


# ------------------------------------------------------------ data
def assert_same_bf16_draws(got: torch.Tensor, want):
    """bf16 stub draws: the same uniform bits under both (threefry bit for
    bit) and the same f32 normals (the port follows XLA's ``erf_inv``,
    ``repro_torch.xla_math``), so the bf16 values are equal."""
    w = torch.from_numpy(np.asarray(want.astype(jnp.float32))).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == tuple(w.shape)
    assert torch.equal(got, w)


@pytest.mark.parametrize("arch,name", [(VLM, "patch_embeds"), (ENCDEC, "frames")])
def test_frontend_batches_are_the_reference_s(arch, name):
    cfg, jcfg = smoke_config(ARCHS[arch]), j_smoke_config(J_ARCHS[arch])
    got = make_batch(cfg, SHAPES["train_4k"], 3, batch_override=2, seq_override=16)
    want = j_make_batch(jcfg, SHAPES["train_4k"], 3, batch_override=2,
                        seq_override=16)
    assert set(got) == set(want) == {"tokens", "labels", name}
    assert got[name].dtype == torch.bfloat16
    assert_same_bf16_draws(got[name], want[name])
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))


@pytest.mark.parametrize("arch", ARCH_LIST)
def test_fake_frontend_embeddings_are_the_reference_s(arch):
    cfg, jcfg = smoke_config(ARCHS[arch]), j_smoke_config(J_ARCHS[arch])
    got = frontends.fake_frontend_embeddings(prng.PRNGKey(5), cfg, 2, 12)
    want = jfrontends.fake_frontend_embeddings(jax.random.PRNGKey(5), jcfg, 2, 12)
    assert tuple(got.shape) == tuple(want.shape) == frontends.frontend_embed_shape(
        cfg, 2, 12)
    assert_same_bf16_draws(got, want)
    assert frontends.frontend_embed_shape(smoke_config(ARCHS["gemma2-2b"]), 2, 12) is None


# ------------------------------------------------------------ K5 at dh 96
def test_head_dim_96_takes_the_tensor_cores():
    assert 96 in fa.MMA_HEAD_DIMS
    assert fa.route(32, 32, 2304, torch.bfloat16, 96) == "tiled_mma"
    assert fa.route(32, 32, 1, torch.bfloat16, 96) == "split_kv"
    assert fa.route(32, 32, 2304, torch.float32, 96) == "tiled"
    # seamless's calls: the encoder, the cross prefill, both decode calls
    assert fa.route(16, 16, 2048, torch.bfloat16, 64) == "tiled_mma"
    assert fa.route(16, 16, 128, torch.bfloat16, 64) == "tiled_mma"
    assert fa.route(16, 16, 1, torch.bfloat16, 64) == "split_kv"


# ------------------------------------------------------------ the card's check
@pytest.mark.parametrize("arch", ARCH_LIST)
def test_smoke_holds_every_attention_call_and_catches_the_fault(arch, monkeypatch):
    """The card's lm_vlm / lm_encdec parity (``chip_smoke.py``) on the CPU,
    where every attention call is K5's plain version: ``_attention_held``
    sees each prefill call (phi-3: one a layer; seamless: each encoder
    layer and each decoder layer's self and cross call) and every
    teacher-forced step's, each within its tolerance of the plain version
    (here the same code: ratio 0); the planted fault (phi-3: K5's bias
    dropped at the first step; seamless: every call causal at the prefill)
    exceeds it."""
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    cfg = smoke_config(ARCHS[arch])
    vlm = arch == VLM
    tb = build(cfg)
    model = tb.init(torch.Generator().manual_seed(0), device="cpu")
    traffic = dict(new_tokens=8, t=2, m=1, tail=4)
    _, _, batch, kw = _inputs(np.random.default_rng(0), cfg, 2, 12)
    tok = batch.pop("tokens")
    steps = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size,
                                                               size=(2, 3)))
    held, f_held = [], []
    with configure(n_blocks=1):
        out, _, start = chip_smoke._forced_route(
            tb, model, tok, steps, impl="auto", compress_impl="auto",
            traffic=traffic, held=held, inputs=batch, cache_kw=kw, compress=vlm)
        with torch.inference_mode():
            if vlm:
                with chip_smoke._attention_as(
                        lambda q, k, v, kv_bias, **a: fa.flash_attention(q, k, v, None,
                                                                         **a)), \
                        chip_smoke._attention_held(f_held):
                    tb.decode_step(model, start, {"tokens": steps[:, :1]}, impl="auto")
            else:
                fresh = tb.init_caches(2, 12 + 8, device="cpu", **kw)
                with chip_smoke._attention_as(chip_smoke._all_causal), \
                        chip_smoke._attention_held(f_held):
                    tb.prefill(model, fresh, {"tokens": tok, **batch}, impl="auto")
    n_prefill = cfg.n_layers if vlm else cfg.n_enc_layers + 2 * cfg.n_layers
    n_step = cfg.n_layers if vlm else 2 * cfg.n_layers
    att = chip_smoke._held_summary(held)
    assert len(out) == 1 + steps.shape[1]
    assert att["prefill"]["calls"] == n_prefill
    assert att["decode"]["calls"] == n_step * steps.shape[1]
    assert att["prefill"]["ratio"] == att["decode"]["ratio"] == 0.0
    assert chip_smoke._held_summary(f_held)["decode" if vlm else "prefill"]["ratio"] > 1.0
