"""The port's optimizer, int8 quantization and parameter-tree map
(``repro_torch.train.optimizer``, ``train.compression``, ``utils.tree``)
against the JAX package's, fed the same numpy inputs.

Tolerances. ``lr_at``: within one f32 ulp (XLA rewrites a division by a
constant into a product with its reciprocal, which may round the other
way). ``adamw_update`` on identical grads: rtol 1e-6 (``b1 ** step`` in
XLA's f32 ``pow`` and PyTorch's may differ by an ulp, and XLA may
contract a product and a sum into an fma); bf16 parameters cast from the
f32 master: within one bf16 ulp. Quantization: bitwise. The tree map:
exact (paths, order, values).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import smoke_config as j_smoke_config
from repro.models import build as j_build
from repro.train.compression import dequantize_int8 as j_dequantize
from repro.train.compression import quantize_int8 as j_quantize
from repro.train.optimizer import OptConfig as JOptConfig
from repro.train.optimizer import adamw_update as j_adamw
from repro.train.optimizer import init_opt_state as j_init_opt
from repro.train.optimizer import lr_at as j_lr_at
from repro.utils.tree import global_norm as j_global_norm
from repro.utils.tree import tree_flatten_with_paths as j_flatten
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.models.convert import opt_state_from_tree, params_from_tree
from repro_torch.train.compression import dequantize_int8, quantize_int8
from repro_torch.train.optimizer import (
    OptConfig,
    adamw_update,
    init_opt_state,
    lr_at,
)
from repro_torch.utils import tree

SCHEDULES = [dict(peak_lr=3e-4, warmup_steps=5, decay_steps=60),
             dict(peak_lr=1e-3, min_lr=1e-4, warmup_steps=10, decay_steps=110),
             dict(peak_lr=1e-2, warmup_steps=100, decay_steps=1000)]


def _np(tree_):
    return jax.tree_util.tree_map(np.asarray, tree_)


def _f32_ulps(a, b):
    a, b = np.float32(a), np.float32(b)
    return abs(float(a) - float(b)) / float(np.spacing(max(abs(a), abs(b), np.float32(1e-30))))


@pytest.mark.parametrize("sched", SCHEDULES, ids=lambda s: f"warm{s['warmup_steps']}")
def test_lr_at_matches_reference(sched):
    for step in (0, 1, 2, 3, 4, 5, 6, 9, 10, 11, 30, 59, 60, 61, 99, 100, 101,
                 110, 500, 999, 1000, 5000):
        want = float(j_lr_at(JOptConfig(**sched), jnp.asarray(step)))
        got = float(lr_at(OptConfig(**sched), torch.tensor(step)))
        assert _f32_ulps(got, want) <= 1, (step, got, want)


def test_lr_schedule_shape():
    cfg = OptConfig(peak_lr=1e-3, min_lr=1e-4, warmup_steps=10, decay_steps=110)
    lrs = [float(lr_at(cfg, torch.tensor(s))) for s in (0, 5, 10, 60, 110, 500)]
    assert lrs[0] == 0.0
    assert abs(lrs[1] - 5e-4) < 1e-9          # linear warmup
    assert abs(lrs[2] - 1e-3) < 1e-6          # peak
    assert lrs[3] < lrs[2] and lrs[4] < lrs[3]
    assert abs(lrs[4] - 1e-4) < 1e-6          # floor
    assert abs(lrs[5] - 1e-4) < 1e-6


def _np_adamw(p, g, m, v, step, cfg):
    gn = np.sqrt((g ** 2).sum())
    g = g * min(1.0, cfg.clip_norm / max(gn, 1e-12))
    m = cfg.b1 * m + (1 - cfg.b1) * g
    v = cfg.b2 * v + (1 - cfg.b2) * g ** 2
    mh = m / (1 - cfg.b1 ** step)
    vh = v / (1 - cfg.b2 ** step)
    lr = cfg.peak_lr * step / cfg.warmup_steps  # warm-up phase
    return p - lr * (mh / (np.sqrt(vh) + cfg.eps) + cfg.weight_decay * p), m, v


def test_adamw_matches_numpy_reference(rng):
    cfg = OptConfig(peak_lr=1e-2, warmup_steps=100, decay_steps=1000)
    p = rng.normal(size=(13,)).astype(np.float32)
    g = rng.normal(size=(13,)).astype(np.float32)
    params = {"w": torch.from_numpy(p.copy())}
    opt = init_opt_state(params)
    got, opt, mets = adamw_update({"w": torch.from_numpy(g)}, opt, params, cfg)
    want, _, _ = _np_adamw(p, g, np.zeros(13), np.zeros(13), 1, cfg)
    np.testing.assert_allclose(got["w"].numpy(), want, rtol=1e-5, atol=1e-6)
    assert abs(float(mets["grad_norm"]) - np.sqrt((g ** 2).sum())) < 1e-4
    assert int(opt["step"]) == 1


@pytest.mark.parametrize("master", [False, True])
def test_adamw_update_matches_reference(rng, master):
    """Three updates of a three-leaf tree on identical grads (the second a
    large one, so the clip scale acts)."""
    shapes = {"a": (7, 5), "b": (11,), "c": (3, 4, 2)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * sc).astype(np.float32)
              for k, s in shapes.items()} for sc in (0.3, 5.0, 0.05)]
    cfg = dict(peak_lr=1e-2, warmup_steps=2, decay_steps=10, weight_decay=0.1)
    dt, jdt = (torch.bfloat16, jnp.bfloat16) if master else (torch.float32, jnp.float32)
    jp = {k: jnp.asarray(v, jdt) for k, v in p0.items()}
    jo = j_init_opt(jp, master=master)
    tp = {k: torch.from_numpy(v).to(dt) for k, v in p0.items()}
    to = init_opt_state(tp, master=master)
    for g in grads:
        jp, jo, jm = j_adamw({k: jnp.asarray(v) for k, v in g.items()}, jo, jp,
                             JOptConfig(**cfg))
        tp, to, tm = adamw_update({k: torch.from_numpy(v) for k, v in g.items()},
                                  to, tp, OptConfig(**cfg))
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-6)
        assert _f32_ulps(float(tm["lr"]), float(jm["lr"])) <= 1
        for k in shapes:
            for part in ("m", "v") + (("master",) if master else ()):
                np.testing.assert_allclose(to[part][k].numpy(), np.asarray(jo[part][k]),
                                           rtol=1e-6, atol=1e-12, err_msg=f"{part}/{k}")
            got = tp[k].float().numpy()
            want = np.asarray(jp[k].astype(jnp.float32))
            if master:  # one bf16 ulp of the master's cast
                np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=0)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    assert int(to["step"]) == int(jo["step"]) == 3


@pytest.mark.parametrize("seed", range(4))
def test_int8_quantization_matches_reference_bitwise(seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(257,)) * 3.7 * 10 ** rng.uniform(-3, 3)).astype(np.float32)
    q, s = quantize_int8(torch.from_numpy(x))
    jq, js = j_quantize(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert np.float32(s).view(np.uint32) == np.float32(js).view(np.uint32)
    back = dequantize_int8(q, s).numpy()
    np.testing.assert_array_equal(back.view(np.uint32),
                                  np.asarray(j_dequantize(jq, js)).view(np.uint32))


def test_int8_quantization_roundtrip(rng):
    x = torch.from_numpy((rng.normal(size=(256,)) * 3.7).astype(np.float32))
    q, s = quantize_int8(x)
    err = float(torch.max(torch.abs(dequantize_int8(q, s) - x)))
    assert err <= float(s) * 0.5 + 1e-6  # half-ULP of the int8 grid
    assert q.dtype == torch.int8


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_tree_paths_match_reference(arch):
    """The port's parameter names map onto the reference's leaf paths in
    the reference's flatten order, stacked leaves included, values equal;
    so do the optimizer moments, and the global norm agrees."""
    jcfg, cfg = j_smoke_config(J_ARCHS[arch]), smoke_config(ARCHS[arch])
    params = _np(jax.jit(j_build(jcfg).init)(jax.random.PRNGKey(0)))
    jopt = _np(j_init_opt(params))
    jopt["m"] = jax.tree_util.tree_map(lambda p: p * 0.5 + 1.0, params)
    model = params_from_tree(cfg, params, device="cpu", trainable=True)
    opt = opt_state_from_tree(model, jopt)
    for like, want in (({"params": model, "opt": opt}, {"params": params, "opt": jopt}),):
        got = tree.tree_flatten_with_paths(like)
        ref = j_flatten(want)
        assert [n for n, _ in got] == [n for n, _ in ref]
        for (name, parts), (_, leaf) in zip(got, ref, strict=True):
            arr = np.stack([p.detach().numpy() for p in parts]) if len(parts) > 1 \
                else parts[0].detach().numpy()
            np.testing.assert_array_equal(arr, np.asarray(leaf), err_msg=name)
    assert tree.tree_size(model) == sum(int(np.prod(x.shape))
                                        for x in jax.tree_util.tree_leaves(params))
    assert tree.tree_bytes(model) == 4 * tree.tree_size(model)
    got = float(tree.global_norm(dict(model.named_parameters()), cfg=cfg))
    np.testing.assert_allclose(got, float(j_global_norm(params)), rtol=1e-6)
    for name, _ in model.named_parameters():
        path, r = tree.param_path(cfg, name)
        assert name in dict(tree.param_layout(cfg, [name]))[path]
        assert (r is None) == (not path.startswith(("stack/", "enc/", "dec/")))


def test_adamw_slices_do_not_change_the_bits(rng, monkeypatch):
    """A parameter's update taken in slices (``optimizer.SLICE``) equals
    the whole-tensor update bit for bit, master copy included."""
    from repro_torch.train import optimizer

    shapes = {"layers.0.mlp.up": (37, 29), "layers.0.ln1": (29,), "embed.table": (5, 7, 3)}
    params = {n: torch.from_numpy(rng.normal(size=s).astype(np.float32)) for n, s in shapes.items()}
    grads = {n: torch.from_numpy(rng.normal(size=s).astype(np.float32)) for n, s in shapes.items()}
    runs = []
    for slice_len in (1 << 26, 7):
        monkeypatch.setattr(optimizer, "SLICE", slice_len)
        for master in (False, True):
            p = {n: t.clone() for n, t in params.items()}
            opt = init_opt_state(p, master=master)
            for _ in range(3):
                p, opt, mets = adamw_update(grads, opt, p, OptConfig(**SCHEDULES[0]))
            runs.append((p, opt))
    for (pa, oa), (pb, ob) in ((runs[0], runs[2]), (runs[1], runs[3])):
        for n in shapes:
            assert torch.equal(pa[n], pb[n]) and torch.equal(oa["m"][n], ob["m"][n])
            assert torch.equal(oa["v"][n], ob["v"][n])
            if "master" in oa:
                assert torch.equal(oa["master"][n], ob["master"][n])
