"""Context-parallel attention (``heads_mode="seq"``) and the sequence-split
decode cache on gloo ranks on the CPU, held against the port's one-device
paths and the reference's one-device paths (its sharded step is no oracle
under jax 0.9). Every model starts from the reference's weights
(``convert.params_from_tree``, then ``tensor_parallel.shard_model``).

One spawn of 4 ranks (tests/torch_tp_ranks.py, every copy through host
mailboxes as ranks sharing a card send them) runs smoke gemma2 variants
whose query heads do not divide the model ranks:

  * context-parallel training (the plan of ``make_plan(...,
    heads_mode="seq")``): 6 query heads over (data 1, model 4) with a local
    window of 4 (a chunk of 8 rows longer than the window), 3 heads over
    (2, 2) with a window of 24 (longer than a chunk of 16), an uneven
    sequence (30 rows over 4 ranks: 8, 8, 8, 6) and a sequence shorter
    than the ranks' chunks (6 rows: 2, 2, 2 and an empty chunk); each
    against the port's and the reference's one-device step at
    microbatches = data ranks within tests/test_torch_tp.py's bounds, a
    repeat bitwise, every replicated leaf (the norms, and the whole ``wk``
    / ``wv`` of 3 heads) bitwise equal across the model ranks;
  * serving with the caches by the decode cell's plan (the sequence split
    over "model", at batch 1 over ("data", "model")): a context-parallel
    prefill of an uneven prompt (38 rows over 4 ranks), the smoke gemma2 (4
    query heads a rank's share, 2 kv heads whole: q gathered along heads),
    3 heads at (2, 2) (rows over the data ranks, the attention replicated)
    and 2 heads with one kv head at batch 1 over (2, 2); the prefill, one
    compression (each rank gathers its layer whole, compresses it as one
    device does and keeps its slice) and forced decode steps (each rank's
    slots through K5's lse entry, the ranks merged in rank order) within
    ``lm_parity``'s limits of the port's and the reference's one device;
    each rank's compressed slots >= 0.999 equal to its slice of the
    one-device compression of the ranks' raw caches put together.

Without processes: every arch's ``cache_specs`` equals the reference's at
1, 4 and 16 model ranks for the decode, batch-1 decode and prefill cells;
the lse entry's plain version against the reference's Pallas kernel's m
and l (interpret mode, as the reference's own tests run it) and against
K5's plain version; the merge of key ranges equal to one call over all of
them, a fully masked range weighing nothing.
"""
import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_tp_ranks as tpr

from repro.configs import ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import smoke_config as j_smoke_config
from repro.configs.base import ParallelConfig as JParallelConfig
from repro.data import make_batch as j_make_batch
from repro.launch.mesh import make_plan as j_make_plan
from repro.models import build as j_build
from repro.models.transformer import ShardingPlan as JShardingPlan
from repro.serve.kv_compression import compress_model_caches as j_compress_model_caches
from repro.train import OptConfig as JOptConfig
from repro.train import init_opt_state as j_init_opt
from repro.train import make_train_step as j_make_train_step
from repro.train.train_step import make_loss_fn as j_make_loss_fn
from repro.utils.tree import tree_flatten_with_paths as j_flatten
from repro_torch.configs import ARCHS, SHAPES, smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch.mesh import MeshShape, make_plan
from repro_torch.models import build
from repro_torch.utils.tree import tree_flatten_with_paths
from test_torch_specs import _same_cache_specs
from test_torch_tp import (
    LOGIT_ULPS,
    MIN_SLOTS,
    MIN_TOP1,
    _check_train,
    _slot_agreement,
    bf16_ulp,
)

torch.set_num_threads(1)

#: seconds the spawn may take, start-up of every rank included
LIMIT_S = 150.0
#: smoke gemma2 variants: (query heads, kv heads, local window)
VARIANTS = {"cp6": dict(n_heads=6, n_kv_heads=2, local_window=4),
            "cp3": dict(n_heads=3, n_kv_heads=1, local_window=24),
            "gemma2": {},
            "one_kv": dict(n_heads=2, n_kv_heads=1)}
STEPS = 2
#: (mesh, variant, sequence) of every context-parallel train run
TRAIN_RUNS = [((1, 4), "cp6", 32), ((2, 2), "cp3", 32), ((1, 4), "cp6", 30),
              ((1, 4), "cp3", 6)]
#: (mesh, variant, batch, prompt, prefill mode) of every serve run, its
#: caches by the decode cell's plan
SERVE_RUNS = [((1, 4), "cp6", 4, 38, "seq"), ((1, 4), "gemma2", 4, 40, "auto"),
              ((2, 2), "cp3", 4, 40, "auto"), ((2, 2), "one_kv", 1, 40, "auto")]


def _cfg(name):
    return dataclasses.replace(smoke_config(ARCHS["gemma2-2b"]), **VARIANTS[name])


def _jcfg(name):
    return dataclasses.replace(j_smoke_config(J_ARCHS["gemma2-2b"]), **VARIANTS[name])


def _data_ranks(shape):
    return int(np.prod(shape[:-1]))


@pytest.fixture(scope="module")
def trees():
    return {v: jax.tree_util.tree_map(np.asarray,
                                      j_build(_jcfg(v)).init(jax.random.PRNGKey(0)))
            for v in VARIANTS}


# ------------------------------------------------------------- the reference
def _reference_train(name, tree, d, seq):
    """The reference's jitted step at microbatches ``d`` (b 8, s ``seq``):
    every step's metrics, its loss's step-0 gradient (the microbatches'
    mean) and the final weights, by reference path."""
    jcfg = _jcfg(name)
    jb = j_build(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    opt = j_init_opt(params)
    step = jax.jit(j_make_train_step(jb, JOptConfig(**tpr.SCHED),
                                     JParallelConfig(microbatches=d)))
    loss_fn = j_make_loss_fn(jb, JShardingPlan(), "xla", "none")
    grad = jax.jit(jax.grad(lambda p, batch: loss_fn(p, batch)[0]))
    mets, grads0 = [], None
    for s in range(STEPS):
        batch = j_make_batch(jcfg, J_SHAPES["train_4k"], s, batch_override=tpr.B,
                             seq_override=seq)
        if s == 0:
            n = tpr.B // d
            each = [grad(params, jax.tree_util.tree_map(
                lambda x, i=i: x[i * n:(i + 1) * n], batch)) for i in range(d)]
            grads0 = dict(j_flatten(jax.tree_util.tree_map(
                np.asarray, jax.tree_util.tree_map(lambda *g: sum(g) / d, *each))))
        params, opt, m = step(params, opt, batch)
        mets.append({k: float(v) for k, v in m.items()})
    return dict(mets=mets, grads0=grads0,
                params=dict(j_flatten(jax.tree_util.tree_map(np.asarray, params))))


def _reference_route(name, tree, batch, prompt):
    """The reference's prefill, compression and forced decode steps of the
    serve job's prompts: the last position's logits of each (b, vocab)."""
    jcfg = _jcfg(name)
    jb = j_build(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    prompts, forced, _ = tpr.serve_inputs(_cfg(name), batch, prompt)
    S = tpr.SERVE
    prefill = jax.jit(functools.partial(jb.prefill, impl="xla"))
    decode = jax.jit(functools.partial(jb.decode_step, impl="xla"))
    caches = jb.init_caches(batch, prompt + S["steps"])
    logits, caches = prefill(params, caches, {"tokens": jnp.asarray(prompts, jnp.int32)})
    out = [np.asarray(logits[:, -1], np.float32)]
    caches = j_compress_model_caches(caches, S["t"], S["m"], tail=S["tail"], impl="ref")
    for i in range(S["steps"]):
        logits, caches = decode(params, caches,
                                {"tokens": jnp.asarray(forced[:, i:i + 1], jnp.int32)})
        out.append(np.asarray(logits[:, -1], np.float32))
    return out


def _reference_oracles(trees):
    out = {}
    for shape, name, seq in TRAIN_RUNS:
        key = ("train", _data_ranks(shape), name, seq)
        if key not in out:
            out[key] = _reference_train(name, trees[name], key[1], seq)
    for _, name, batch, prompt, _ in SERVE_RUNS:
        out[("serve", name, batch, prompt)] = _reference_route(name, trees[name], batch,
                                                               prompt)
    return out


@pytest.fixture(scope="module")
def reference(trees):
    """The reference's oracles, computed in a thread while the ranks run."""
    pool = ThreadPoolExecutor(1)
    yield pool.submit(_reference_oracles, trees)
    pool.shutdown()


@pytest.fixture(scope="module")
def one_device(trees):
    out = {}
    for shape, name, seq in TRAIN_RUNS:
        key = ("train", _data_ranks(shape), name, seq)
        if key not in out:
            out[key] = tpr.train_run(_cfg(name), trees[name], STEPS, microbatches=key[1],
                                     seq=seq)
    for _, name, batch, prompt, _ in SERVE_RUNS:
        out[("serve", name, batch, prompt)] = tpr.forced_route(
            _cfg(name), trees[name], batch=batch, prompt=prompt)
    return out


@pytest.fixture(scope="module")
def ranks(trees, reference, one_device, tmp_path_factory):
    """The one spawn of 4 ranks: each train run twice (the repeat) under
    the ``heads_mode="seq"`` plan, then each serve run."""
    jobs = []
    for shape, name, seq in TRAIN_RUNS:
        first = dict(shape=shape, cfg=_cfg(name), tree=trees[name], kind="train",
                     steps=STEPS, seq=seq, heads_mode="seq", tag=("train", name, seq))
        jobs += [first, dict(first, tag=("repeat", name, seq))]
    for shape, name, batch, prompt, mode in SERVE_RUNS:
        jobs.append(dict(shape=shape, cfg=_cfg(name), tree=trees[name], kind="serve",
                         batch=batch, prompt=prompt, layout=True, prefill_mode=mode,
                         tag=("serve", name, batch, prompt)))
    jobs[0]["mailboxes"] = (str(tmp_path_factory.mktemp("boxes")), 1 << 16)
    outs = port_mesh.spawn_ranks(tpr.tp_jobs, 4, backend="gloo", device="cpu",
                                 init_dir=str(tmp_path_factory.mktemp("cp")),
                                 args=(jobs,), timeout=LIMIT_S)
    got = {}
    for r, rank_outs in enumerate(outs):
        for job, res in zip(jobs, rank_outs, strict=True):
            assert res["rank"] == r
            got.setdefault((tuple(job["shape"]),) + job["tag"], []).append(res)
    return got


def _by_path(named: dict, name) -> dict:
    return {path: np.stack(parts) if len(parts) > 1 else parts[0]
            for path, parts in tree_flatten_with_paths(named, cfg=_cfg(name))}


def _port_run(run: dict, name) -> dict:
    return dict(mets=run["mets"], grads0=_by_path(run["grads0"], name),
                params=_by_path(run["params"], name))


# ------------------------------------------------------------- training
@pytest.mark.parametrize("shape,name,seq", TRAIN_RUNS)
def test_context_parallel_step_within_the_train_bounds(ranks, one_device, reference,
                                                       shape, name, seq):
    """Against the port's one-device step at microbatches = data ranks
    (tests/test_torch_train.py's bounds)."""
    key = ("train", _data_ranks(shape), name, seq)
    want = _port_run(one_device[key], name)
    grads_ref = reference.result()[key]["grads0"]
    for o in ranks[(shape, "train", name, seq)]:
        # every attention layer of every forward context-parallel (the remat's
        # recompute included)
        assert o["context_parallel"] == 2 * STEPS * _cfg(name).n_layers, o["rank"]
        _check_train(_port_run(o, name), want, grads_ref, name, ("rank", o["rank"]))


@pytest.mark.parametrize("shape,name,seq", TRAIN_RUNS)
def test_context_parallel_step_within_the_reference_bounds(ranks, one_device, reference,
                                                           shape, name, seq):
    """Against the reference's jitted one-device step and its loss's
    step-0 gradient; the port's one-device step too."""
    key = ("train", _data_ranks(shape), name, seq)
    want = reference.result()[key]
    _check_train(_port_run(one_device[key], name), want, want["grads0"], name,
                 "one device", lr_ulps=1)
    for o in ranks[(shape, "train", name, seq)]:
        _check_train(_port_run(o, name), want, want["grads0"], name, ("rank", o["rank"]),
                     lr_ulps=1)


@pytest.mark.parametrize("shape,name,seq", TRAIN_RUNS)
def test_context_parallel_step_is_bitwise_on_repeat_and_across_ranks(ranks, shape, name,
                                                                     seq):
    runs, again = ranks[(shape, "train", name, seq)], ranks[(shape, "repeat", name, seq)]
    for a, b in zip(runs, again, strict=True):
        assert a["mets"] == b["mets"]
        for n, p in a["params"].items():
            assert p.tobytes() == b["params"][n].tobytes(), n
    for o in runs:
        assert o["mets"] == runs[0]["mets"]
        for n, p in o["replicated"].items():
            assert p.tobytes() == runs[0]["replicated"][n].tobytes(), (o["rank"], n)
        for n, p in o["params"].items():
            assert p.tobytes() == runs[0]["params"][n].tobytes(), (o["rank"], n)
    assert runs[0]["replicated"]


# ------------------------------------------------------------- serving
def _whole_raw(outs, cfg, batch, prompt):
    """Every rank's raw prefill caches put together: the whole batch, every
    kv head, every slot (cut to the logical prompt + steps)."""
    first = outs[0]["raw"]
    layers = []
    for l, c in enumerate(first["layers"]):
        width = max(sum(o["raw"]["layers"][l]["slots"]) for o in outs)
        shape = (batch, cfg.n_kv_heads, width, cfg.head_dim)
        whole = {k: torch.zeros(shape, dtype=torch.bfloat16) for k in ("k", "v")}
        for o in outs:  # bf16 values widened to f32 by the ranks: exact
            oc = o["raw"]["layers"][l]
            a, n = oc["slots"]
            sl = (slice(*o["rows"]), slice(*o["heads"]) if o["heads"] else slice(None),
                  slice(a, a + n))
            for k in ("k", "v"):
                whole[k][sl] = torch.from_numpy(oc[k]).bfloat16()
        total = prompt + tpr.SERVE["steps"]
        layers.append({k: t[:, :, :total] for k, t in whole.items()} | {"pos": c["pos"]})
    return dict(first, layers=layers)


def _slices(caches, outs_caches):
    """The one-device compressed caches cut to a rank's slots (each layer's
    padded to the rank's slice count)."""
    out = []
    for c, mine in zip(caches, outs_caches, strict=True):
        first, n = mine["slots"] if mine["slots"] else (0, c["k"].shape[2])
        cut = {}
        for k in ("k", "v", "mass"):
            t = c[k]
            pad = first + n - t.shape[2]
            if pad > 0:
                fill = torch.ones if k == "mass" else torch.zeros
                t = torch.cat([t, fill(t.shape[:2] + (pad,) + t.shape[3:], dtype=t.dtype)],
                              dim=2)
            cut[k] = t[:, :, first:first + n]
        out.append(cut | {"pos": c["pos"]})
    return out


@pytest.mark.parametrize("shape,name,batch,prompt,mode", SERVE_RUNS)
def test_sequence_split_server_within_lm_parity_limits(ranks, one_device, shape, name,
                                                       batch, prompt, mode):
    """The prefill's and each forced step's logits within lm_parity's limits
    of one device; each rank's compressed slots its slice of the
    one-device compression of the ranks' raw caches put together."""
    from repro_torch.serve.kv_compression import compress_model_caches

    want = one_device[("serve", name, batch, prompt)]
    outs = ranks[(shape, "serve", name, batch, prompt)]
    S = tpr.SERVE
    together = compress_model_caches(_whole_raw(outs, _cfg(name), batch, prompt), S["t"],
                                     S["m"], tail=S["tail"])["layers"]
    n_layers = _cfg(name).n_layers
    for o in outs:
        assert all(c["slots"] is not None for c in o["caches"])  # split along the slots
        assert o["merges"] == S["steps"] * n_layers  # every decode step merged the ranks
        assert o["context_parallel"] == (n_layers if mode == "seq" else 0)
        top1 = []
        for i, (g, w) in enumerate(zip(o["logits"], want["logits"], strict=True)):
            assert g.shape == w.shape and np.isfinite(g).all()
            bound = LOGIT_ULPS * bf16_ulp(float(np.abs(w).max()))
            assert float(np.abs(g - w).max()) <= bound, (i, float(np.abs(g - w).max()))
            top1 += list(g.argmax(-1) == w.argmax(-1))
        assert np.mean(top1) >= MIN_TOP1, np.mean(top1)
        mine = _slices(together, o["caches"])
        assert _slot_agreement(o["caches"], mine, o["rows"], o["heads"]) >= MIN_SLOTS


@pytest.mark.parametrize("shape,name,batch,prompt,mode", SERVE_RUNS)
def test_sequence_split_server_within_lm_parity_limits_of_the_reference(
        ranks, one_device, reference, shape, name, batch, prompt, mode):
    want = reference.result()[("serve", name, batch, prompt)]
    runs = [("one device", one_device[("serve", name, batch, prompt)]["logits"])]
    runs += [(("rank", o["rank"]), o["logits"])
             for o in ranks[(shape, "serve", name, batch, prompt)]]
    for what, logits in runs:
        top1 = []
        for i, (g, w) in enumerate(zip(logits, want, strict=True)):
            assert g.shape == w.shape and np.isfinite(g).all(), (what, i)
            err = float(np.abs(g - w).max())
            assert err <= LOGIT_ULPS * bf16_ulp(float(np.abs(w).max())), (what, i, err)
            top1 += list(g.argmax(-1) == w.argmax(-1))
        assert np.mean(top1) >= MIN_TOP1, (what, np.mean(top1))


# ------------------------------------------------------------- no processes
@pytest.mark.parametrize("tp", [1, 4, 16])
@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_cache_specs_equal_the_references_at_every_layout(arch, tp):
    """Every arch's cache specs at ``tp`` model ranks (2 data ranks) for
    the decode cell, the batch-1 decode cell and the prefill cell, both
    heads modes: the reference's (the port's caches follow them,
    ``tensor_parallel.cache_layout``)."""
    mesh = MeshShape(("data", "model"), (2, tp))
    ref_mesh = SimpleNamespace(axis_names=mesh.mesh_dim_names,
                               shape=dict(zip(mesh.mesh_dim_names, mesh.sizes)))
    cfg, jcfg = ARCHS[arch], J_ARCHS[arch]
    jb, bundle = j_build(jcfg), build(cfg)
    for shape_name in ("decode_32k", "long_500k", "prefill_32k"):
        for mode in ("auto", "seq"):
            want = j_make_plan(jcfg, J_SHAPES[shape_name], ref_mesh, heads_mode=mode)
            got = make_plan(cfg, SHAPES[shape_name], mesh, heads_mode=mode)
            _same_cache_specs(cfg, jb.cache_specs(want, tp_size=tp),
                              bundle.cache_specs(got, tp_size=tp))


def _pallas_m_l(q, k, v, bias, *, causal, scale, softcap):
    """The reference's ``_flash_kernel`` run in interpret mode as its
    wrapper runs it (q, k, v with the heads matched), returning the m and
    l its wrapper drops: (b, h, lq) each."""
    from jax.experimental import pallas as pl

    from repro.kernels.flash_attention import _flash_kernel

    bsz, h, lq, dh = q.shape
    lk = k.shape[2]
    bq, bk = min(128, max(lq, 8)), min(128, max(lk, 8))
    pq, pk = (-lq) % bq, (-lk) % bk
    dpad = (-dh) % 128 if dh > 128 else (128 - dh)
    qp = jnp.pad(q, ((0, 0), (0, 0), (0, pq), (0, dpad))).reshape(bsz * h, lq + pq, -1)
    kp = jnp.pad(k, ((0, 0), (0, 0), (0, pk), (0, dpad))).reshape(bsz * h, lk + pk, -1)
    vp = jnp.pad(v, ((0, 0), (0, 0), (0, pk), (0, dpad))).reshape(bsz * h, lk + pk, -1)
    bp = jnp.pad(bias, ((0, 0), (0, 0), (0, pk)), constant_values=-1e30).reshape(
        bsz * h, lk + pk)
    kernel = functools.partial(_flash_kernel, scale=scale, causal=causal,
                               softcap=float(softcap), lq=lq, lk=lk, bq=bq, bk=bk)
    width = dh + dpad
    _, m, l = pl.pallas_call(
        kernel, grid=(bsz * h, (lq + pq) // bq, (lk + pk) // bk),
        in_specs=[pl.BlockSpec((1, bq, width), lambda b, i, j: (b, i, 0)),
                  pl.BlockSpec((1, bk, width), lambda b, i, j: (b, j, 0)),
                  pl.BlockSpec((1, bk, width), lambda b, i, j: (b, j, 0)),
                  pl.BlockSpec((1, bk), lambda b, i, j: (b, j))],
        out_specs=[pl.BlockSpec((1, bq, width), lambda b, i, j: (b, i, 0)),
                   pl.BlockSpec((1, bq), lambda b, i, j: (b, i)),
                   pl.BlockSpec((1, bq), lambda b, i, j: (b, i))],
        out_shape=[jax.ShapeDtypeStruct((bsz * h, lq + pq, width), jnp.float32),
                   jax.ShapeDtypeStruct((bsz * h, lq + pq), jnp.float32),
                   jax.ShapeDtypeStruct((bsz * h, lq + pq), jnp.float32)],
        interpret=True)(qp, kp, vp, bp)
    m = np.asarray(m)[:, :lq].reshape(bsz, h, lq)
    l = np.asarray(l)[:, :lq].reshape(bsz, h, lq)
    return m, l


@pytest.mark.parametrize("case", ["decode_bias", "decode_masked_tail", "causal_softcap"])
def test_lse_entry_plain_version_against_the_pallas_m_and_l(case):
    """``flash_attention_lse_plain``'s lse against m + log l of the
    reference's Pallas kernel (interpret mode) on the same inputs (GQA: the
    kv heads repeated for the reference, as its ops.py does), and its
    output against K5's plain version, f32."""
    rng = np.random.default_rng({"decode_bias": 1, "decode_masked_tail": 2,
                                 "causal_softcap": 3}[case])
    b, hq, hkv, dh = 2, 4, 2, 32
    lq, lk = (1, 200) if case != "causal_softcap" else (4, 70)
    q = rng.standard_normal((b, hq, lq, dh)).astype(np.float32)
    k = rng.standard_normal((b, hkv, lk, dh)).astype(np.float32)
    v = rng.standard_normal((b, hkv, lk, dh)).astype(np.float32)
    bias = (0.3 * rng.standard_normal((b, hkv, lk))).astype(np.float32)
    if case == "decode_masked_tail":  # the slots past the decode position
        bias[:, :, 150:] = -1e30
    causal = case == "causal_softcap"
    softcap = 50.0 if causal else 0.0
    scale = dh ** -0.5
    o, lse = fa.flash_attention_lse_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(bias), causal=causal, scale=scale, logit_softcap=softcap)
    rep = hq // hkv
    m, l = _pallas_m_l(jnp.asarray(q), jnp.asarray(np.repeat(k, rep, 1)),
                       jnp.asarray(np.repeat(v, rep, 1)),
                       jnp.asarray(np.repeat(bias, rep, 1)), causal=causal, scale=scale,
                       softcap=softcap)
    want = m + np.log(l)
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)
    plain = fa.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(bias), causal=causal, scale=scale, logit_softcap=softcap)
    np.testing.assert_allclose(o.numpy(), plain.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("parts", [2, 4, 5])
def test_the_merge_of_key_ranges_is_one_call_over_all_of_them(parts):
    """Keys split into ``parts`` contiguous ranges (the last one masked past
    the decode position: lse −inf, weight 0, no NaN): the rank-order merge
    of the ranges' (o, lse) equals one call over every key (f32)."""
    rng = np.random.default_rng(parts)
    b, hq, hkv, dh, lk = 2, 8, 2, 64, 40
    q = torch.from_numpy(rng.standard_normal((b, hq, 1, dh)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((b, hkv, lk, dh)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, hkv, lk, dh)).astype(np.float32))
    bias = torch.zeros((b, hkv, lk))
    bias[:, :, 29:] = -1e30  # decode position 28
    whole, whole_lse = fa.flash_attention_lse_plain(q, k, v, bias, causal=False,
                                                    logit_softcap=50.0)
    per = -(-lk // parts)
    got = [fa.flash_attention_lse_plain(q, k[:, :, a:a + per], v[:, :, a:a + per],
                                        bias[:, :, a:a + per], causal=False,
                                        logit_softcap=50.0)
           for a in range(0, lk, per)]
    if parts >= 4:
        assert torch.isinf(got[-1][1]).all()  # every slot of the last range masked
    merged = fa.merge_lse(torch.stack([o for o, _ in got]),
                          torch.stack([lse for _, lse in got]))
    assert torch.isfinite(merged).all()
    torch.testing.assert_close(merged, whole, rtol=1e-5, atol=1e-6)
    nothing = fa.merge_lse(torch.zeros(3, 2, dh), torch.full((3, 2), -torch.inf))
    assert torch.equal(nothing, torch.zeros(2, dh))  # no part sees a key: 0, not NaN
    assert torch.isfinite(whole_lse).all()


@pytest.mark.parametrize("cap", [64, 1 << 29])
def test_rank_sum_in_pieces_is_the_same_sum(cap, monkeypatch):
    """``rank_sum`` gathers a tensor past RANK_SUM_BYTES of every rank's
    copies in pieces: each element is the same rank-order sum, so the bits
    do not depend on the cap."""
    from repro_torch.models import tensor_parallel

    class Ranks:  # three ranks' tensors: t, 2t and 3t, in rank order
        size, index = 3, 0

        def gather_rows(self, x):
            return torch.cat([x, x * 2, x * 3])

    t = torch.from_numpy(np.random.default_rng(0).standard_normal((5, 7), np.float32))
    monkeypatch.setattr(tensor_parallel, "RANK_SUM_BYTES", cap)
    for dt in (torch.float32, torch.bfloat16):
        x = t.to(dt)
        want = ((x.float() + x.float() * 2) + x.float() * 3).to(dt)
        got = tensor_parallel.rank_sum(x, Ranks())
        assert got.dtype == dt and torch.equal(got, want)


@pytest.mark.parametrize("hq,hkv,bias_heads", [(48, 1, 48), (48, 1, 1), (12, 2, 2)])
def test_lse_entry_takes_many_query_heads_a_kv_head_in_groups(hq, hkv, bias_heads):
    """More query heads a kv head than the split-kv route packs (granite's
    48 over one kv head on a sequence-split cache): the entry runs them in
    groups, each row's result that of one call over every head."""
    rng = np.random.default_rng(hq + hkv)
    q = torch.from_numpy(rng.standard_normal((2, hq, 1, 32), np.float32))
    k = torch.from_numpy(rng.standard_normal((2, hkv, 50, 32), np.float32))
    v = torch.from_numpy(rng.standard_normal((2, hkv, 50, 32), np.float32))
    bias = torch.from_numpy(rng.standard_normal((2, bias_heads, 50), np.float32))
    bias[..., 40:] = -1e30
    o, lse = fa.flash_attention_lse(q, k, v, bias, causal=False, logit_softcap=30.0)
    want, want_lse = fa.flash_attention_lse_plain(q, k, v, bias, causal=False,
                                                  logit_softcap=30.0)
    assert torch.equal(o, want) and torch.equal(lse, want_lse)
