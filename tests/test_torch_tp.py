"""The model axis (tensor parallelism over "model") on gloo ranks on the CPU,
held against the port's one-device paths and against the reference's
one-device paths (its sharded step is no oracle under jax 0.9): its jitted
train step at microbatches = data ranks, its loss's gradient, and its
prefill, compression and decode steps. Every model starts from the
reference's weights (``convert.params_from_tree``, then
``tensor_parallel.shard_model``).

One spawn of 4 ranks (tests/torch_tp_ranks.py, every copy through host
mailboxes as ranks sharing a card send them) holds a (data 2, model 2),
a (data 1, model 4) mesh, for gemma2's split kv head (2 kv heads over 4
model ranks: ``wk`` gathered mid-head), and a (pod 2, data 1, model 2)
mesh (training only). The smoke gemma2, granite (one kv head), qwen
(QKV bias), phi-3-vision (the VLM: its patch prefix in the batches and
the prompts) and a 2-head gemma2 at (1, 4) (the attention replicated):

  * the step against the port's and the reference's one-device step at
    microbatches = data ranks, within tests/test_torch_train.py's bounds
    (loss and grad norm within 8 bf16 ulps; each step-0 gradient within 8
    bf16 ulps of its leaf's largest |g|; weights within 2·Σlr, and on
    average 0.1·Σlr over the elements whose step-0 gradient the reference
    fixes beyond that gradient bound: below it an element's first AdamW
    step, ±lr, may go either way, as it does in qwen's key bias, whose
    gradient vanishes up to rounding in the slowly rotating dimensions);
  * a repeat bitwise, and every replicated leaf bitwise equal across the
    model ranks;
  * a (2, 2) checkpoint restored on one device bitwise the gathered
    weights, and a one-device checkpoint restored on (2, 2) bitwise its
    slices;
  * prefill and decode with one compression against the port's and the
    reference's one device within ``lm_parity``'s limits (32 bf16 ulps of
    the largest |logit|, top-1 >= 0.9); each rank's compressed cache slots
    >= 0.999 equal to the one-device compression of the ranks' raw caches
    put together;
  * the model drawn from a seed on a mesh (each rank's slices, one whole
    leaf at a time) bitwise the one-device draw sliced.

Also: the launcher's ``--mesh debug`` goes on to start its ranks for the
MoE, Mamba and enc-dec families (tests/test_torch_ep.py and
tests/test_torch_encdec_tp.py run them), a ``heads_mode="seq"`` plan binds
to a context-parallel layout (tests/test_torch_cp.py runs it), and the
launcher's ``--mesh debug`` at ``--smoke --device cpu`` trains over 8
spawned ranks.
"""
import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

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
from repro.models import build as j_build
from repro.models.transformer import ShardingPlan as JShardingPlan
from repro.serve.kv_compression import compress_model_caches as j_compress_model_caches
from repro.train import OptConfig as JOptConfig
from repro.train import init_opt_state as j_init_opt
from repro.train import make_train_step as j_make_train_step
from repro.train.train_step import make_loss_fn as j_make_loss_fn
from repro.utils.tree import tree_flatten_with_paths as j_flatten
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import train as launcher
from repro_torch.models.tensor_parallel import model_dim, shard_params
from repro_torch.train import CheckpointManager
from repro_torch.utils.tree import tree_flatten_with_paths

torch.set_num_threads(1)

#: seconds a spawn may take, start-up of every rank included
LIMIT_S = 240.0
#: loss, grad norm and gradients (tests/test_torch_train.py)
GRAD_ULPS = 8
#: logits (chip_smoke.LOGIT_ULPS, MIN_TOP1), compressed slots
LOGIT_ULPS, MIN_TOP1, MIN_SLOTS = 32, 0.9, 0.999
ARCH_STEPS = {"gemma2-2b": 3, "granite-20b": 2, "qwen2.5-32b": 2,
              "phi-3-vision-4.2b": 2, "gemma2-2b-2heads": 2}
#: a smoke arch with other head counts: gemma2 with 2 query heads and one
#: kv head, whose query heads do not divide 4 model ranks (the replicated
#: attention, as gemma2-2b's 8 heads at tp 16)
VARIANTS = {"gemma2-2b-2heads": ("gemma2-2b", dict(n_heads=2, n_kv_heads=1))}
#: (mesh, arch) of every run: (data 2, model 2) for each smoke arch, (1, 4)
#: for gemma2 and its 2-head variant, (pod 2, data 1, model 2) for gemma2
#: (the data axis over ("pod", "data") then has a group per model index)
RUNS = ([((2, 2), a) for a in ARCH_STEPS if a not in VARIANTS]
        + [((1, 4), "gemma2-2b"), ((1, 4), "gemma2-2b-2heads"),
           ((2, 1, 2), "gemma2-2b")])
SERVE_RUNS = [r for r in RUNS if len(r[0]) == 2]


def _data_ranks(shape):
    return int(np.prod(shape[:-1]))


def bf16_ulp(x: float) -> float:
    return float(2.0 ** (np.floor(np.log2(abs(x))) - 7))


@pytest.fixture(scope="module")
def trees():
    """The reference's initial parameters of each smoke arch (numpy)."""
    out = {}
    for arch in ARCH_STEPS:
        base, kw = VARIANTS.get(arch, (arch, {}))
        jcfg = dataclasses.replace(j_smoke_config(J_ARCHS[base]), **kw)
        out[arch] = jax.tree_util.tree_map(np.asarray,
                                           j_build(jcfg).init(jax.random.PRNGKey(0)))
    return out


def _cfg(arch):
    base, kw = VARIANTS.get(arch, (arch, {}))
    return dataclasses.replace(smoke_config(ARCHS[base]), **kw)


def _jcfg(arch):
    base, kw = VARIANTS.get(arch, (arch, {}))
    return dataclasses.replace(j_smoke_config(J_ARCHS[base]), **kw)


# ------------------------------------------------------------- the reference
def _reference_train(arch, tree, d):
    """The reference's jitted step at microbatches ``d`` from ``tree``:
    every step's metrics, its loss's step-0 gradient (the microbatches'
    mean, as its step takes it) and the final weights, by reference path."""
    jcfg = _jcfg(arch)
    jb = j_build(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    opt = j_init_opt(params)
    step = jax.jit(j_make_train_step(jb, JOptConfig(**tpr.SCHED),
                                     JParallelConfig(microbatches=d)))
    loss_fn = j_make_loss_fn(jb, JShardingPlan(), "xla", "none")
    grad = jax.jit(jax.grad(lambda p, batch: loss_fn(p, batch)[0]))

    def grads(p, batch):
        n = tpr.B // d
        each = [grad(p, jax.tree_util.tree_map(lambda x: x[i * n:(i + 1) * n], batch))
                for i in range(d)]
        return jax.tree_util.tree_map(lambda *g: sum(g) / d, *each)

    mets, grads0 = [], None
    for s in range(ARCH_STEPS[arch]):
        batch = j_make_batch(jcfg, J_SHAPES["train_4k"], s, batch_override=tpr.B,
                             seq_override=tpr.S)
        if s == 0:
            grads0 = dict(j_flatten(jax.tree_util.tree_map(np.asarray,
                                                           grads(params, batch))))
        params, opt, m = step(params, opt, batch)
        mets.append({k: float(v) for k, v in m.items()})
    return dict(mets=mets, grads0=grads0,
                params=dict(j_flatten(jax.tree_util.tree_map(np.asarray, params))))


def _reference_route(arch, tree):
    """The reference's serving of SERVE's prompts (torch_tp_ranks.
    serve_inputs): prefill, one compression, the forced decode steps; the
    last position's logits of each (b, vocab)."""
    jcfg = _jcfg(arch)
    jb = j_build(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    prompts, forced, patches = tpr.serve_inputs(_cfg(arch))
    inputs = {} if patches is None else {"patch_embeds": jnp.asarray(patches,
                                                                      jnp.bfloat16)}
    prefill = jax.jit(functools.partial(jb.prefill, impl="xla"))
    decode = jax.jit(functools.partial(jb.decode_step, impl="xla"))
    S = tpr.SERVE
    caches = jb.init_caches(S["batch"], S["prompt"] + S["steps"])
    logits, caches = prefill(params, caches, {"tokens": jnp.asarray(prompts, jnp.int32),
                                              **inputs})
    out = [np.asarray(logits[:, -1], np.float32)]
    caches = j_compress_model_caches(caches, S["t"], S["m"], tail=S["tail"], impl="ref")
    for i in range(S["steps"]):
        logits, caches = decode(params, caches,
                                {"tokens": jnp.asarray(forced[:, i:i + 1], jnp.int32)})
        out.append(np.asarray(logits[:, -1], np.float32))
    return out


def _reference_oracles(trees):
    out = {}
    for shape, arch in RUNS:
        key = ("train", _data_ranks(shape), arch)
        if key not in out:
            out[key] = _reference_train(arch, trees[arch], key[1])
    for _, arch in SERVE_RUNS:
        out[("serve", arch)] = _reference_route(arch, trees[arch])
    return out


@pytest.fixture(scope="module")
def reference(trees):
    """The reference's oracles, computed in a thread while the ranks run
    (``reference.result()``)."""
    pool = ThreadPoolExecutor(1)
    yield pool.submit(_reference_oracles, trees)
    pool.shutdown()


def _by_path(named: dict, arch) -> dict:
    """{reference path: array} of a port model's arrays keyed by parameter
    name (the per-layer leaves stacked)."""
    return {path: np.stack(parts) if len(parts) > 1 else parts[0]
            for path, parts in tree_flatten_with_paths(named, cfg=_cfg(arch))}


def _check_train(got: dict, want: dict, grads_ref: dict, arch, what, *, lr_ulps=0,
                 grad_ulps=GRAD_ULPS, leaf_ulps=None):
    """A run's metrics, step-0 gradients and final weights (``got``, by
    reference path) within tests/test_torch_train.py's bounds of
    ``want``'s; the weights' mean over the elements whose reference step-0
    gradient (``grads_ref``) is beyond the gradient bound; the learning
    rate within ``lr_ulps`` f32 ulps (0: equal). ``grad_ulps``: the step-0
    gradients' bound (bf16 ulps of a leaf's largest |g|); ``leaf_ulps``:
    {reference path: bound} where one leaf takes another."""
    lr_sum = sum(m["lr"] for m in want["mets"])
    for s, (g, w) in enumerate(zip(got["mets"], want["mets"], strict=True)):
        for k in ("loss", "grad_norm"):
            assert abs(g[k] - w[k]) <= GRAD_ULPS * bf16_ulp(w[k]), (what, s, k)
        assert abs(g["lr"] - w["lr"]) <= lr_ulps * np.spacing(np.float32(w["lr"])), \
            (what, s)
        assert g["weight"] == w["weight"], (what, s)
    for path, g in want["grads0"].items():
        top = float(np.abs(g).max())
        err = float(np.abs(got["grads0"][path] - g).max())
        ulps = (leaf_ulps or {}).get(path, grad_ulps)
        assert err <= ulps * bf16_ulp(top) if top else err == 0.0, \
            (what, path, err, top)
    for path, p in want["params"].items():
        d = np.abs(got["params"][path] - p)
        assert d.max() <= 2 * lr_sum, (what, path, d.max())
        g = np.abs(grads_ref[path])
        top = float(g.max())
        fixed = g > GRAD_ULPS * bf16_ulp(top) if top else np.zeros(g.shape, bool)
        if fixed.any():
            assert d[fixed].mean() <= 0.1 * lr_sum, (what, path, d[fixed].mean())


def _port_run(run: dict, arch) -> dict:
    """A port run's output by reference path."""
    return dict(mets=run["mets"], grads0=_by_path(run["grads0"], arch),
                params=_by_path(run["params"], arch))


@pytest.fixture(scope="module")
def one_device(trees, tmp_path_factory):
    """The one-device oracles: each arch's train run at microbatches 2
    (gemma2 also at 1, for (1, 4)) and its forced route; a one-device
    checkpoint of gemma2 after its steps."""
    ckpt = str(tmp_path_factory.mktemp("one_ckpt"))
    out = {"ckpt": ckpt}
    for shape, arch in RUNS:
        d = _data_ranks(shape)
        if ("train", d, arch) not in out:
            out[("train", d, arch)] = tpr.train_run(
                _cfg(arch), trees[arch], ARCH_STEPS[arch], microbatches=d,
                ckpt_dir=ckpt if (d, arch) == (2, "gemma2-2b") else "")
        out[("serve", arch)] = tpr.forced_route(_cfg(arch), trees[arch])
    return out


#: (mesh, arch, trainable) of the seeded draws on a mesh
DRAWS = [((2, 2), "qwen2.5-32b", False), ((1, 4), "gemma2-2b", True),
         ((1, 4), "gemma2-2b-2heads", True)]


@pytest.fixture(scope="module")
def ranks(trees, reference, one_device, tmp_path_factory):
    """The one spawn of 4 ranks: each run's train job twice (the repeat)
    and its serve job; gemma2 on (2, 2) writes a checkpoint and restores
    the one-device one; the seeded draws of DRAWS."""
    ckpt = str(tmp_path_factory.mktemp("tp_ckpt"))
    jobs = []
    for shape, arch in RUNS:
        base = dict(shape=shape, cfg=_cfg(arch), tree=trees[arch], arch=arch)
        first = dict(base, kind="train", steps=ARCH_STEPS[arch], tag="train",
                     ckpt_dir=ckpt if (shape, arch) == ((2, 2), "gemma2-2b") else "")
        jobs += [first, dict(first, ckpt_dir="", tag="repeat")]
        if (shape, arch) in SERVE_RUNS:
            jobs.append(dict(base, kind="serve", tag="serve"))
    jobs.append(dict(shape=(2, 2), cfg=_cfg("gemma2-2b"), tree=trees["gemma2-2b"],
                     arch="gemma2-2b", kind="train", steps=ARCH_STEPS["gemma2-2b"], tag="restore",
                     restore_dir=one_device["ckpt"]))
    for shape, arch, trainable in DRAWS:
        jobs.append(dict(shape=shape, cfg=_cfg(arch), arch=arch, kind="init",
                         trainable=trainable, tag=f"init-{trainable}"))
    jobs[0]["mailboxes"] = (str(tmp_path_factory.mktemp("boxes")), 1 << 16)
    outs = port_mesh.spawn_ranks(tpr.tp_jobs, 4, backend="gloo", device="cpu",
                                 init_dir=str(tmp_path_factory.mktemp("tp")),
                                 args=(jobs,), timeout=LIMIT_S)
    got = {}
    for r, rank_outs in enumerate(outs):
        for job, res in zip(jobs, rank_outs, strict=True):
            assert res["rank"] == r
            key = (job["tag"], tuple(job["shape"]), job["arch"])
            got.setdefault(key, []).append(res)
    return dict(runs=got, ckpt=ckpt)


def _run(ranks, tag, shape, arch):
    return ranks["runs"][(tag, shape, arch)]


# ------------------------------------------------------------- the step
@pytest.mark.parametrize("shape,arch", RUNS)
def test_tensor_parallel_step_within_the_train_bounds(ranks, one_device, reference,
                                                      shape, arch):
    """Against the port's one-device step at microbatches = data ranks."""
    key = ("train", _data_ranks(shape), arch)
    want = _port_run(one_device[key], arch)
    grads_ref = reference.result()[key]["grads0"]
    for o in _run(ranks, "train", shape, arch):
        _check_train(_port_run(o, arch), want, grads_ref, arch, ("rank", o["rank"]))


@pytest.mark.parametrize("shape,arch", RUNS)
def test_tensor_parallel_step_within_the_reference_bounds(ranks, one_device, reference,
                                                          shape, arch):
    """Against the reference's jitted one-device step at microbatches =
    data ranks (its metrics and weights) and its loss's step-0 gradient;
    the port's one-device step against it too."""
    key = ("train", _data_ranks(shape), arch)
    want = reference.result()[key]
    _check_train(_port_run(one_device[key], arch), want, want["grads0"], arch,
                 "one device", lr_ulps=1)
    for o in _run(ranks, "train", shape, arch):
        _check_train(_port_run(o, arch), want, want["grads0"], arch, ("rank", o["rank"]),
                     lr_ulps=1)


@pytest.mark.parametrize("shape,arch", RUNS)
def test_tensor_parallel_step_is_bitwise_on_repeat_and_across_ranks(ranks, shape, arch):
    runs, again = _run(ranks, "train", shape, arch), _run(ranks, "repeat", shape, arch)
    for a, b in zip(runs, again, strict=True):
        assert a["mets"] == b["mets"]
        for n, p in a["params"].items():
            assert p.tobytes() == b["params"][n].tobytes(), n
    for o in runs:  # the same bits on every rank (replicated and gathered)
        assert o["mets"] == runs[0]["mets"]
        for n, p in o["replicated"].items():
            assert p.tobytes() == runs[0]["replicated"][n].tobytes(), (o["rank"], n)
        for n, p in o["params"].items():
            assert p.tobytes() == runs[0]["params"][n].tobytes(), (o["rank"], n)
    assert runs[0]["replicated"]  # the norms at least


def test_a_tensor_parallel_checkpoint_restores_on_one_device_and_back(ranks, one_device,
                                                                      trees):
    cfg = _cfg("gemma2-2b")
    steps = ARCH_STEPS["gemma2-2b"]
    model = tpr.model_of(cfg, trees["gemma2-2b"], trainable=True)
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    CheckpointManager(ranks["ckpt"]).restore(steps, {"params": model})
    want = _run(ranks, "train", (2, 2), "gemma2-2b")[0]["params"]
    for n, p in model.named_parameters():
        assert tpr._np(p).tobytes() == want[n].tobytes(), n
    # the one-device checkpoint on (2, 2): each rank holds its slices
    one = one_device[("train", 2, "gemma2-2b")]["params"]
    for o in _run(ranks, "restore", (2, 2), "gemma2-2b"):
        m = o["coords"]["model"]
        for n, local in o["local"].items():
            full = one[n]
            if local.shape != full.shape:
                d = next(i for i, (a, b) in enumerate(zip(local.shape, full.shape))
                         if a != b)
                full = np.split(full, 2, axis=d)[m]
            assert local.tobytes() == full.tobytes(), (o["rank"], n)


# ------------------------------------------------------------- the server
def _slot_agreement(got, want, rows, heads):
    """Share of (layer, row, head, slot) entries of this rank's compressed
    caches equal to ``want``'s (whole caches) within one bf16 ulp (k, v)
    and SUM_TOL (mass); a Mamba layer (no "k") holds none."""
    agree = total = 0
    for cg, cw in zip(got, want, strict=True):
        if "k" not in cw:
            continue
        assert cg["pos"] == cw["pos"]
        P = cw["pos"]
        sl = (slice(*rows), slice(*heads) if heads else slice(None))
        ok = np.isclose(cg["mass"][..., :P], tpr._np(cw["mass"][sl])[..., :P],
                        rtol=1e-5, atol=1e-4)
        for k in ("k", "v"):
            ok &= np.isclose(cg[k][:, :, :P], tpr._np(cw[k][sl])[:, :, :P],
                             rtol=2 ** -7, atol=1e-5).all(-1)
        agree += int(ok.sum())
        total += ok.size
    return agree / total


def _whole_raw(outs, cfg):
    """Every rank's raw prefill caches put together: the whole batch, every
    kv head (a Mamba layer's entry stays empty: the compression passes it)."""
    first = outs[0]["raw"]
    layers = []
    for l, c in enumerate(first["layers"]):
        if "k" not in c:
            layers.append(c)
            continue
        shape = (tpr.SERVE["batch"], cfg.n_kv_heads) + tuple(c["k"].shape[2:])
        whole = {k: torch.zeros(shape, dtype=torch.bfloat16) for k in ("k", "v")}
        for o in outs:  # bf16 values widened to f32 by the ranks: exact
            sl = (slice(*o["rows"]), slice(*o["heads"]) if o["heads"] else slice(None))
            for k in ("k", "v"):
                whole[k][sl] = torch.from_numpy(o["raw"]["layers"][l][k]).bfloat16()
        layers.append(dict(whole, pos=c["pos"]))
    return dict(first, layers=layers)


@pytest.mark.parametrize("shape,arch", SERVE_RUNS)
def test_tensor_parallel_server_within_lm_parity_limits(ranks, one_device, shape, arch):
    """Logits of the prefill and of each forced decode step within
    lm_parity's limits of one device; each rank's compressed caches (its
    rows, its kv heads) the one-device compression of the ranks' raw
    caches put together: a head's prototypes do not depend on the rank
    that holds it."""
    from repro_torch.serve.kv_compression import compress_model_caches

    want = one_device[("serve", arch)]
    outs = _run(ranks, "serve", shape, arch)
    S = tpr.SERVE
    together = compress_model_caches(_whole_raw(outs, _cfg(arch)), S["t"], S["m"],
                                     tail=S["tail"])["layers"]
    for o in outs:
        top1 = []
        for i, (g, w) in enumerate(zip(o["logits"], want["logits"], strict=True)):
            assert g.shape == w.shape and np.isfinite(g).all()
            bound = LOGIT_ULPS * bf16_ulp(float(np.abs(w).max()))
            assert float(np.abs(g - w).max()) <= bound, (i, float(np.abs(g - w).max()))
            top1 += list(g.argmax(-1) == w.argmax(-1))
        # over every (step, row), as lm_moe counts its 132 rows: 4 rows a
        # step of a 128-token vocabulary meet near-ties
        assert np.mean(top1) >= MIN_TOP1, np.mean(top1)
        assert _slot_agreement(o["caches"], together, o["rows"], o["heads"]) >= MIN_SLOTS


@pytest.mark.parametrize("shape,arch", SERVE_RUNS)
def test_tensor_parallel_server_within_lm_parity_limits_of_the_reference(
        ranks, one_device, reference, shape, arch):
    """Logits of the prefill and of each forced decode step within
    lm_parity's limits of the reference's prefill, compression and decode
    on the same prompts; the port's one-device route too."""
    want = reference.result()[("serve", arch)]
    runs = [("one device", one_device[("serve", arch)]["logits"])]
    runs += [(("rank", o["rank"]), o["logits"]) for o in _run(ranks, "serve", shape, arch)]
    for what, logits in runs:
        top1 = []
        for i, (g, w) in enumerate(zip(logits, want, strict=True)):
            assert g.shape == w.shape and np.isfinite(g).all(), (what, i)
            err = float(np.abs(g - w).max())
            assert err <= LOGIT_ULPS * bf16_ulp(float(np.abs(w).max())), (what, i, err)
            top1 += list(g.argmax(-1) == w.argmax(-1))
        assert np.mean(top1) >= MIN_TOP1, (what, np.mean(top1))


# ------------------------------------------------------------- the draw
@pytest.mark.parametrize("shape,arch,trainable", DRAWS)
def test_a_seeded_draw_on_a_mesh_is_the_one_device_draw_sliced(ranks, shape, arch,
                                                                trainable):
    """``bundle.init(mesh=)`` allocates each rank's slices and draws one
    whole leaf at a time: bitwise the one-device draw, sliced."""
    from repro_torch.models import build

    cfg = _cfg(arch)
    bundle = build(cfg)
    specs = bundle.param_specs(tp="model", tp_size=shape[-1])
    assert any(model_dim(sp) is not None for sp in specs.values())
    for o in _run(ranks, f"init-{trainable}", shape, arch):
        one = bundle.init(torch.Generator().manual_seed(11), device="cpu",
                          trainable=trainable)
        shard_params(one, specs, {"model": (o["coords"]["model"], shape[-1])})
        assert sorted(o["local"]) == sorted(n for n, _ in one.named_parameters())
        for n, p in one.named_parameters():
            assert o["local"][n].tobytes() == tpr._np(p).tobytes(), (o["rank"], n)


# ------------------------------------------------------------- what runs
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mamba2-370m",
                                  "seamless-m4t-large-v2"])
def test_moe_mamba_and_encdec_on_a_model_axis_name_item_7d(arch, monkeypatch):
    """Every family runs on a model axis (ROADMAP item 7d, done): for the
    MoE (expert parallel), Mamba heads and the enc-dec the launcher's
    ``--mesh debug`` goes on to start its ranks (tests/test_torch_ep.py and
    tests/test_torch_encdec_tp.py train them), and each builds its
    model-axis layout at 2 model ranks."""
    from repro_torch.models.tensor_parallel import TensorParallel

    def no_spawn(*a, **kw):
        raise AssertionError("ranks were started")

    monkeypatch.setattr(launcher, "spawn_ranks", no_spawn)
    monkeypatch.setattr(launcher, "init_state", no_spawn)
    argv = ["--arch", arch, "--smoke", "--mesh", "debug", "--steps", "1",
            "--device", "cpu"]
    axis = type("A", (), {"size": 2, "index": 0})()
    tp = TensorParallel(_cfg(arch), axis, {})
    assert tp.size == 2 and not tp.context_parallel
    with pytest.raises(AssertionError, match="ranks were started"):
        launcher.main(argv)


def test_context_parallel_plans_name_item_7d():
    """A ``heads_mode="seq"`` plan (ROADMAP item 7d, done) binds to a
    context-parallel layout (tests/test_torch_cp.py runs it); a plan
    without vocabulary-sharded logits is refused."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import MeshShape, make_plan
    from repro_torch.models.tensor_parallel import TensorParallel

    cfg = dataclasses.replace(_cfg("gemma2-2b"), n_heads=6, n_kv_heads=2)
    plan = make_plan(cfg, ShapeConfig("c", 32, 8, "train"),
                     MeshShape(("data", "model"), (2, 4)), heads_mode="seq")
    assert plan.kv is not None
    axis = type("A", (), {"size": 4, "index": 0})()
    tp = TensorParallel(cfg, axis, {})
    bound = tp.bind(plan)
    assert bound.context_parallel and not tp.context_parallel
    auto = make_plan(cfg, ShapeConfig("c", 32, 8, "train"),
                     MeshShape(("data", "model"), (2, 4)))
    assert not tp.bind(auto).context_parallel
    with pytest.raises(ValueError, match="vocabulary-sharded logits"):
        tp.bind(dataclasses.replace(plan, logits=None))


# ------------------------------------------------------------- the launcher
#: the launcher's debug-mesh run: 2 steps of the smoke gemma2 cut to 2 layers
DEBUG_RUN = dict(steps=2, batch=4, seq=16, device="cpu")


@pytest.fixture(scope="module")
def debug_launch():
    """The one spawn of 8 ranks at (data 2, model 4): the launcher's
    ``--mesh debug`` run of DEBUG_RUN; every rank's :func:`mesh_rank`."""
    cfg = dataclasses.replace(_cfg("gemma2-2b"), n_layers=2)
    return cfg, launcher.launch_mesh(cfg, "train_4k", "debug", DEBUG_RUN,
                                     timeout=LIMIT_S)


def test_the_launcher_trains_on_the_debug_mesh(debug_launch):
    """``--mesh debug`` at the smoke config on the CPU: 8 spawned ranks at
    (data 2, model 4), 2 steps; every rank's losses equal and finite."""
    _, outs = debug_launch
    assert len(outs) == 8 and [o["rank"] for o in outs] == list(range(8))
    assert all(o["losses"] == outs[0]["losses"] for o in outs)
    assert len(outs[0]["losses"]) == 2 and np.isfinite(outs[0]["losses"]).all()


def test_the_dry_run_reckons_every_ranks_collectives(debug_launch):
    """The dry run's trace of the same step on the meta device
    (``launch.dryrun.trace_step`` over a ``TracedMesh`` of (data 2, model
    4)) records, op by op, the calls and bytes each of the 8 gloo ranks
    recorded over its last step (``_collectives.op_counts``)."""
    from repro_torch.configs import ParallelConfig
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun

    cfg, outs = debug_launch
    got = dryrun.trace_step(
        cfg, ShapeConfig("train_4k", DEBUG_RUN["seq"], DEBUG_RUN["batch"], "train"),
        port_mesh.MeshShape(("data", "model"), (2, 4)),
        parallel=ParallelConfig(remat="block"))
    assert got["op_counts"] and set(got["op_counts"]) >= {"gather_rows", "sum_scatter"}
    for o in outs:
        assert o["step_collectives"] == got["op_counts"], o["rank"]
