"""The port's trainer (``repro_torch.train``, ``models`` in training mode,
``launch.train``) against the JAX package's at ``smoke_config``, fed the
same parameters and optimizer state (carried across by
``models.convert``) and the same batches; then the reference's own
training tests, run against the port.

Tolerances. Loss and grad norm: within LOGIT_ULPS bf16 ulps of the
reference's value, the bound ``tests/test_torch_lm.py`` holds the logits
to (both sides run the model in bf16 with f32 norms and logits, and
round bf16 products and sums in other places). Training logits: the same
bound on the largest |logit|. Parameters after k steps: per leaf within
2·Σ lr_t of the reference's (Adam turns a tiny gradient difference into
an update of up to ±lr, so two runs may step apart by twice that), and
on average within 0.1·Σ lr_t. The port against itself (remat none /
block / dots, checkpoint resume, the cast-at-use weights): bitwise;
microbatches 1 vs 2: the loss/grad bound above.
"""
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import smoke_config as j_smoke_config
from repro.data import make_batch as j_make_batch
from repro.models import build as j_build
from repro.train import CheckpointManager as JCheckpointManager
from repro.train import OptConfig as JOptConfig
from repro.train import init_opt_state as j_init_opt
from repro.train import make_train_step as j_make_train_step
from repro.train.train_step import cross_entropy as j_cross_entropy
from repro_torch.configs import ARCHS, SHAPES, ParallelConfig, smoke_config
from repro_torch.data import make_batch
from repro_torch.kernels import _cuda
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_assign, knn_topk, pairwise_l2, segment_sum
from repro_torch.launch import train as launcher
from repro_torch.models import build
from repro_torch.models.convert import opt_state_from_tree, params_from_tree
from repro_torch.train import (
    CheckpointManager,
    OptConfig,
    make_eval_step,
    make_train_step,
)
from repro_torch.train.fault_tolerance import StepGuard, TransientError, run_training
from repro_torch.train.train_step import cross_entropy

torch.set_num_threads(1)

LOGIT_ULPS = 8
SCHED = dict(peak_lr=1e-2, warmup_steps=5, decay_steps=60)
B, S = 8, 32


def bf16_ulp(x: float) -> float:
    return float(2.0 ** (np.floor(np.log2(abs(x))) - 7))


def assert_close_ulps(got, want, what, ulps=LOGIT_ULPS):
    bound = ulps * bf16_ulp(want)
    assert abs(got - want) <= bound, f"{what}: {got} vs {want} (bound {bound})"


def _np(tree_):
    return jax.tree_util.tree_map(np.asarray, tree_)


# ------------------------------------------------------------- the reference
@pytest.fixture(scope="module")
def reference():
    """The reference's jitted step at smoke gemma2-2b: its initial state,
    and its metrics and parameters after each of three steps."""
    jcfg = j_smoke_config(J_ARCHS["gemma2-2b"])
    jb = j_build(jcfg)
    params = jb.init(jax.random.PRNGKey(0))
    opt = j_init_opt(params)
    init = (_np(params), _np(opt))
    step = jax.jit(j_make_train_step(jb, JOptConfig(**SCHED)))
    mets, states = [], []
    for s in range(3):
        batch = j_make_batch(jcfg, J_SHAPES["train_4k"], s, batch_override=B,
                             seq_override=S)
        params, opt, m = step(params, opt, batch)
        mets.append({k: float(v) for k, v in m.items()})
        states.append(_np(params))
    logits, _ = jb.forward(init[0], j_make_batch(
        jcfg, J_SHAPES["train_4k"], 0, batch_override=B, seq_override=S), impl="xla")
    return dict(init=init, mets=mets, params=states, logits=np.array(logits))


def _carried(reference, cfg=None):
    cfg = cfg or smoke_config(ARCHS["gemma2-2b"])
    model = params_from_tree(cfg, reference["init"][0], device="cpu", trainable=True)
    return model, opt_state_from_tree(model, reference["init"][1])


def _batch(cfg, step):
    return make_batch(cfg, SHAPES["train_4k"], step, batch_override=B, seq_override=S)


def _port_steps(reference, n, parallel=ParallelConfig(remat="none")):
    cfg = smoke_config(ARCHS["gemma2-2b"])
    model, opt = _carried(reference, cfg)
    step = make_train_step(build(cfg), OptConfig(**SCHED), parallel)
    mets = []
    for s in range(n):
        model, opt, m = step(model, opt, _batch(cfg, s))
        mets.append(m)
    return model, opt, mets


def _stacked_params(model):
    from repro_torch.utils.tree import tree_flatten_with_paths

    return {path: np.stack([p.detach().numpy() for p in parts]) if len(parts) > 1
            else parts[0].detach().numpy()
            for path, parts in tree_flatten_with_paths(model)}


def test_training_forward_matches_reference(reference):
    cfg = smoke_config(ARCHS["gemma2-2b"])
    model, _ = _carried(reference, cfg)
    logits, aux = build(cfg).forward(model, _batch(cfg, 0), impl="ref")
    want = reference["logits"]
    assert logits.dtype == torch.float32 and float(aux) == 0.0
    assert tuple(logits.shape) == want.shape == (B, S, cfg.padded_vocab_size)
    err = float((logits.detach() - torch.from_numpy(want)).abs().max())
    assert err <= LOGIT_ULPS * bf16_ulp(np.abs(want).max())


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_steps_match_reference(reference, n_steps):
    from repro.utils.tree import tree_flatten_with_paths as j_flatten

    model, opt, mets = _port_steps(reference, n_steps)
    for s, (m, jm) in enumerate(zip(mets, reference["mets"], strict=False)):
        assert_close_ulps(float(m["loss"]), jm["loss"], f"step {s} loss")
        assert_close_ulps(float(m["grad_norm"]), jm["grad_norm"], f"step {s} grad norm")
        assert float(m["weight"]) == jm["weight"]
        assert abs(float(m["lr"]) - jm["lr"]) <= np.spacing(np.float32(jm["lr"]))
    assert int(opt["step"]) == n_steps
    lr_sum = sum(jm["lr"] for jm in reference["mets"][:n_steps])
    got = _stacked_params(model)
    for path, leaf in j_flatten(reference["params"][n_steps - 1]):
        d = np.abs(got[path] - np.asarray(leaf))
        assert d.max() <= 2 * lr_sum, f"{path}: max |dp| {d.max()} > {2 * lr_sum}"
        assert d.mean() <= 0.1 * lr_sum, f"{path}: mean |dp| {d.mean()}"


def test_microbatches_match_one_batch(reference):
    one, _, m1 = _port_steps(reference, 1)
    two, _, m2 = _port_steps(reference, 1, ParallelConfig(remat="none",
                                                          microbatches=2))
    assert_close_ulps(float(m2[0]["loss"]), float(m1[0]["loss"]), "loss")
    assert float(m2[0]["weight"]) == float(m1[0]["weight"]) / 2  # per microbatch
    for (name, a), b in zip(one.named_parameters(), two.parameters(), strict=True):
        scale = float(a.grad.abs().max())
        err = float((a.grad - b.grad).abs().max())
        assert err <= LOGIT_ULPS * bf16_ulp(scale), f"{name}: grad {err} of {scale}"


@pytest.mark.parametrize("remat", ["block", "dots"])
def test_remat_is_bitwise(reference, remat):
    base, _, mb = _port_steps(reference, 2)
    other, _, mo = _port_steps(reference, 2, ParallelConfig(remat=remat))
    for a, b in zip(mb, mo, strict=True):
        assert all(torch.equal(a[k], b[k]) for k in a)
    for (name, a), b in zip(base.named_parameters(), other.parameters(), strict=True):
        assert torch.equal(a, b), name
        assert torch.equal(a.grad, b.grad), name


def test_dots_remat_keeps_the_matrix_products(reference):
    """remat "dots" saves the outputs of the products without batch
    dimensions: its backward recomputes no ``aten.mm``, "block" recomputes
    each one of the layers (every layer's projections)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountMM(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.mm.default:
                CountMM.n += 1
            return func(*args, **(kwargs or {}))

    cfg = smoke_config(ARCHS["gemma2-2b"])
    counts = {}
    for remat in ("none", "block", "dots"):
        model, _ = _carried(reference, cfg)
        CountMM.n = 0
        with CountMM():
            logits, _ = model(_batch(cfg, 0)["tokens"], impl="ref", remat=remat)
            logits.sum().backward()
        counts[remat] = CountMM.n
    per_layer = 7  # q, k, v, o, gate, up, down
    assert counts["dots"] == counts["none"]
    assert counts["block"] == counts["none"] + per_layer * cfg.n_layers


def test_eval_step_is_the_first_loss(reference):
    cfg = smoke_config(ARCHS["gemma2-2b"])
    model, _ = _carried(reference, cfg)
    mets = make_eval_step(build(cfg))(model, _batch(cfg, 0))
    _, _, tm = _port_steps(reference, 1)
    assert torch.equal(mets["loss"], tm[0]["loss"])
    assert all(p.grad is None for p in model.parameters())


def test_cast_at_use_keeps_serving_logits():
    """An f32 trainable model and the frozen bf16 serving model carried from
    the same tree give the same logits bit for bit: every weight is cast
    to bf16 at use."""
    jcfg, cfg = j_smoke_config(J_ARCHS["qwen2.5-32b"]), smoke_config(ARCHS["qwen2.5-32b"])
    tree = _np(j_build(jcfg).init(jax.random.PRNGKey(3)))
    serve = params_from_tree(cfg, tree, device="cpu")
    train = params_from_tree(cfg, tree, device="cpu", trainable=True)
    assert all(not p.requires_grad for p in serve.parameters())
    assert all(p.requires_grad and p.dtype == torch.float32 for p in train.parameters())
    assert {p.dtype for n, p in serve.named_parameters() if "ln" not in n} == {torch.bfloat16}
    toks = _batch(cfg, 0)["tokens"]
    with torch.no_grad():
        a, _ = serve(toks, impl="ref")
        b, _ = train(toks, impl="ref")
        c, _ = train(toks, impl="ref", remat="block")
    assert torch.equal(a, b) and torch.equal(a, c)


# ------------------------------------------------------------- the loss
def test_cross_entropy_matches_reference(rng):
    logits = rng.normal(size=(4, 9, 37)).astype(np.float32) * 5
    labels = rng.integers(0, 37, size=(4, 9)).astype(np.int32)
    labels[rng.random((4, 9)) < 0.3] = -1
    weights = rng.uniform(0.5, 4.0, size=(4,)).astype(np.float32)
    for w in (None, weights):
        jl, jt = j_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                 None if w is None else jnp.asarray(w))
        tl, tt = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                               None if w is None else torch.from_numpy(w))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
        np.testing.assert_allclose(float(tt), float(jt), rtol=1e-6)


def test_weighted_loss_unbiased(rng):
    """CE on the weighted reduced corpus equals CE on the full corpus when
    cluster members are identical (the reference's exactness case)."""
    n, s, v = 32, 8, 11
    base = rng.integers(0, v, size=(n // 4, s + 1)).astype(np.int64)
    full = torch.from_numpy(np.repeat(base, 4, axis=0))
    logits = torch.from_numpy(rng.normal(size=(n // 4, s, v)).astype(np.float32))
    logits = torch.repeat_interleave(logits, 4, dim=0)
    l_full, _ = cross_entropy(logits, full[:, 1:])
    l_red, _ = cross_entropy(logits[::4], full[::4, 1:],
                             weights=torch.full((n // 4,), 4.0))
    assert abs(float(l_full) - float(l_red)) < 1e-5


# ------------------------------------------------------------- the guard
def _kernel_calls(x):
    keys = x.detach()
    q4 = torch.randn(1, 2, 4, 8, requires_grad=True)
    kv = torch.randn(1, 2, 4, 8)
    return {
        "K1": lambda: fused_assign.fused_topk(x, keys, 2),
        "K2": lambda: knn_topk.knn_topk(x, 2),
        "K3": lambda: segment_sum.blocked_segment_sum(
            x, torch.zeros(x.shape[0], dtype=torch.int64), 2),
        "K4": lambda: pairwise_l2.pairwise_sq_l2(x, keys),
        "K5": lambda: fa.flash_attention(q4, kv, kv),
    }


@pytest.mark.parametrize("kid", ["K1", "K2", "K3", "K4", "K5"])
def test_kernels_refuse_tensors_that_require_grad(kid, monkeypatch):
    """On the card route (planted here: the dispatch takes CPU tensors for
    CUDA ones) a kernel handed a tensor that requires grad raises, naming
    the "ref" route, before anything launches; under no_grad the guard
    lets it through (to the device check, which a CPU tensor fails)."""
    monkeypatch.setattr(_cuda, "on_card", lambda t: True)
    call = _kernel_calls(torch.randn(8, 4, requires_grad=True))[kid]
    with pytest.raises(RuntimeError, match='impl="ref"'):
        call()
    with torch.no_grad(), pytest.raises(ValueError, match="got a tensor on cpu"):
        call()


def test_plain_route_trains_through_attention(reference):
    """impl="ref" carries gradients into every parameter, attention's
    projections included."""
    model, _, _ = _port_steps(reference, 1)
    for name, p in model.named_parameters():
        assert p.grad is not None and float(p.grad.abs().sum()) > 0, name


# ------------------------------------------------------------- the reference's training tests
def _setup(name="qwen2.5-32b", lr=1e-2):
    cfg = smoke_config(ARCHS[name])
    bundle, model, opt = launcher.init_state(cfg, device="cpu")
    step = make_train_step(bundle, OptConfig(peak_lr=lr, warmup_steps=5, decay_steps=60))
    bfs = launcher.batch_fn(cfg, SHAPES["train_4k"], 8, 32, torch.device("cpu"))
    return cfg, bundle, model, opt, step, bfs


def test_loss_decreases():
    _, _, model, opt, step, bfs = _setup()
    losses = []
    run_training(train_step=step, init_state=(model, opt), batch_for_step=bfs,
                 n_steps=20, on_metrics=lambda s, m: losses.append(float(m["loss"])))
    assert np.mean(losses[-4:]) < np.mean(losses[:4]) * 0.92, losses


def test_failure_injection_and_retry():
    _, _, model, opt, step, bfs = _setup()
    injected = []

    def hook(s, attempt):
        if s in (2, 5) and attempt == 0:
            injected.append(s)
            return True
        return False

    _, _, stats = run_training(train_step=step, init_state=(model, opt),
                               batch_for_step=bfs, n_steps=8,
                               guard_kwargs={"failure_hook": hook})
    assert injected == [2, 5]
    assert stats.retries == 2 and stats.failures == 2
    assert len(stats.times) == 8


def test_retry_exhaustion_raises():
    guard = StepGuard(lambda *a: None, max_retries=2, failure_hook=lambda s, a: True)
    with pytest.raises(TransientError):
        guard(0)
    assert guard.stats.failures == 3  # initial + 2 retries


def test_checkpoint_resume_is_exact():
    """10 steps straight vs 5 + checkpoint + restore (into a model drawn
    from another seed) + 5: bitwise (the data is a pure function of step)."""
    cfg, _, pa, oa, step, bfs = _setup()
    pa, _, _ = run_training(train_step=step, init_state=(pa, oa),
                            batch_for_step=bfs, n_steps=10)
    _, _, p5, o5, _, _ = _setup()
    with tempfile.TemporaryDirectory() as d:
        ck = CheckpointManager(d)
        p5, o5, _ = run_training(train_step=step, init_state=(p5, o5),
                                 batch_for_step=bfs, n_steps=5)
        ck.save(5, {"params": p5, "opt": o5})
        _, other, other_opt = launcher.init_state(cfg, device="cpu", seed=1)
        rest = ck.restore(5, {"params": other, "opt": other_opt})
        assert rest["params"] is other and int(rest["opt"]["step"]) == 5
        pb, _, _ = run_training(train_step=step,
                                init_state=(rest["params"], rest["opt"]),
                                batch_for_step=bfs, n_steps=10, start_step=5)
    for (name, a), b in zip(pa.named_parameters(), pb.parameters(), strict=True):
        assert torch.equal(a, b), name


def test_checkpoint_gc_and_async():
    _, _, model, _, _, _ = _setup()
    with tempfile.TemporaryDirectory() as d:
        ck = CheckpointManager(d, keep=2)
        for s in (1, 2, 3, 4):
            ck.save(s, {"p": model}, async_=True)
        ck.wait()
        assert ck.all_steps() == [3, 4]
        assert ck.latest_step() == 4
        assert not any(n.endswith(".tmp") for n in os.listdir(d))


def test_async_save_holds_the_values_at_the_call(monkeypatch):
    """An async save copies every leaf before it returns: a model updated
    in place before the write restores to the values at the call."""
    import threading

    from repro_torch.train import checkpoint

    _, _, model, opt, step, bfs = _setup()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    stepped = threading.Event()
    savez = checkpoint.np.savez

    def late_savez(*args, **kw):  # the write waits until the step is done
        assert stepped.wait(timeout=60)
        savez(*args, **kw)

    monkeypatch.setattr(checkpoint.np, "savez", late_savez)
    with tempfile.TemporaryDirectory() as d:
        ck = CheckpointManager(d)
        ck.save(1, {"params": model, "opt": opt}, async_=True)
        step(model, opt, bfs(0))
        stepped.set()
        ck.wait()
        rest = ck.restore(1, {"params": model, "opt": opt})
    assert int(rest["opt"]["step"]) == 0
    for name, p in model.named_parameters():
        assert torch.equal(p, before[name]), name


def test_straggler_detection():
    import time

    calls = {"n": 0}

    def slow_step():
        calls["n"] += 1
        if calls["n"] == 7:
            time.sleep(0.25)

    guard = StepGuard(lambda: slow_step())
    for s in range(8):
        guard(s)
    assert guard.stats.stragglers(factor=5.0) >= 1


def test_checkpoints_load_across_packages(reference):
    """A port checkpoint restores in the JAX package with the reference's
    tree, and the reference's restores into the port: the same arrays."""
    cfg = smoke_config(ARCHS["gemma2-2b"])
    model, opt, _ = _port_steps(reference, 1)
    jparams, jopt = reference["init"]
    with tempfile.TemporaryDirectory() as d:
        CheckpointManager(d).save(1, {"params": model, "opt": opt})
        got = JCheckpointManager(d).restore(1, {"params": jparams, "opt": jopt})
    want = _stacked_params(model)
    from repro.utils.tree import tree_flatten_with_paths as j_flatten

    for path, leaf in j_flatten(got["params"]):
        np.testing.assert_array_equal(np.asarray(leaf), want[path], err_msg=path)
    assert int(got["opt"]["step"]) == 1
    with tempfile.TemporaryDirectory() as d:
        JCheckpointManager(d).save(3, {"params": reference["params"][2], "opt": jopt})
        m2, o2 = _carried(reference, cfg)
        rest = CheckpointManager(d).restore(3, {"params": m2, "opt": o2})
    got = _stacked_params(rest["params"])
    for path, leaf in j_flatten(reference["params"][2]):
        np.testing.assert_array_equal(got[path], np.asarray(leaf), err_msg=path)


def test_checkpoint_of_a_master_mode_state(reference):
    """bf16 parameters with an f32 master copy save and restore bitwise,
    in the reference's on-disk form: the same npz arrays and manifest
    dtypes as the reference's save of the same tree, and each package
    restores the other's."""
    import json

    from repro_torch.train import init_opt_state

    cfg = smoke_config(ARCHS["gemma2-2b"])
    jparams = jax.tree_util.tree_map_with_path(   # the port keeps norms in f32
        lambda path, a: a if path[-1].key.startswith("ln") else jnp.asarray(a, jnp.bfloat16),
        reference["init"][0])
    jopt = j_init_opt(jparams, master=True)
    model = params_from_tree(cfg, _np(jparams), device="cpu").requires_grad_(True)
    opt = init_opt_state(model, master=True)
    assert {p.dtype for n, p in model.named_parameters() if "ln" not in n} == {torch.bfloat16}
    with tempfile.TemporaryDirectory() as d:
        CheckpointManager(d).save(2, {"params": model, "opt": opt})
        JCheckpointManager(os.path.join(d, "ref")).save(
            2, {"params": jparams, "opt": jopt})
        arrays, manifests = [], []
        for root in (d, os.path.join(d, "ref")):
            with np.load(os.path.join(root, "step_00000002", "arrays.npz")) as z:
                arrays.append({k: z[k] for k in z.files})
            with open(os.path.join(root, "step_00000002", "manifest.json")) as f:
                manifests.append(json.load(f)["leaves"])
        assert arrays[0].keys() == arrays[1].keys()
        for k, a in arrays[0].items():
            assert a.dtype == arrays[1][k].dtype and a.tobytes() == arrays[1][k].tobytes(), k
        assert ({l["path"]: l["dtype"] for l in manifests[0]}
                == {l["path"]: l["dtype"] for l in manifests[1]})
        assert "bfloat16" in {l["dtype"] for l in manifests[0]}
        for root in (d, os.path.join(d, "ref")):
            other = build(cfg).init(torch.Generator().manual_seed(1),
                                    device="cpu").requires_grad_(True)
            other_opt = init_opt_state(other, master=True)
            rest = CheckpointManager(root).restore(2, {"params": other, "opt": other_opt})
            for (n, a), b in zip(model.named_parameters(), other.parameters(), strict=True):
                assert b.dtype == a.dtype and torch.equal(a, b), n
            for n, a in opt["master"].items():
                got = rest["opt"]["master"][n]
                assert got.dtype == torch.float32 and torch.equal(got, a), n


# ------------------------------------------------------------- the launcher
def test_launcher_trains_smoke_gemma2_on_the_cpu(capsys):
    losses = []
    _, opt, stats, start = launcher.train(
        smoke_config(ARCHS["gemma2-2b"]), SHAPES["train_4k"], steps=12, seq=32,
        device="cpu", opt_cfg=OptConfig(**SCHED),
        on_metrics=lambda s, m: (losses.append(float(m["loss"])),
                                 launcher.print_metrics(s, m)))
    assert start == 0 and len(stats.times) == 12 and int(opt["step"]) == 12
    assert np.mean(losses[-4:]) < 0.92 * np.mean(losses[:4]), losses
    out = capsys.readouterr().out
    assert "step      0 loss" in out and "step     10 loss" in out
    assert launcher.batch_dims(SHAPES["train_4k"]) == (8, 256)


def test_launcher_resumes_from_its_checkpoints():
    cfg = smoke_config(ARCHS["gemma2-2b"])
    with tempfile.TemporaryDirectory() as d:
        kw = dict(seq=16, batch=4, device="cpu", ckpt_dir=d, ckpt_every=2,
                  on_metrics=None)
        straight, _, _, _ = launcher.train(cfg, SHAPES["train_4k"], steps=4,
                                           ckpt_dir="", **{k: v for k, v in kw.items()
                                                           if k != "ckpt_dir"})
        launcher.train(cfg, SHAPES["train_4k"], steps=2, **kw)
        resumed, _, _, start = launcher.train(cfg, SHAPES["train_4k"], steps=4,
                                              resume=True, **kw)
    assert start == 2
    for a, b in zip(straight.parameters(), resumed.parameters(), strict=True):
        assert torch.equal(a, b)


def _no_model(*args, **kw):
    raise AssertionError("the launcher built a model")


@pytest.mark.parametrize("mesh", ["debug", "pod1", "pod2"])
def test_launcher_rejects_meshes(mesh, monkeypatch):
    """A mesh with a model axis runs the dense, VLM, MoE, SSM and hybrid
    families (items 7c and 7d); the enc-dec there raises, naming item 7d,
    before any rank or model."""
    monkeypatch.setattr(launcher, "init_state", _no_model)  # never full size here
    monkeypatch.setattr(launcher, "spawn_ranks", _no_model)
    with pytest.raises(NotImplementedError, match="Queue 1, item 7d"):
        launcher.main(["--arch", "seamless-m4t-large-v2", "--mesh", mesh, "--steps",
                       "1", "--device", "cpu"])


def test_launcher_needs_the_card_unless_told_cpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the launcher would run on it")
    from repro_torch.models import registry

    monkeypatch.setattr(registry.transformer, "LM", _no_model)  # never full size here
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main(["--arch", "gemma2-2b", "--steps", "1"])
