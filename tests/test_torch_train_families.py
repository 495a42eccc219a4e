"""The port's trainer on the non-dense families against the JAX package's,
at ``smoke_config``: deepseek-moe-16b and llama4-scout (MoE), mamba2-370m
(SSM), jamba (hybrid), phi-3-vision (VLM, its batches carrying the stubbed
patch prefix) and seamless-m4t (the audio encoder-decoder, its batches
carrying encoder frames), fed the same parameters and optimizer state
(carried across by ``models.convert``) and the same batches.

Bounds, as ``tests/test_torch_train.py``'s for gemma2: loss, MoE aux loss
and grad norm within ``LOGIT_ULPS`` bf16 ulps of the reference's; the loss
weight equal; parameters after k steps per leaf within 2·Σ lr_t of the
reference's, on average within 0.1·Σ lr_t. Routing is a step function
(``tests/test_torch_lm_families.py``): the port's MoE calls run pinned to
the reference's choices where a token's own choice differs from it only
among experts within 2^-5 of its top-k boundary
(``chip_smoke.RoutingPin``); any other difference fails. The port against
itself: remat none / block / dots bitwise (the encoder-decoder included);
microbatches 2 against 1 within the loss and grad bounds (see the test
for the MoE aux loss). The pieces that need no reference run are in
``tests/test_torch_train_families_phases.py``.
"""
import contextlib
import dataclasses
import sys
import tempfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import smoke_config as j_smoke_config
from repro.configs.base import ParallelConfig as JParallelConfig
from repro.data import make_batch as j_make_batch
from repro.models import build as j_build
from repro.train import CheckpointManager as JCheckpointManager
from repro.train import OptConfig as JOptConfig
from repro.train import init_opt_state as j_init_opt
from repro.train import make_train_step as j_make_train_step
from repro.utils.tree import tree_flatten_with_paths as j_flatten
from repro_torch.configs import ARCHS, SHAPES, ParallelConfig, smoke_config
from repro_torch.data import make_batch
from repro_torch.launch import train as launcher
from repro_torch.models import build
from repro_torch.models.convert import opt_state_from_tree, params_from_tree
from repro_torch.train import CheckpointManager, OptConfig, make_train_step
from repro_torch.train.train_step import make_loss_fn
from test_torch_lm_families import reference_routing
from test_torch_train import LOGIT_ULPS, _np, _stacked_params, assert_close_ulps, bf16_ulp

sys.path.append(str(Path(__file__).resolve().parent.parent))
from chip_smoke import RoutingPin  # noqa: E402

torch.set_num_threads(1)

FAMILIES = ["deepseek-moe-16b", "llama4-scout-17b-a16e", "mamba2-370m",
            "jamba-v0.1-52b", "phi-3-vision-4.2b", "seamless-m4t-large-v2"]
SCHED = dict(peak_lr=1e-2, warmup_steps=5, decay_steps=60)
B, S, STEPS = 8, 32, 3


_REFERENCE: dict = {}


def reference(arch):
    """The reference's jitted step (remat "none": a rematerialised forward
    would record its routing twice) at the smoke config: its initial state,
    and its metrics, parameters and MoE routing at each of STEPS steps."""
    if arch in _REFERENCE:
        return _REFERENCE[arch]
    jcfg = j_smoke_config(J_ARCHS[arch])
    jb = j_build(jcfg)
    params = jb.init(jax.random.PRNGKey(0))
    opt = j_init_opt(params)
    init = (_np(params), _np(opt))
    mets, states, routing = [], [], []
    pin = RoutingPin()
    with reference_routing(pin):
        step = jax.jit(j_make_train_step(jb, JOptConfig(**SCHED),
                                         JParallelConfig(remat="none")))
        for s in range(STEPS):
            pin.calls = []
            batch = j_make_batch(jcfg, J_SHAPES["train_4k"], s, batch_override=B,
                                 seq_override=S)
            params, opt, m = step(params, opt, batch)
            mets.append({k: float(v) for k, v in m.items()})
            jax.effects_barrier()
            routing.append(pin.calls)
            states.append(_np(params))
    _REFERENCE[arch] = dict(init=init, mets=mets, params=states, routing=routing)
    return _REFERENCE[arch]


def _carried(arch, **overrides):
    cfg = dataclasses.replace(smoke_config(ARCHS[arch]), **overrides)
    init = reference(arch)["init"]
    model = params_from_tree(cfg, init[0], device="cpu", trainable=True)
    return cfg, model, opt_state_from_tree(model, init[1])


def _batch(cfg, step, b=B):
    return make_batch(cfg, SHAPES["train_4k"], step, batch_override=b, seq_override=S)


def _port_steps(arch, n, parallel=ParallelConfig(remat="none"), pins=None,
                **overrides):
    """n port steps from the carried state; ``pins`` (one RoutingPin a
    step) hold each step's MoE calls to recorded choices; ``overrides``
    replace config fields."""
    cfg, model, opt = _carried(arch, **overrides)
    step = make_train_step(build(cfg), OptConfig(**SCHED), parallel)
    mets = []
    for s in range(n):
        ctx = pins[s].replay() if pins else contextlib.nullcontext()
        with ctx:
            model, opt, m = step(model, opt, _batch(cfg, s))
        mets.append(m)
    return model, opt, mets


def _reference_pins(arch):
    pins = []
    for calls in reference(arch)["routing"]:
        pin = RoutingPin()
        pin.calls = calls
        pins.append(pin)
    return pins


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_steps_match_reference(arch):
    """STEPS steps: loss, aux loss, grad norm, weight and lr against the
    reference's at each step, then the parameters."""
    ref = reference(arch)
    pins = _reference_pins(arch)
    model, opt, mets = _port_steps(arch, STEPS, pins=pins)
    cfg = model.cfg
    n_moe = sum(cfg.layer_is_moe(l) for l in range(cfg.n_layers)) if cfg.n_experts else 0
    for s, (m, jm, pin) in enumerate(zip(mets, ref["mets"], pins, strict=True)):
        assert len(pin.calls) == n_moe
        assert pin.far == 0, f"step {s}: {pin.far} routing differences beyond a near-tie"
        assert_close_ulps(float(m["loss"]), jm["loss"], f"step {s} loss")
        assert_close_ulps(float(m["grad_norm"]), jm["grad_norm"], f"step {s} grad norm")
        if n_moe:
            assert_close_ulps(float(m["aux_loss"]), jm["aux_loss"], f"step {s} aux")
        else:
            assert float(m["aux_loss"]) == jm["aux_loss"] == 0.0
        assert float(m["weight"]) == jm["weight"]
        assert abs(float(m["lr"]) - jm["lr"]) <= np.spacing(np.float32(jm["lr"]))
    assert int(opt["step"]) == STEPS
    lr_sum = sum(jm["lr"] for jm in ref["mets"])
    got = _stacked_params(model)
    for path, leaf in j_flatten(ref["params"][-1]):
        d = np.abs(got[path] - np.asarray(leaf))
        assert d.max() <= 2 * lr_sum, f"{path}: max |dp| {d.max()} > {2 * lr_sum}"
        assert d.mean() <= 0.1 * lr_sum, f"{path}: mean |dp| {d.mean()}"


@pytest.mark.parametrize("arch", FAMILIES)
def test_microbatches_match_one_batch(arch):
    """One step in two microbatches against one batch (the reference's
    jamba case among them).

    The MoE aux loss is a product of two means over a call's tokens, so a
    microbatch's is not a share of the batch's, in either package. Without
    it (``router_aux_coef`` 0): the loss and every gradient within the
    bound, each microbatch's MoE calls pinned to the one-batch run's
    choices for its half of the tokens. With it: the step's gradients are
    the mean of its two halves' one-batch gradients, bitwise, and its aux
    the mean of theirs."""
    record = RoutingPin()
    with record.record():
        one, _, m1 = _port_steps(arch, 1, router_aux_coef=0.0)
    half = B * S // 2
    pin = RoutingPin()
    pin.calls = ([c[:half] for c in record.calls]
                 + [c[half:] for c in record.calls])
    two, _, m2 = _port_steps(arch, 1, ParallelConfig(remat="none", microbatches=2),
                             pins=[pin], router_aux_coef=0.0)
    assert pin.far == 0
    assert_close_ulps(float(m2[0]["loss"]), float(m1[0]["loss"]), "loss")
    assert float(m2[0]["weight"]) == float(m1[0]["weight"]) / 2  # per microbatch
    for (name, a), b in zip(one.named_parameters(), two.parameters(), strict=True):
        scale = float(a.grad.abs().max())
        err = float((a.grad - b.grad).abs().max())
        assert err <= LOGIT_ULPS * bf16_ulp(max(scale, 1e-30)), \
            f"{name}: grad {err} of {scale}"

    two, _, m2 = _port_steps(arch, 1, ParallelConfig(remat="none", microbatches=2))
    batch, halves, auxes = _batch(two.cfg, 0), [], []
    for i in range(2):
        cfg, model, _ = _carried(arch)
        part = {k: v.reshape((2, B // 2) + tuple(v.shape[1:]))[i] for k, v in batch.items()}
        loss, mets = make_loss_fn(build(cfg), "ref", "none")(model, part)
        loss.backward()
        halves.append(dict(model.named_parameters()))
        auxes.append(mets["aux_loss"].detach())
    assert torch.equal(m2[0]["aux_loss"], torch.mean(torch.stack(auxes)))
    for name, p in two.named_parameters():
        want = (halves[0][name].grad + halves[1][name].grad) / 2
        assert torch.equal(p.grad, want), name


@pytest.mark.parametrize("remat", ["block", "dots"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_is_bitwise(arch, remat):
    base, _, mb = _port_steps(arch, 2)
    other, _, mo = _port_steps(arch, 2, ParallelConfig(remat=remat))
    for a, b in zip(mb, mo, strict=True):
        assert all(torch.equal(a[k], b[k]) for k in a)
    for (name, a), b in zip(base.named_parameters(), other.parameters(), strict=True):
        assert torch.equal(a, b), name
        assert torch.equal(a.grad, b.grad), name


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_step_no_nans(arch):
    """The counterpart of the reference's ``test_train_step_no_nans``, over
    every arch: one step from a seeded draw, a finite positive loss and a
    finite grad norm, and the parameters moved."""
    cfg = smoke_config(ARCHS[arch])
    bundle, model, opt = launcher.init_state(cfg, device="cpu")
    step = make_train_step(bundle, OptConfig(warmup_steps=2, decay_steps=10))
    before = next(model.parameters()).detach().clone()
    model, opt, mets = step(model, opt, _batch(cfg, 0, b=2))
    assert float(mets["loss"]) > 0 and np.isfinite(float(mets["loss"]))
    assert np.isfinite(float(mets["grad_norm"]))
    assert int(opt["step"]) == 1
    assert not torch.allclose(before, next(model.parameters()).detach())


@pytest.mark.parametrize("arch", FAMILIES)
def test_checkpoints_load_across_packages(arch):
    """A port checkpoint after one step restores in the JAX package with
    the reference's tree, and the reference's after STEPS restores into
    the port: the same arrays, every leaf of the family named alike."""
    ref = reference(arch)
    model, opt, _ = _port_steps(arch, 1, pins=_reference_pins(arch)[:1])
    jparams, jopt = ref["init"]
    with tempfile.TemporaryDirectory() as d:
        CheckpointManager(d).save(1, {"params": model, "opt": opt})
        got = JCheckpointManager(d).restore(1, {"params": jparams, "opt": jopt})
    want = _stacked_params(model)
    leaves = j_flatten(got["params"])
    assert [p for p, _ in leaves] == list(want)
    for path, leaf in leaves:
        np.testing.assert_array_equal(np.asarray(leaf), want[path], err_msg=path)
    assert int(got["opt"]["step"]) == 1
    with tempfile.TemporaryDirectory() as d:
        JCheckpointManager(d).save(STEPS, {"params": ref["params"][-1], "opt": jopt})
        _, m2, o2 = _carried(arch)
        rest = CheckpointManager(d).restore(STEPS, {"params": m2, "opt": o2})
    got = _stacked_params(rest["params"])
    for path, leaf in j_flatten(ref["params"][-1]):
        np.testing.assert_array_equal(got[path], np.asarray(leaf), err_msg=path)
