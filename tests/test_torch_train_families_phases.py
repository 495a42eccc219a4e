"""The trainer's pieces that need no reference run, on the CPU: the MoE's
slot backward at deepseek's k = 6, the launcher on every family (the
enc-dec at smoke with block remat; a training state beyond the card
refused), ``chip_smoke.py``'s train phases rehearsed at smoke size, and
the SSD scan's masked exp against the reference's
(``tests/test_torch_train_families.py`` holds the train steps against the
JAX package's)."""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, SHAPES, smoke_config
from repro_torch.data import make_batch
from repro_torch.launch import train as launcher
from repro_torch.models import build, moe

sys.path.append(str(Path(__file__).resolve().parent.parent))  # chip_smoke.py

torch.set_num_threads(1)


def _batch(cfg, step, b):
    return make_batch(cfg, SHAPES["train_4k"], step, batch_override=b, seq_override=32)


def test_token_slots_backward_sums_each_token_s_slots_in_order(monkeypatch):
    """The MoE's token-to-slot rows at deepseek's k = 6 (the smoke config's
    k overridden): the backward gives each token the f32 sum of its six
    slot gradients taken in slot order, rounded once to bf16, and
    ``moe_apply`` takes its slots from it."""
    k = 6
    cfg = dataclasses.replace(smoke_config(ARCHS["deepseek-moe-16b"]),
                              n_experts=8, n_experts_per_tok=k)
    gen = torch.Generator().manual_seed(0)
    xt = torch.randn(40, cfg.d_model, generator=gen).bfloat16().requires_grad_(True)
    g = (torch.randn(40 * k, cfg.d_model, generator=gen) * 10).bfloat16()
    rows = moe.token_slots(xt, k)
    assert torch.equal(rows, xt.detach().repeat_interleave(k, dim=0))
    rows.backward(g)
    g = g.reshape(40, k, cfg.d_model).float()
    want = g[:, 0]
    for j in range(1, k):
        want = want + g[:, j]
    assert torch.equal(xt.grad, want.bfloat16())

    calls = []
    real = moe.token_slots
    monkeypatch.setattr(moe, "token_slots", lambda x, kk: calls.append(kk) or real(x, kk))
    model = build(cfg).init(torch.Generator().manual_seed(1), device="cpu",
                            trainable=True)
    logits, aux = build(cfg).forward(model, _batch(cfg, 0, 2))
    (logits.sum() + aux).backward()
    n_moe = sum(cfg.layer_is_moe(l) for l in range(cfg.n_layers))
    assert calls == [k] * n_moe
    assert all(p.grad is not None for p in model.parameters())


def test_launcher_trains_seamless_at_smoke_with_block_remat(capsys):
    """``python -m repro_torch.launch.train --arch seamless-m4t-large-v2
    --smoke --device cpu --remat block``, 2 steps."""
    launcher.main(["--arch", "seamless-m4t-large-v2", "--smoke", "--device", "cpu",
                   "--remat", "block", "--steps", "2", "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert "step      0 loss" in out and "done: 2 steps" in out


@pytest.mark.parametrize("arch,layers,fits", [
    ("llama4-scout-17b-a16e", 0, False), ("jamba-v0.1-52b", 0, False),
    ("deepseek-moe-16b", 0, False), ("deepseek-moe-16b", 4, True),
    ("jamba-v0.1-52b", 2, True), ("phi-3-vision-4.2b", 0, True)])
def test_launcher_refuses_a_state_beyond_the_card(arch, layers, fits, monkeypatch):
    """On an 80 GB card a training state of 16 B a parameter beyond it
    raises before anything is built, naming the multi-device item; the
    chip phases' cuts fit."""
    class Props:
        total_memory = 80 * 2**30

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: Props)
    cfg = ARCHS[arch]
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if fits:
        launcher.check_fits(cfg, torch.device("cuda"))
        return
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)  # a card here
    monkeypatch.setattr(launcher, "init_state", lambda *a, **k: pytest.fail("built"))
    with pytest.raises(ValueError, match="Queue 1, item 7"):
        launcher.train(cfg, SHAPES["train_4k"], steps=1, device=torch.device("cuda"))


@pytest.mark.parametrize("which", ["train_moe", "train_ssm", "train_hybrid",
                                   "train_vlm", "train_encdec"])
def test_chip_train_phases_rehearse_on_the_cpu(which, monkeypatch, capsys):
    """``chip_smoke.py``'s train phase of each family, its control flow on
    the CPU: every arch at its smoke config, 8 steps of 8 × 32 at a peak lr
    of 1e-2 (the card's 3e-4 barely moves a smoke model in 8 steps), the
    card's timers and memory counters stubbed; every check of the phase
    holds and its line carries the fields the card's does."""
    import json
    import time

    import chip_smoke

    class Event:
        def __init__(self, **kw):
            self.t = 0.0

        def record(self):
            self.t = time.perf_counter()

        def elapsed_time(self, other):
            return (other.t - self.t) * 1e3

    class Props:
        total_memory = 80 * 2**30

    for name, fn in (("Event", Event), ("synchronize", lambda *a: None),
                     ("reset_peak_memory_stats", lambda *a: None),
                     ("max_memory_allocated", lambda *a: 0),
                     ("empty_cache", lambda: None),
                     ("get_device_properties", lambda *a: Props)):
        monkeypatch.setattr(torch.cuda, name, fn)
    for arch in ARCHS:
        monkeypatch.setitem(ARCHS, arch, smoke_config(ARCHS[arch]))
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    monkeypatch.setitem(chip_smoke.TRAIN, "peak_lr", 1e-2)
    monkeypatch.setitem(chip_smoke.TRAIN_FAMILY, "steps", 8)
    monkeypatch.setitem(chip_smoke.TRAIN_FAMILY, "seq", 32)
    monkeypatch.setitem(chip_smoke.TRAIN_FAMILIES, which,
                        dict(chip_smoke.TRAIN_FAMILIES[which], layers=0))
    chip_smoke.phase_train_family({}, which)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == which and line["steps"] == 8
    assert line["bitwise_repeat"] and line["resume_bitwise"] and line["launches"] == {}
    assert line["loss_ratio"] < chip_smoke.MIN_LOSS_DROP
    assert len(line["grad_norms"]) == 8 and all(np.isfinite(line["grad_norms"]))
    for key in ("cut", "step_ms_first", "step_ms_p50", "tokens_per_s",
                "adamw_share", "max_memory_allocated", "positions_per_step"):
        assert key in line, key
    cfg = ARCHS[line["arch"]]
    assert ("aux_losses" in line) == bool(cfg.n_experts)
    assert ("max_segsum_diff" in line) == bool(cfg.ssm_state)


def test_segsum_exp_masks_before_the_exp():
    """Decay sums past exp's f32 range above the diagonal (a long chunk of
    fast decay, as a mamba2-370m batch met on the card): the port's
    ``segsum_exp`` gives the forward bits of the exp-then-mask form and
    the reference's values within 1e-4 relative (torch's exp is not XLA's,
    and the cumulative sums of up to 128 decays round apart, which exp
    scales by the sum), and a finite gradient, where the reference's exp-then-mask
    backward gives NaN (ROADMAP.md, Queue 3: a fault of the reference the
    port does not copy)."""
    from repro.models.mamba2 import _segsum_exp as j_segsum_exp
    from repro_torch.models import mamba2

    a = -np.random.default_rng(0).uniform(0.5, 1.5, size=(2, 128, 3)).astype(np.float32)
    upper = np.cumsum(a, axis=1)[:, 0] - np.cumsum(a, axis=1)[:, -1]
    assert upper.max() > np.log(np.finfo(np.float32).max)
    at = torch.from_numpy(a).requires_grad_(True)
    got = mamba2.segsum_exp(at)
    cs = torch.cumsum(at.detach(), dim=-2).transpose(-1, -2)
    diff = cs[..., :, None] - cs[..., None, :]
    lower = torch.tril(torch.ones(128, 128, dtype=torch.bool))
    masked_after = torch.where(lower, torch.exp(diff), torch.zeros(()))
    assert torch.equal(got.detach(), masked_after)
    want = np.asarray(j_segsum_exp(jnp.asarray(a)))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=np.finfo(np.float32).tiny)  # XLA flushes denormals
    got.sum().backward()
    assert torch.isfinite(at.grad).all()
    j_grad = jax.grad(lambda x: j_segsum_exp(x).sum())(jnp.asarray(a))
    assert np.isnan(np.asarray(j_grad)).any()
