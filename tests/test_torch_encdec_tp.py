"""The encoder-decoder (seamless-m4t-large-v2's smoke config) on the model
axis, on gloo ranks on the CPU, held against the port's one-device paths
and the reference's one-device paths (its sharded step is no oracle under
jax 0.9). Every model starts from the reference's weights
(``convert.params_from_tree``, then ``tensor_parallel.shard_model``).

One spawn of 4 ranks (tests/torch_tp_ranks.py, every copy through host
mailboxes as ranks sharing a card send them) at (data 2, model 2) and
(data 1, model 4): the encoder's and the decoder's self-attention, the
cross-attention's q and the MLPs by heads and columns, the embedding,
unembedding and loss by vocabulary rows, each decoder layer's cross k/v
projected for the rank's kv heads from its ``wk``/``wv`` columns:

  * the step against the port's and the reference's one-device step at
    microbatches = data ranks, within tests/test_torch_tp.py's bounds
    (the encoder output's gradient summed over the ranks by the cross
    projections' ``copy_to``);
  * a repeat bitwise, every replicated leaf bitwise equal across the model
    ranks;
  * serving ``lm_encdec``'s traffic at smoke size (prompts, encoder frames,
    no compression): the prefill and forced decode steps within
    ``lm_parity``'s limits of the port's and the reference's one device;
    each rank's self-attention and cross k/v caches hold its kv heads.

Without processes: ``launch.train.rank_param_count`` and ``check_fits`` of
the full-size seamless-m4t-large-v2 at 16 model ranks against a count
written out here (every projection, MLP and the vocabulary divided by M,
the norms whole).
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
from repro.train import OptConfig as JOptConfig
from repro.train import init_opt_state as j_init_opt
from repro.train import make_train_step as j_make_train_step
from repro.train.train_step import make_loss_fn as j_make_loss_fn
from repro.utils.tree import tree_flatten_with_paths as j_flatten
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import train as launcher
from repro_torch.utils.tree import tree_flatten_with_paths
from test_torch_tp import LOGIT_ULPS, MIN_TOP1, _check_train, bf16_ulp

torch.set_num_threads(1)

ARCH = "seamless-m4t-large-v2"
#: seconds the spawn may take, start-up of every rank included
LIMIT_S = 150.0
STEPS = 2
MESHES = [(2, 2), (1, 4)]


def _cfg():
    return smoke_config(ARCHS[ARCH])


def _jcfg():
    return j_smoke_config(J_ARCHS[ARCH])


def _data_ranks(shape):
    return int(np.prod(shape[:-1]))


@pytest.fixture(scope="module")
def tree():
    return jax.tree_util.tree_map(np.asarray, j_build(_jcfg()).init(jax.random.PRNGKey(0)))


# ------------------------------------------------------------- the reference
def _reference_train(tree, d):
    """The reference's jitted step at microbatches ``d`` (b 8, s 32): every
    step's metrics, its loss's step-0 gradient (the microbatches' mean) and
    the final weights, by reference path."""
    jcfg = _jcfg()
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
                             seq_override=tpr.S)
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


def _reference_route(tree):
    """The reference's prefill (the encoder frames and the prompts) and
    forced decode steps, no compression: the last position's logits of
    each (b, vocab)."""
    jb = j_build(_jcfg())
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    prompts, forced, frames = tpr.serve_inputs(_cfg())
    S = tpr.SERVE
    prefill = jax.jit(functools.partial(jb.prefill, impl="xla"))
    decode = jax.jit(functools.partial(jb.decode_step, impl="xla"))
    caches = jb.init_caches(S["batch"], S["prompt"] + S["steps"], enc_len=tpr.ENC_LEN)
    logits, caches = prefill(params, caches, {
        "tokens": jnp.asarray(prompts, jnp.int32),
        "frames": jnp.asarray(frames, jnp.bfloat16)})
    out = [np.asarray(logits[:, -1], np.float32)]
    for i in range(S["steps"]):
        logits, caches = decode(params, caches,
                                {"tokens": jnp.asarray(forced[:, i:i + 1], jnp.int32)})
        out.append(np.asarray(logits[:, -1], np.float32))
    return out


def _reference_oracles(tree):
    out = {("train", d): _reference_train(tree, d)
           for d in sorted({_data_ranks(s) for s in MESHES})}
    out["serve"] = _reference_route(tree)
    return out


@pytest.fixture(scope="module")
def reference(tree):
    """The reference's oracles, computed in a thread while the ranks run."""
    pool = ThreadPoolExecutor(1)
    yield pool.submit(_reference_oracles, tree)
    pool.shutdown()


@pytest.fixture(scope="module")
def one_device(tree):
    out = {("train", d): tpr.train_run(_cfg(), tree, STEPS, microbatches=d)
           for d in sorted({_data_ranks(s) for s in MESHES})}
    out["serve"] = tpr.forced_route(_cfg(), tree, compress=False)
    return out


@pytest.fixture(scope="module")
def ranks(tree, reference, one_device, tmp_path_factory):
    """The one spawn of 4 ranks: at each mesh the train job twice (the
    repeat) and the serve job."""
    jobs = []
    for shape in MESHES:
        first = dict(shape=shape, cfg=_cfg(), tree=tree, kind="train", steps=STEPS,
                     tag="train")
        jobs += [first, dict(first, tag="repeat"),
                 dict(shape=shape, cfg=_cfg(), tree=tree, kind="serve", compress=False,
                      layout=True, tag="serve")]
    jobs[0]["mailboxes"] = (str(tmp_path_factory.mktemp("boxes")), 1 << 16)
    outs = port_mesh.spawn_ranks(tpr.tp_jobs, 4, backend="gloo", device="cpu",
                                 init_dir=str(tmp_path_factory.mktemp("encdec")),
                                 args=(jobs,), timeout=LIMIT_S)
    got = {}
    for r, rank_outs in enumerate(outs):
        for job, res in zip(jobs, rank_outs, strict=True):
            assert res["rank"] == r
            got.setdefault((job["tag"], tuple(job["shape"])), []).append(res)
    return got


def _port_run(run: dict) -> dict:
    def by_path(named):
        return {path: np.stack(parts) if len(parts) > 1 else parts[0]
                for path, parts in tree_flatten_with_paths(named, cfg=_cfg())}

    return dict(mets=run["mets"], grads0=by_path(run["grads0"]),
                params=by_path(run["params"]))


# ------------------------------------------------------------- training
@pytest.mark.parametrize("shape", MESHES)
def test_encdec_step_within_the_train_bounds(ranks, one_device, reference, shape):
    """Against the port's one-device step at microbatches = data ranks."""
    d = _data_ranks(shape)
    want = _port_run(one_device[("train", d)])
    grads_ref = reference.result()[("train", d)]["grads0"]
    for o in ranks[("train", shape)]:
        _check_train(_port_run(o), want, grads_ref, ARCH, ("rank", o["rank"]))


@pytest.mark.parametrize("shape", MESHES)
def test_encdec_step_within_the_reference_bounds(ranks, one_device, reference, shape):
    """Against the reference's jitted one-device step and its loss's step-0
    gradient; the port's one-device step too."""
    want = reference.result()[("train", _data_ranks(shape))]
    _check_train(_port_run(one_device[("train", _data_ranks(shape))]), want,
                 want["grads0"], ARCH, "one device", lr_ulps=1)
    for o in ranks[("train", shape)]:
        _check_train(_port_run(o), want, want["grads0"], ARCH, ("rank", o["rank"]),
                     lr_ulps=1)


@pytest.mark.parametrize("shape", MESHES)
def test_encdec_step_is_bitwise_on_repeat_and_across_ranks(ranks, shape):
    runs, again = ranks[("train", shape)], ranks[("repeat", shape)]
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
    # the norms (ln1, ln2 of the encoder; ln1, ln_x, ln2 of the decoder;
    # ln_enc, ln_f)
    cfg = _cfg()
    assert len(runs[0]["replicated"]) == 2 * cfg.n_enc_layers + 3 * cfg.n_layers + 2


# ------------------------------------------------------------- serving
def _check_logits(got, want, what):
    top1 = []
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        assert g.shape == w.shape and np.isfinite(g).all(), (what, i)
        err = float(np.abs(g - w).max())
        assert err <= LOGIT_ULPS * bf16_ulp(float(np.abs(w).max())), (what, i, err)
        top1 += list(g.argmax(-1) == w.argmax(-1))
    assert np.mean(top1) >= MIN_TOP1, (what, np.mean(top1))


@pytest.mark.parametrize("shape", MESHES)
def test_encdec_server_within_lm_parity_limits(ranks, one_device, shape):
    """The prefill's and each forced step's logits within lm_parity's
    limits of the port's one device; each rank's self-attention and cross
    k/v caches hold its kv heads."""
    want = one_device["serve"]
    cfg = _cfg()
    for o in ranks[("serve", shape)]:
        _check_logits(o["logits"], want["logits"], ("rank", o["rank"]))
        per = cfg.n_kv_heads // shape[-1]
        assert o["heads"] == (o["coords"]["model"] * per, (o["coords"]["model"] + 1) * per)
        for c in o["raw"]["layers"]:
            assert c["k"].shape[1] == per and c["slots"] is None
            assert c["cross_heads"] == per


@pytest.mark.parametrize("shape", MESHES)
def test_encdec_server_within_lm_parity_limits_of_the_reference(ranks, one_device,
                                                                reference, shape):
    want = reference.result()["serve"]
    _check_logits(one_device["serve"]["logits"], want, "one device")
    for o in ranks[("serve", shape)]:
        _check_logits(o["logits"], want, ("rank", o["rank"]))


# ------------------------------------------------------------- no processes
@pytest.mark.parametrize("model_ranks", [4, 16])
def test_rank_param_count_and_check_fits_divide_the_encdec(model_ranks, monkeypatch):
    """seamless-m4t-large-v2 at full size on the meta device: a rank holds
    1/M of every projection, MLP matrix and the vocabulary (the tied table),
    every norm whole; ``check_fits`` reckons its state from that count."""
    cfg = ARCHS[ARCH]
    d, hd, f = cfg.d_model, cfg.head_dim, cfg.d_ff
    attn = d * cfg.n_heads * hd * 2 + d * cfg.n_kv_heads * hd * 2
    mlp = 2 * d * f  # gelu: up and down
    sharded = (cfg.padded_vocab_size * d
               + cfg.n_enc_layers * (attn + mlp) + cfg.n_layers * (2 * attn + mlp))
    if not cfg.tie_embeddings:
        sharded += d * cfg.padded_vocab_size
    norms = d * (2 * cfg.n_enc_layers + 3 * cfg.n_layers + 2)
    want = sharded // model_ranks + norms
    assert launcher.rank_param_count(cfg, model_ranks) == want
    assert launcher.param_count(cfg) == sharded + norms
    need = {}

    class Props:
        total_memory = 80 * 10 ** 9

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: Props)
    launcher.check_fits(cfg, torch.device("cuda"), data_ranks=16, model_ranks=model_ranks)
    need["state"] = launcher.state_bytes_per_rank(want, 16)
    assert need["state"] == want * (8 + 8 / 16)
    with pytest.raises(ValueError, match="cut the depth"):
        launcher.check_fits(cfg, torch.device("cuda"), data_ranks=1,
                            ranks_per_card=64, model_ranks=model_ranks)
