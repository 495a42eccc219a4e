"""Expert parallelism and Mamba heads on the model axis, on gloo ranks on the
CPU: the MoE, SSM and hybrid families held against the port's one-device
paths and the reference's one-device paths (its sharded step is no oracle
under jax 0.9), as tests/test_torch_tp.py holds the dense and VLM ones.
Every model starts from the reference's weights
(``convert.params_from_tree``, then ``tensor_parallel.shard_model``).

Routing is a step function of the router's probabilities, so every MoE
call of every run here replays the reference's routing
(``chip_smoke.RoutingPin``; tests/test_torch_train_families.py): the
reference's jitted step at microbatches = data ranks (remat "none", which
routes each token once) records its top-k choices, and the port's
one-device step and every rank replay them, a data rank its microbatch's
calls, a token taking the recorded choice only where its own differs among
experts within 2^-5 of its top-k boundary; any other difference fails.

One spawn of 4 ranks (tests/torch_tp_ranks.py, every copy through host
mailboxes as ranks sharing a card send them) runs the smoke deepseek-moe-16b
(a dense layer, then MoE layers with shared experts), llama4-scout (top-1,
a shared expert), mamba2-370m (8 SSD heads) and jamba (Mamba, attention and
MoE layers) at (data 2, model 2) and (data 1, model 4), and two variants at
(1, 4): deepseek with 6 experts (they do not divide 4 ranks: the MoE runs
replicated, ``moe_specs``' P(None, None, None)) and mamba2 with 2 heads of
64 (d_inner divides 4 ranks, the heads do not: the column specs split a
head, and the block runs replicated on gathered weights):

  * the step against the port's and the reference's one-device step at
    microbatches = data ranks, within tests/test_torch_tp.py's bounds;
  * a repeat bitwise, and every replicated leaf (the router among them)
    bitwise equal across the model ranks;
  * prefill, one compression and forced decode steps within ``lm_parity``'s
    limits of the port's and the reference's one device, each rank's
    compressed slots >= 0.999 equal to the one-device compression of the
    ranks' raw caches put together (jamba and deepseek; mamba2 holds no
    attention cache);
  * the model drawn from a seed on a mesh bitwise the one-device draw
    sliced.

Without processes: the layout each configuration takes, and
``launch.train.rank_param_count`` / ``check_fits`` of deepseek and jamba
at full size on the meta device at 4 and 16 model ranks against a count
written out here (the experts and the Mamba leaves divided by M).
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
from repro.serve.kv_compression import compress_model_caches as j_compress_model_caches
from repro.train import OptConfig as JOptConfig
from repro.train import init_opt_state as j_init_opt
from repro.train import make_train_step as j_make_train_step
from repro.utils.tree import tree_flatten_with_paths as j_flatten
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import train as launcher
from repro_torch.models import mamba2
from repro_torch.models.moe import moe_specs
from repro_torch.models.tensor_parallel import TensorParallel, model_dim, shard_params
from repro_torch.utils.tree import tree_flatten_with_paths
from test_torch_lm_families import reference_routing
from test_torch_tp import (
    LOGIT_ULPS,
    MIN_SLOTS,
    MIN_TOP1,
    _check_train,
    _slot_agreement,
    _whole_raw,
    bf16_ulp,
)

torch.set_num_threads(1)

#: seconds the spawn may take, start-up of every rank included
LIMIT_S = 240.0
#: the step-0 gradients' bound against the reference's, bf16 ulps of a
#: leaf's largest |g|: the port's own one-device step reads up to 9.1 ulps
#: there on these families (jamba's expert gate, deepseek's attention out
#: projection, mamba2's conv at 2 heads of 64), past tests/test_torch_tp.py's
#: 8: the bf16 backward's rounding through the MoE and SSD blocks in two
#: packages. The losses, grad norms and weights keep their bounds
GRAD_ULPS_EP = 16
#: the mesh against the port's one-device step keeps the 8 (``GRAD_ULPS``),
#: save the two leaves of one run that read past it, which take 16: the
#: replicated 6-expert MoE at (1, 4) reads 9.0 ulps at layer 0's
#: ``attn.wk`` and 9.4 at its ``ln1`` (the rounding of the row-parallel
#: partials' rank-order sums; every other leaf of every run reads at most
#: 7.9, deepseek's ``attn.wo`` at (2, 2))
MESH_LEAF_ULPS = {"deepseek-moe-16b-6experts": {"stack/0/attn/wk": GRAD_ULPS_EP,
                                                "stack/0/ln1": GRAD_ULPS_EP}}
STEPS = 2
ARCHS_EP = ("deepseek-moe-16b", "llama4-scout-17b-a16e", "mamba2-370m",
            "jamba-v0.1-52b")
#: smoke archs with other counts: 6 experts (replicated over 4 model
#: ranks) and 2 SSD heads of 64 (a head split over 4 model ranks)
VARIANTS = {"deepseek-moe-16b-6experts": ("deepseek-moe-16b", dict(n_experts=6)),
            "mamba2-370m-2heads": ("mamba2-370m", dict(ssm_head_dim=64))}
RUNS = ([((2, 2), a) for a in ARCHS_EP] + [((1, 4), a) for a in ARCHS_EP]
        + [((1, 4), a) for a in VARIANTS])
ALL_ARCHS = ARCHS_EP + tuple(VARIANTS)
#: (mesh, arch, trainable) of the seeded draws on a mesh
DRAWS = [((2, 2), "deepseek-moe-16b", True), ((1, 4), "jamba-v0.1-52b", False),
         ((1, 4), "mamba2-370m-2heads", True)]


def _data_ranks(shape):
    return int(np.prod(shape[:-1]))


def _cfg(arch):
    base, kw = VARIANTS.get(arch, (arch, {}))
    return dataclasses.replace(smoke_config(ARCHS[base]), **kw)


def _jcfg(arch):
    base, kw = VARIANTS.get(arch, (arch, {}))
    return dataclasses.replace(j_smoke_config(J_ARCHS[base]), **kw)


def _moe(arch) -> bool:
    return bool(_cfg(arch).n_experts)


@pytest.fixture(scope="module")
def trees():
    """The reference's initial parameters of each smoke arch (numpy; its
    init jitted, a quicker draw of the same distribution)."""
    return {a: jax.tree_util.tree_map(np.asarray, jax.jit(j_build(_jcfg(a)).init)(
        jax.random.PRNGKey(0))) for a in ALL_ARCHS}


# ------------------------------------------------------------- the reference
def _reference_train(arch, tree, d):
    """The reference's jitted step at microbatches ``d`` (remat "none") from
    ``tree``: every step's metrics and MoE routing, the step-0 gradient
    (the microbatches' mean; read back from AdamW's first moment, m_1 =
    (1 - b1)·scale·g, within a few f32 ulps) and the final weights, by
    path."""
    jcfg = _jcfg(arch)
    jb = j_build(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    opt = j_init_opt(params)
    ocfg = JOptConfig(**tpr.SCHED)
    pin = tpr.routing_pin([])
    mets, routing, grads0 = [], [], None
    with reference_routing(pin):
        step = jax.jit(j_make_train_step(jb, ocfg,
                                         JParallelConfig(remat="none", microbatches=d)))
        for s in range(STEPS):
            pin.calls = []
            batch = j_make_batch(jcfg, J_SHAPES["train_4k"], s, batch_override=tpr.B,
                                 seq_override=tpr.S)
            params, opt, m = step(params, opt, batch)
            mets.append({k: float(v) for k, v in m.items()})
            jax.effects_barrier()
            routing.append([np.asarray(c) for c in pin.calls])
            if s == 0:
                gn = np.float32(mets[0]["grad_norm"])
                scale = np.minimum(np.float32(1.0), np.float32(ocfg.clip_norm)
                                   / np.maximum(gn, np.float32(1e-12)))
                grads0 = {path: np.asarray(m1) / (np.float32(1 - ocfg.b1) * scale)
                          for path, m1 in j_flatten(opt["m"])}
    return dict(mets=mets, grads0=grads0, routing=routing if _moe(arch) else None,
                params=dict(j_flatten(jax.tree_util.tree_map(np.asarray, params))))


def _reference_route(arch, tree):
    """The reference's serving of SERVE's prompts: prefill, one compression,
    the forced decode steps; the last position's logits of each (b, vocab)
    and its MoE routing."""
    jb = j_build(_jcfg(arch))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    prompts, forced, _ = tpr.serve_inputs(_cfg(arch))
    S = tpr.SERVE
    pin = tpr.routing_pin([])
    pin.calls = []
    with reference_routing(pin):
        prefill = jax.jit(functools.partial(jb.prefill, impl="xla"))
        decode = jax.jit(functools.partial(jb.decode_step, impl="xla"))
        caches = jb.init_caches(S["batch"], S["prompt"] + S["steps"])
        logits, caches = prefill(params, caches,
                                 {"tokens": jnp.asarray(prompts, jnp.int32)})
        out = [np.asarray(logits[:, -1], np.float32)]
        caches = j_compress_model_caches(caches, S["t"], S["m"], tail=S["tail"],
                                         impl="ref")
        for i in range(S["steps"]):
            logits, caches = decode(params, caches,
                                    {"tokens": jnp.asarray(forced[:, i:i + 1], jnp.int32)})
            out.append(np.asarray(logits[:, -1], np.float32))
        jax.effects_barrier()
    return dict(logits=out, routing=[np.asarray(c) for c in pin.calls]
                if _moe(arch) else None)


def _keys():
    """Every reference oracle, those whose routing the MoE runs wait for
    first (the train runs, then the serving routes)."""
    train = list(dict.fromkeys(("train", _data_ranks(shape), arch) for shape, arch in RUNS))
    serve = [("serve", arch) for arch in ALL_ARCHS]
    return sorted(train + serve, key=lambda k: (not _moe(k[-1]), k[0] == "serve"))


def _pins_file(pin_dir, key) -> str:
    return str(pin_dir / "-".join(map(str, key)))


def _reference_oracles(trees, pin_dir):
    """Every reference oracle in :func:`_keys`' order, each MoE run's
    routing written for the ranks as soon as it is known."""
    out = {}
    try:
        for key in _keys():
            arch = key[-1]
            out[key] = (_reference_train(arch, trees[arch], key[1]) if key[0] == "train"
                        else _reference_route(arch, trees[arch]))
            if out[key]["routing"] is not None:
                tpr.write_pins(_pins_file(pin_dir, key), out[key]["routing"])
    except BaseException:
        (pin_dir / tpr.PINS_FAILED).touch()
        raise
    return out


@pytest.fixture(scope="module")
def oracles(trees, tmp_path_factory):
    """The reference's oracles, in a thread, and the one spawn of 4 ranks,
    at once: each run's train job twice (the repeat) and its serve job, a
    MoE job waiting for the reference's routing of its run (the SSM runs
    and the seeded draws of DRAWS go first); then the port's one-device
    oracles under the same routing. {"reference", "ranks", "one_device"}."""
    pin_dir = tmp_path_factory.mktemp("pins")
    pool = ThreadPoolExecutor(1)
    fut = pool.submit(_reference_oracles, trees, pin_dir)
    jobs = []
    for shape, arch, trainable in DRAWS:
        jobs.append(dict(shape=shape, cfg=_cfg(arch), arch=arch, kind="init",
                         trainable=trainable, tag=f"init-{trainable}"))
    for shape, arch in sorted(RUNS, key=lambda r: _moe(r[1])):
        base = dict(shape=shape, cfg=_cfg(arch), tree=trees[arch], arch=arch)
        train_key = ("train", _data_ranks(shape), arch)
        first = dict(base, kind="train", steps=STEPS, tag="train", remat="none",
                     pins_file=_pins_file(pin_dir, train_key) if _moe(arch) else "")
        jobs += [first, dict(first, tag="repeat"),
                 dict(base, kind="serve", tag="serve",
                      pins_file=_pins_file(pin_dir, ("serve", arch)) if _moe(arch)
                      else "")]
    jobs[0]["mailboxes"] = (str(tmp_path_factory.mktemp("boxes")), 1 << 16)
    try:
        outs = port_mesh.spawn_ranks(tpr.tp_jobs, 4, backend="gloo", device="cpu",
                                     init_dir=str(tmp_path_factory.mktemp("ep")),
                                     args=(jobs,), timeout=LIMIT_S)
    finally:
        reference = fut.result()
        pool.shutdown()
    got = {}
    for r, rank_outs in enumerate(outs):
        for job, res in zip(jobs, rank_outs, strict=True):
            assert res["rank"] == r
            got.setdefault((job["tag"], tuple(job["shape"]), job["arch"]), []).append(res)
    one = {}
    for key in _keys():
        arch = key[-1]
        if key[0] == "train":
            one[key] = tpr.train_run(_cfg(arch), trees[arch], STEPS, microbatches=key[1],
                                     remat="none", pins=reference[key]["routing"])
        else:
            one[key] = tpr.forced_route(_cfg(arch), trees[arch],
                                        pins=reference[key]["routing"])
    return dict(reference=reference, ranks=got, one_device=one)


@pytest.fixture(scope="module")
def reference(oracles):
    return oracles["reference"]


@pytest.fixture(scope="module")
def ranks(oracles):
    return oracles["ranks"]


@pytest.fixture(scope="module")
def one_device(oracles):
    return oracles["one_device"]


def _by_path(named: dict, arch) -> dict:
    """{reference path: array} of a port model's arrays keyed by parameter
    name (the per-layer leaves stacked)."""
    return {path: np.stack(parts) if len(parts) > 1 else parts[0]
            for path, parts in tree_flatten_with_paths(named, cfg=_cfg(arch))}


def _port_run(run: dict, arch) -> dict:
    return dict(mets=run["mets"], grads0=_by_path(run["grads0"], arch),
                params=_by_path(run["params"], arch))


# ------------------------------------------------------------- the layouts
class _Axis:
    def __init__(self, size, index=0):
        self.size, self.index = size, index


@pytest.mark.parametrize("arch,tp,experts,mamba", [
    ("deepseek-moe-16b", 2, True, None), ("deepseek-moe-16b", 4, True, None),
    ("deepseek-moe-16b-6experts", 4, False, None),
    ("llama4-scout-17b-a16e", 4, True, None),
    ("mamba2-370m", 4, None, True), ("mamba2-370m-2heads", 4, None, False),
    ("jamba-v0.1-52b", 4, True, True)])
def test_each_configuration_takes_its_layout(arch, tp, experts, mamba):
    """Expert parallel where the ranks divide the experts, else replicated;
    Mamba by heads where they divide the heads, else replicated with the
    (column-split) weights gathered whole."""
    cfg = _cfg(arch)
    lay = TensorParallel(cfg, _Axis(tp), {})
    if experts is not None:
        assert lay.experts_local == experts
        assert (model_dim(moe_specs(cfg, "model", tp)["gate"]) == 0) == experts
        p = type("P", (), {"gate": torch.empty(cfg.n_experts // tp if experts else
                                               cfg.n_experts, 1, 1)})()
        share = lay.expert_share(p)
        assert share == ((0, cfg.n_experts // tp) if experts else None)
    if mamba is not None:
        assert lay.mamba_local == mamba
        d_in, h, _, _ = mamba2.dims(cfg)
        assert lay.mamba_dims["wz"] == 1 and d_in % tp == 0  # the columns split
        assert (lay.mamba_dims["A_log"] == 0) == mamba == (h % tp == 0)


# ------------------------------------------------------------- the step
#: the tokens a rank's step past the first may take pinned beyond a
#: near-tie, a share of its slots: the mesh's weights after a step differ
#: from the reference's by up to 2·lr an element (an element whose gradient
#: is near 0 may step either way), which moves a router's probabilities
#: past 2^-5 of the top-k boundary for a few tokens
MAX_FAR_SHARE = 0.02


def _no_far(pins):
    for p in pins:
        assert p["far"] == 0, p


def _far_pinned(pins, slots: int):
    """A rank's train pins: none beyond a near-tie at the first step (the
    same weights), few after it; their counts reported."""
    _no_far(pins[:1])
    for p in pins[1:]:
        assert p["far"] <= MAX_FAR_SHARE * slots, p


@pytest.mark.parametrize("shape,arch", RUNS)
def test_ep_step_within_the_train_bounds(ranks, one_device, reference, shape, arch):
    """Against the port's one-device step at microbatches = data ranks, both
    under the reference's routing (no token pinned beyond a near-tie)."""
    key = ("train", _data_ranks(shape), arch)
    want = _port_run(one_device[key], arch)
    _no_far(one_device[key]["pins"])
    grads_ref = reference[key]["grads0"]
    cfg = _cfg(arch)
    slots = tpr.B * tpr.S // _data_ranks(shape) * max(cfg.n_experts_per_tok, 1)
    for o in ranks[("train", shape, arch)]:
        assert len(o["pins"]) == (STEPS if _moe(arch) else 0)
        _far_pinned(o["pins"], slots)
        _check_train(_port_run(o, arch), want, grads_ref, arch, ("rank", o["rank"]),
                     leaf_ulps=MESH_LEAF_ULPS.get(arch))


@pytest.mark.parametrize("shape,arch", RUNS)
def test_ep_step_within_the_reference_bounds(ranks, one_device, reference, shape, arch):
    """Against the reference's jitted one-device step at microbatches =
    data ranks (its metrics and weights) and its loss's step-0 gradient;
    the port's one-device step against it too."""
    key = ("train", _data_ranks(shape), arch)
    want = reference[key]
    _check_train(_port_run(one_device[key], arch), want, want["grads0"], arch,
                 "one device", lr_ulps=1, grad_ulps=GRAD_ULPS_EP)
    for o in ranks[("train", shape, arch)]:
        _check_train(_port_run(o, arch), want, want["grads0"], arch, ("rank", o["rank"]),
                     lr_ulps=1, grad_ulps=GRAD_ULPS_EP)


@pytest.mark.parametrize("shape,arch", RUNS)
def test_ep_step_is_bitwise_on_repeat_and_across_ranks(ranks, shape, arch):
    """A second run the same bits; every replicated leaf (norms, the
    router, B/C/conv of Mamba, a replicated MoE's experts) and every
    gathered leaf the same bits on every rank."""
    runs, again = ranks[("train", shape, arch)], ranks[("repeat", shape, arch)]
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
    rep = runs[0]["replicated"]
    cfg = _cfg(arch)
    if cfg.n_experts:
        assert any(n.endswith("moe.router") for n in rep)
    if cfg.ssm_state:
        assert any(n.endswith("mamba.wB") for n in rep)


# ------------------------------------------------------------- the server
@pytest.mark.parametrize("shape,arch", RUNS)
def test_ep_server_within_lm_parity_limits(ranks, one_device, shape, arch):
    """Logits of the prefill and of each forced decode step within
    lm_parity's limits of one device; each rank's compressed attention
    caches the one-device compression of the ranks' raw caches put
    together."""
    from repro_torch.serve.kv_compression import compress_model_caches

    want = one_device[("serve", arch)]
    outs = ranks[("serve", shape, arch)]
    S = tpr.SERVE
    cfg = _cfg(arch)
    together = None
    if cfg.n_heads:
        together = compress_model_caches(_whole_raw(outs, cfg), S["t"], S["m"],
                                         tail=S["tail"])["layers"]
    if _moe(arch):
        _no_far([want["pins"]])
    for o in outs:
        if _moe(arch):
            _no_far([o["pins"]])
        top1 = []
        for i, (g, w) in enumerate(zip(o["logits"], want["logits"], strict=True)):
            assert g.shape == w.shape and np.isfinite(g).all()
            bound = LOGIT_ULPS * bf16_ulp(float(np.abs(w).max()))
            assert float(np.abs(g - w).max()) <= bound, (i, float(np.abs(g - w).max()))
            top1 += list(g.argmax(-1) == w.argmax(-1))
        assert np.mean(top1) >= MIN_TOP1, np.mean(top1)
        if together is not None:
            assert _slot_agreement(o["caches"], together, o["rows"], o["heads"]) \
                >= MIN_SLOTS


@pytest.mark.parametrize("shape,arch", RUNS)
def test_ep_server_within_lm_parity_limits_of_the_reference(
        ranks, one_device, reference, shape, arch):
    """Logits of the prefill and of each forced decode step within
    lm_parity's limits of the reference's prefill, compression and decode
    on the same prompts; the port's one-device route too."""
    want = reference[("serve", arch)]["logits"]
    runs = [("one device", one_device[("serve", arch)]["logits"])]
    runs += [(("rank", o["rank"]), o["logits"]) for o in ranks[("serve", shape, arch)]]
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
def test_a_seeded_ep_draw_on_a_mesh_is_the_one_device_draw_sliced(ranks, shape, arch,
                                                                   trainable):
    """``bundle.init(mesh=)``: each rank's experts and Mamba heads drawn one
    whole leaf at a time, bitwise the one-device draw, sliced."""
    from repro_torch.models import build

    cfg = _cfg(arch)
    bundle = build(cfg)
    specs = bundle.param_specs(tp="model", tp_size=shape[-1])
    sharded = [n for n, sp in specs.items() if model_dim(sp) is not None]
    assert any(".moe." in n or ".mamba." in n for n in sharded)
    for o in ranks[(f"init-{trainable}", shape, arch)]:
        one = bundle.init(torch.Generator().manual_seed(11), device="cpu",
                          trainable=trainable)
        shard_params(one, specs, {"model": (o["coords"]["model"], shape[-1])})
        assert sorted(o["local"]) == sorted(n for n, _ in one.named_parameters())
        for n, p in one.named_parameters():
            assert o["local"][n].tobytes() == tpr._np(p).tobytes(), (o["rank"], n)


# ------------------------------------------------------------- the reckoning
def _sharded_by_hand(cfg, name: str, m: int) -> bool:
    """Whether a rank holds 1/m of leaf ``name``, written out from the
    layouts (not from the specs)."""
    leaf = name.rsplit(".", 1)[-1]
    d_in, h, _, _ = mamba2.dims(cfg) if cfg.ssm_state else (0, 0, 0, 0)
    if name.startswith("embed."):
        return True
    if ".attn." in name:
        return leaf in ("wq", "wo") or (cfg.n_kv_heads * cfg.head_dim) % m == 0
    if ".moe." in name and ".shared." not in name:
        return leaf != "router" and cfg.n_experts % m == 0
    if ".mamba." in name:
        if leaf in ("wz", "wx", "out"):
            return d_in % m == 0
        return leaf in ("wdt", "A_log", "D", "dt_bias") and h % m == 0
    return ".mlp." in name or ".shared." in name  # the MLP pairs; else norms


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "jamba-v0.1-52b"])
@pytest.mark.parametrize("m", [4, 16])
def test_rank_param_count_divides_experts_and_mamba_leaves(arch, m, monkeypatch):
    """At full size on the meta device: a rank's parameters are every
    replicated leaf and 1/M of each sharded one, the experts and the Mamba
    leaves among them; ``check_fits`` reckons from that count (the whole
    deepseek's 262 GB of state, over (16 data, 16 model) ranks, fits a
    card)."""
    cfg = ARCHS[arch]
    named = launcher._meta_params(cfg)
    want = sum(p.numel() // (m if _sharded_by_hand(cfg, n, m) else 1)
               for n, p in named.items())
    got = launcher.rank_param_count(cfg, m)
    assert got == want
    experts = sum(p.numel() for n, p in named.items()
                  if ".moe." in n and ".shared." not in n and not n.endswith("router"))
    ssm = sum(p.numel() for n, p in named.items() if ".mamba." in n
              and n.rsplit(".", 1)[-1] in ("wz", "wx", "out", "wdt", "A_log", "D",
                                           "dt_bias"))
    total = sum(p.numel() for p in named.values())
    # the experts and Mamba leaves count 1/M each
    assert total - got >= (experts + ssm) * (m - 1) // m
    assert experts > 0 and (ssm > 0) == (arch == "jamba-v0.1-52b")

    card = type("P", (), {"total_memory": 80 * 10 ** 9})()
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: card)
    dev = torch.device("cuda")
    if arch == "deepseek-moe-16b":
        with pytest.raises(ValueError, match="training holds"):
            launcher.check_fits(cfg, dev)  # 262 GB on one card
    launcher.check_fits(cfg, dev, data_ranks=16, model_ranks=16)
    need = launcher.state_bytes_per_rank(launcher.rank_param_count(cfg, 16), 16)
    assert need < 80e9
