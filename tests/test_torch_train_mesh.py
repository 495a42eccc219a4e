"""The trainer's data axes on ``torch.distributed`` (gloo ranks on the CPU)
against the one-device port and the reference, at ``smoke_config``
(gemma2-2b, b 8, s 32, the schedule of tests/test_torch_train.py).

Ranks are spawned processes (``repro_torch.launch.mesh.spawn_ranks``: a
``file://`` rendezvous in a temporary directory, a timeout on every
collective and on the whole run). One spawn per mesh runs several jobs
(tests/torch_mesh_ranks.py), and each test reads its part:

  * ``zero_opt_specs`` / ``_zero_spec_for`` and ``batch_specs`` equal to
    the reference's, PartitionSpecs read as tuples;
  * the data-parallel step over P = 2, P = 4 and a (pod 2, data 2) mesh:
    losses, grad norms, weights and the moments gathered from the ZeRO
    shards bitwise the port's one-device step at ``microbatches = P``, and
    within test_torch_train.py's bounds of the reference's jitted step at
    the same microbatches; ``zero_stage`` 0 bitwise 1; ``master=True``
    bitwise its one-device twin; a batch the ranks do not divide taken
    whole;
  * the elastic restore: a checkpoint written after step 2 at P = 4
    continues at P = 2 and at P = 1 (the one-device trainer) bitwise the
    one-device schedule (2 steps at microbatches 4, save, restore, 2 steps
    at microbatches 2 or 1), and its arrays load into the reference's
    ``CheckpointManager.restore``;
  * ``run_training`` with a step failing once on every rank, equal to the
    run without it; the launcher's ``train`` over data ranks with a
    checkpoint and a resume;
  * ``compressed_psum``, ``psum_with_error_feedback`` (16 rounds) and
    ``tree_compressed_psum`` on 8 ranks bitwise the reference's under
    ``shard_map`` on 8 CPU devices;
  * ``check_fits``'s mesh reckoning (and, on a model axis, the peak while
    the model is drawn), and ``--mesh debug|pod1|pod2`` (item 7c): debug
    spawns 8 ranks, pod1 and pod2 need torchrun;
  * ``chip_smoke.py``'s ``train_mesh`` and ``mesh_tp`` phases rehearsed on
    the CPU at smoke size (every check of the phase run, none failing).
"""
import json
import os
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
import torch_mesh_ranks as ranks
from jax.sharding import PartitionSpec as P

from repro.configs import ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import smoke_config as j_smoke_config
from repro.configs.base import ParallelConfig as JParallelConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data import make_batch as j_make_batch
from repro.launch.mesh import batch_specs as j_batch_specs
from repro.models import build as j_build
from repro.train import CheckpointManager as JCheckpointManager
from repro.train import OptConfig as JOptConfig
from repro.train import init_opt_state as j_init_opt
from repro.train import make_train_step as j_make_train_step
from repro.train.optimizer import _zero_spec_for as j_zero_spec_for
from repro.train.optimizer import zero_opt_specs as j_zero_opt_specs
from repro.utils.tree import tree_flatten_with_paths as j_flatten
from repro_torch.configs import ARCHS, SHAPES, ParallelConfig, smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import train as launcher
from repro_torch.models import build
from repro_torch.train import CheckpointManager, OptConfig, init_opt_state, make_train_step
from repro_torch.train.optimizer import _zero_spec_for, zero_opt_specs
from repro_torch.utils.tree import tree_flatten_with_paths

sys.path.append(str(Path(__file__).resolve().parent.parent))  # chip_smoke.py

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: seconds a spawn may take, start-up of every rank included
LIMIT_S = 150.0
#: loss and grad norm against the reference (tests/test_torch_train.py)
LOGIT_ULPS = 8
MESHES = {"data2": {"data": 2}, "data4": {"data": 4},
          "pod2_data2": {"pod": 2, "data": 2},
          "pod2_data4_model8": {"pod": 2, "data": 4, "model": 8}}


def bf16_ulp(x: float) -> float:
    return float(2.0 ** (np.floor(np.log2(abs(x))) - 7))


def _np(tree_):
    return jax.tree_util.tree_map(np.asarray, tree_)


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype,
                                                       a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), f"{what}: differs"


# ------------------------------------------------------------- (a) ZeRO specs
def _spec_tuple(spec):
    return tuple(spec)


def _flat_specs(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
            for path, leaf in leaves}


def test_zero_specs_match_the_reference_on_its_own_cases():
    pspecs = {"w": P(None, "model"), "b": P("model"), "tiny": P(None)}
    shapes = {"w": (64, 32), "b": (128,), "tiny": (3,)}
    mesh_shape = {"pod": 2, "data": 4, "model": 8}
    want = j_zero_opt_specs(
        pspecs, {k: jax.ShapeDtypeStruct(v, np.float32) for k, v in shapes.items()},
        ("pod", "data"), mesh_shape)
    got = zero_opt_specs({k: _spec_tuple(v) for k, v in pspecs.items()}, shapes,
                         ("pod", "data"), mesh_shape)
    assert got["m"] == {k: _spec_tuple(v) for k, v in want["m"].items()}
    assert got["m"]["w"] == (("pod", "data"), "model")
    assert got["m"]["b"] == (("model", "pod", "data"),)
    assert got["m"]["tiny"] == (None,)
    assert got["step"] == _spec_tuple(want["step"]) == ()


@pytest.mark.parametrize("master", [False, True])
@pytest.mark.parametrize("zero_stage", [0, 1])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ["gemma2-2b", "deepseek-moe-16b"])
def test_zero_specs_match_the_reference_on_every_stacked_leaf(arch, mesh, zero_stage,
                                                              master):
    mesh_shape = MESHES[mesh]
    axes = tuple(a for a in ("pod", "data") if a in mesh_shape)
    jb = j_build(j_smoke_config(J_ARCHS[arch]))
    shapes = jax.eval_shape(jb.init, jax.random.PRNGKey(0))
    tp = "model" if "model" in mesh_shape else None
    pspecs = jb.param_specs(tp=tp, tp_size=mesh_shape.get("model", 1))
    want = j_zero_opt_specs(pspecs, shapes, axes, mesh_shape, zero_stage=zero_stage,
                            master=master)
    flat_specs = _flat_specs(pspecs)
    flat_shapes = {p: tuple(s.shape) for p, s in _flat_specs(shapes).items()}
    got = zero_opt_specs({p: _spec_tuple(s) for p, s in flat_specs.items()},
                         flat_shapes, axes, mesh_shape, zero_stage=zero_stage,
                         master=master)
    assert sorted(got) == sorted(want)
    for key in [k for k in want if k != "step"]:
        w = {p: _spec_tuple(s) for p, s in _flat_specs(want[key]).items()}
        assert got[key] == w, key
    for p, s in flat_specs.items():  # the fold alone, leaf by leaf
        assert _zero_spec_for(_spec_tuple(s), flat_shapes[p], axes, mesh_shape) == \
            _spec_tuple(j_zero_spec_for(s, flat_shapes[p], axes, mesh_shape)), p
    # the port's own per-layer tensors, replicated, as the trainer folds them
    if "model" not in mesh_shape:
        model = build(smoke_config(ARCHS[arch])).init(
            torch.Generator().manual_seed(0), device="meta", trainable=True)
        for n, p in model.named_parameters():
            assert _zero_spec_for((), tuple(p.shape), axes, mesh_shape) == \
                _spec_tuple(j_zero_spec_for(P(), tuple(p.shape), axes, mesh_shape)), n


# ------------------------------------------------------------- (b) batch specs
class _FakeMeshes:
    """One mesh shape as each package reads it: the reference's
    ``axis_names``/``shape``, the port's ``mesh_dim_names``/``size(i)``."""

    def __init__(self, shape: dict):
        self.ref = SimpleNamespace(axis_names=tuple(shape), shape=dict(shape))
        names = tuple(shape)
        self.port = SimpleNamespace(mesh_dim_names=names,
                                    size=lambda i: shape[names[i]])


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["gemma2-2b", "phi-3-vision-4.2b",
                                  "seamless-m4t-large-v2"])
def test_batch_specs_match_the_reference(arch, kind):
    for mesh_shape in MESHES.values():
        meshes = _FakeMeshes(mesh_shape)
        for b in (1, 2, 6, 8, 16):  # 16 and 8 divide every data size, 6 and 2 some
            want = j_batch_specs(J_ARCHS[arch], JShapeConfig("c", 64, b, kind),
                                 meshes.ref, kind=kind)
            got = port_mesh.batch_specs(ARCHS[arch], ShapeConfig("c", 64, b, kind),
                                        meshes.port, kind=kind)
            assert got == {k: _spec_tuple(v) for k, v in want.items()}, (mesh_shape, b)


# ------------------------------------------------------------- the oracles
@pytest.fixture(scope="module")
def init():
    """The reference's initial parameters and optimizer state (numpy)."""
    jb = j_build(j_smoke_config(J_ARCHS["gemma2-2b"]))
    params = jb.init(jax.random.PRNGKey(0))
    return _np(params), _np(j_init_opt(params))


@pytest.fixture(scope="module")
def reference(init):
    """The reference's jitted step at microbatches 2 and 4: metrics and
    parameters after each of four steps."""
    jcfg = j_smoke_config(J_ARCHS["gemma2-2b"])
    jb = j_build(jcfg)
    out = {}
    for mb in (2, 4):
        params = jax.tree_util.tree_map(jax.numpy.asarray, init[0])
        opt = j_init_opt(params)
        step = jax.jit(j_make_train_step(jb, JOptConfig(**ranks.SCHED),
                                         JParallelConfig(microbatches=mb)))
        mets, states = [], []
        for s in range(4):
            batch = j_make_batch(jcfg, J_SHAPES["train_4k"], s,
                                 batch_override=ranks.B, seq_override=ranks.S)
            params, opt, m = step(params, opt, batch)
            mets.append({k: float(v) for k, v in m.items()})
            states.append(_np(params))
        out[mb] = dict(mets=mets, params=states)
    return out


def _one_device(init_tree, steps, microbatches, *, master=False, batch=ranks.B,
                start=0, state=None):
    """The port's one-device step from the carried parameters (or
    ``state``), ``steps`` steps from ``start``: (metrics, model, opt)."""
    cfg, bundle, model = ranks._setup(init_tree, master=master)
    opt = init_opt_state(model, master=master)
    if state is not None:
        model, opt = state
    step = make_train_step(bundle, OptConfig(**ranks.SCHED),
                           ParallelConfig(remat="none", microbatches=microbatches))
    bfs = ranks.batch_for(cfg, batch)
    mets = []
    for s in range(start, start + steps):
        model, opt, m = step(model, opt, bfs(s))
        mets.append({k: ranks._np(m[k]) for k in ranks.METRICS})
    return mets, model, opt


def _same_run(got: dict, mets, model, opt, what):
    """A rank's run bitwise the one-device run: every step's metrics, the
    weights, the moments gathered from the shards and the step."""
    assert len(got["mets"]) == len(mets), what
    for s, (g, w) in enumerate(zip(got["mets"], mets, strict=True)):
        for k in ranks.METRICS:
            _same(g[k], w[k], f"{what}: step {s} {k}")
    for n, p in model.named_parameters():
        _same(got["params"][n], ranks._np(p), f"{what}: {n}")
    for key, moments in got["moments"].items():
        for n, t in moments.items():
            _same(t, ranks._np(opt[key][n]), f"{what}: {key} {n}")
    assert got["step"] == int(opt["step"]), what


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("mesh_ckpt"))


def _spawn(fn, n, job, tmp_path_factory, name):
    """Every rank's result of ``fn(rank, job)`` on ``n`` gloo ranks."""
    outs = port_mesh.spawn_ranks(fn, n, backend="gloo", device="cpu",
                                 init_dir=str(tmp_path_factory.mktemp(name)),
                                 args=(job,), timeout=LIMIT_S)
    for r, o in enumerate(outs):
        assert all(res["rank"] == r for res in (o if isinstance(o, list) else [o]))
    return outs


@pytest.fixture(scope="module")
def p4(init, ckpt_dir, tmp_path_factory):
    """P = 4 over ("data",): 4 steps, a checkpoint after steps 2 and 4."""
    job = dict(shape=(4,), names=("data",), init=init[0], steps=4, ckpt_dir=ckpt_dir,
               ckpt_every=2)
    return _spawn(ranks.mesh_run, 4, job, tmp_path_factory, "p4")


@pytest.fixture(scope="module")
def p2(init, p4, ckpt_dir, tmp_path_factory):
    """P = 2 over ("data",), in one spawn: zero_stage 1, the same with step
    2 failing once, zero_stage 0, master, the elastic restore of p4's step
    2 checkpoint, a batch of 3 rows, and the launcher with a resume."""
    base = dict(shape=(2,), names=("data",), init=init[0], steps=3)
    jobs = [dict(base), dict(base, fail_at=2), dict(base, zero_stage=0),
            dict(base, master=True),
            dict(base, steps=4, restore=2, ckpt_dir=ckpt_dir),
            dict(base, steps=2, batch=3),
            dict(kind="launcher", shape=(2,), names=("data",),
                 ckpt_dir=str(tmp_path_factory.mktemp("launcher_ckpt")))]
    return _spawn(ranks.rank_jobs, 2, jobs, tmp_path_factory, "p2")


@pytest.fixture(scope="module")
def pod2_data2(init, tmp_path_factory):
    job = dict(shape=(2, 2), names=("pod", "data"), init=init[0], steps=3)
    return _spawn(ranks.mesh_run, 4, job, tmp_path_factory, "pod2_data2")


@pytest.fixture(scope="module")
def one_device(init):
    """The one-device oracles: microbatches 4 (4 steps), 2 (3 steps)."""
    return {4: _one_device(init[0], 4, 4), 2: _one_device(init[0], 3, 2)}


# ------------------------------------------------------------- (c) the step
def test_four_data_ranks_are_the_step_at_four_microbatches(p4, one_device):
    mets, model, opt = one_device[4]
    for o in p4:
        _same_run(o, mets, model, opt, f"P=4 rank {o['rank']}")
        for n, p in model.named_parameters():  # each rank holds a quarter
            assert o["local_shapes"][n][0] * 4 == p.shape[0], n


def test_two_data_ranks_are_the_step_at_two_microbatches(p2, one_device):
    mets, model, opt = one_device[2]
    for rank_jobs in p2:
        _same_run(rank_jobs[0], mets, model, opt, f"P=2 rank {rank_jobs[0]['rank']}")


def test_pod_by_data_mesh_is_the_step_at_four_microbatches(pod2_data2, init):
    mets, model, opt = _one_device(init[0], 3, 4)
    for o in pod2_data2:
        _same_run(o, mets, model, opt, f"(pod 2, data 2) rank {o['rank']}")


@pytest.fixture(scope="module")
def p4_mailboxes(init, tmp_path_factory):
    """P = 4 as ``p4`` with every copy through host mailboxes of 64 KiB (a
    bucket in many pieces): (its checkpoint directory, the ranks' runs)."""
    job = dict(shape=(4,), names=("data",), init=init[0], steps=4, ckpt_every=2,
               ckpt_dir=str(tmp_path_factory.mktemp("p4_boxes_ckpt")),
               mailboxes=(str(tmp_path_factory.mktemp("p4_boxes")), 1 << 16))
    return job["ckpt_dir"], _spawn(ranks.mesh_run, 4, job, tmp_path_factory, "p4_boxes")


def test_four_ranks_through_mailboxes_are_the_step_at_four_microbatches(
        p4_mailboxes, p4, one_device, ckpt_dir):
    """The card's path for ranks sharing one card (the copies through the
    ranks' mailboxes, here files mapped shared) gives the gloo path's bits:
    the one-device step at four microbatches, and the same checkpoints."""
    box_dir, outs = p4_mailboxes
    mets, model, opt = one_device[4]
    for o in outs:
        _same_run(o, mets, model, opt, f"P=4 mailboxes rank {o['rank']}")
    for step in (2, 4):
        with np.load(f"{ckpt_dir}/step_{step:08d}/arrays.npz") as want, \
                np.load(f"{box_dir}/step_{step:08d}/arrays.npz") as got:
            assert sorted(got.files) == sorted(want.files)
            for k in want.files:
                assert got[k].tobytes() == want[k].tobytes(), (step, k)


@pytest.mark.parametrize("n", [2, 4])
def test_mailbox_collectives_are_the_gloo_collectives(n, tmp_path_factory):
    """Each copy of ``Axis`` through mailboxes of 40 bytes (pieces that
    split elements) equals the same call through gloo, bit for bit."""
    job = dict(ranks=n, dir=str(tmp_path_factory.mktemp(f"boxes{n}")), nbytes=40)
    outs = _spawn(ranks.mailbox_ops, n, job, tmp_path_factory, f"boxes_run{n}")
    for o in outs:
        assert {"sum_scatter", "gather_rows", "ring_shift"} <= set(o["ipc"]), o["ipc"]
        assert ("broadcast" in o["ipc"]) == (o["rank"] == n - 1)
        for k, want in o["plain"].items():
            got = o["via"][k]
            assert got.dtype == want.dtype and got.shape == want.shape, k
            assert got.tobytes() == want.tobytes(), (o["rank"], k)


def test_npz_entries_are_mapped_as_written(tmp_path):
    """The restore's reader: every entry of an ``np.savez`` file mapped
    (small ones read), every entry of a compressed one read, the values
    those written (Fortran order and bf16 words included)."""
    from repro_torch.train.checkpoint import _npz_arrays

    rng = np.random.default_rng(0)
    arrays = {"big": rng.standard_normal((600, 700)).astype(np.float32),
              "fortran": np.asfortranarray(rng.standard_normal((700, 400))),
              "bf16": rng.integers(0, 1 << 16, 600_000, dtype=np.uint16).view("V2"),
              "small": np.arange(5), "scalar": np.array(3, np.int32)}
    for save in (np.savez, np.savez_compressed):
        path = str(tmp_path / f"{save.__name__}.npz")
        save(path, **arrays)
        got = _npz_arrays(path)
        assert sorted(got) == sorted(arrays)
        for k, a in arrays.items():
            assert got[k].dtype == a.dtype and got[k].shape == a.shape, k
            assert np.array(got[k]).tobytes() == a.tobytes(), k
        assert isinstance(got["big"], np.memmap) == (save is np.savez)
        assert not isinstance(got["small"], np.memmap)


@pytest.mark.parametrize("run", ["p2", "p4", "pod2_data2"])
def test_data_parallel_step_within_the_reference_bounds(run, request, reference):
    """Against the reference's jitted step at the same microbatches, with
    test_torch_train.py's bounds (loss and grad norm within LOGIT_ULPS
    bf16 ulps; each leaf within 2·Σlr, on average 0.1·Σlr)."""
    outs = request.getfixturevalue(run)
    got = outs[0][0] if run == "p2" else outs[0]
    ref = reference[2 if run == "p2" else 4]
    n = len(got["mets"])
    for s in range(n):
        for k in ("loss", "grad_norm"):
            want = ref["mets"][s][k]
            assert abs(float(got["mets"][s][k]) - want) <= LOGIT_ULPS * bf16_ulp(want), \
                (run, s, k)
        assert abs(float(got["mets"][s]["lr"]) - ref["mets"][s]["lr"]) <= \
            np.spacing(np.float32(ref["mets"][s]["lr"]))
    lr_sum = sum(m["lr"] for m in ref["mets"][:n])
    stacked = _stacked(got["params"])
    for path, leaf in j_flatten(ref["params"][n - 1]):
        d = np.abs(stacked[path] - np.asarray(leaf))
        assert d.max() <= 2 * lr_sum, (run, path, d.max())
        assert d.mean() <= 0.1 * lr_sum, (run, path, d.mean())


def _stacked(params: dict) -> dict:
    """{reference path: array} of the port's per-layer parameters."""
    cfg = smoke_config(ARCHS["gemma2-2b"])
    return {path: np.stack(parts) if len(parts) > 1 else parts[0]
            for path, parts in tree_flatten_with_paths(params, cfg=cfg)}


def test_zero_stage_0_is_bitwise_zero_stage_1(p2):
    for rank_jobs in p2:
        one, zero = rank_jobs[0], rank_jobs[2]
        for s, (a, b) in enumerate(zip(one["mets"], zero["mets"], strict=True)):
            for k in ranks.METRICS:
                _same(a[k], b[k], f"step {s} {k}")
        for n in one["params"]:
            _same(one["params"][n], zero["params"][n], n)
            _same(one["moments"]["m"][n], zero["moments"]["m"][n], n)
            assert zero["local_shapes"][n] == one["params"][n].shape  # replicated
            assert one["local_shapes"][n] != one["params"][n].shape  # sharded


def test_master_mode_is_bitwise_its_one_device_twin(p2, init):
    mets, model, opt = _one_device(init[0], 3, 2, master=True)
    assert {p.dtype for n, p in model.named_parameters() if "ln" not in n} == \
        {torch.bfloat16}
    for rank_jobs in p2:
        got = rank_jobs[3]
        assert set(got["moments"]) == {"m", "v", "master"}
        _same_run(got, mets, model, opt, f"master rank {got['rank']}")


def test_a_batch_the_ranks_do_not_divide_is_taken_whole(p2, init):
    mets, model, opt = _one_device(init[0], 2, 1, batch=3)
    for rank_jobs in p2:
        _same_run(rank_jobs[5], mets, model, opt, f"batch 3 rank {rank_jobs[5]['rank']}")


# ------------------------------------------------------------- (e) retries
def test_a_step_failing_once_on_every_rank_is_retried(p2):
    for rank_jobs in p2:
        clean, failed = rank_jobs[0], rank_jobs[1]
        assert clean["retries"] == 0 and failed["retries"] == 1
        for s, (a, b) in enumerate(zip(clean["mets"], failed["mets"], strict=True)):
            for k in ranks.METRICS:
                _same(a[k], b[k], f"step {s} {k}")
        for n in clean["params"]:
            _same(clean["params"][n], failed["params"][n], n)


# ------------------------------------------------------------- (d) elastic
def _elastic_oracle(init_tree, microbatches_after):
    """One device: 2 steps at microbatches 4, a save and a restore (into a
    model drawn from another seed), 2 steps at ``microbatches_after``."""
    mets_a, model, opt = _one_device(init_tree, 2, 4)
    cfg, _, other = ranks._setup(init_tree)
    with torch.no_grad():
        for p in other.parameters():
            p.zero_()
    with tempfile.TemporaryDirectory() as d:
        CheckpointManager(d).save(2, {"params": model, "opt": opt})
        rest = CheckpointManager(d).restore(2, {"params": other,
                                                "opt": init_opt_state(other)})
    mets_b, model, opt = _one_device(init_tree, 2, microbatches_after, start=2,
                                     state=(rest["params"], rest["opt"]))
    return mets_b, model, opt


def test_a_four_rank_checkpoint_continues_on_two_ranks(p2, init):
    mets, model, opt = _elastic_oracle(init[0], 2)
    for rank_jobs in p2:
        _same_run(rank_jobs[4], mets, model, opt,
                  f"restored at P=2, rank {rank_jobs[4]['rank']}")


def test_a_four_rank_checkpoint_continues_on_one_device(p4, init, ckpt_dir):
    mets, model, opt = _elastic_oracle(init[0], 1)
    cfg, _, other = ranks._setup(init[0])
    rest = CheckpointManager(ckpt_dir).restore(2, {"params": other,
                                                   "opt": init_opt_state(other)})
    got_mets, got_model, got_opt = _one_device(init[0], 2, 1, start=2,
                                               state=(rest["params"], rest["opt"]))
    for s, (g, w) in enumerate(zip(got_mets, mets, strict=True)):
        for k in ranks.METRICS:
            _same(g[k], w[k], f"step {s + 2} {k}")
    for (n, a), b in zip(got_model.named_parameters(), model.parameters(), strict=True):
        assert torch.equal(a, b), n
    for n in opt["m"]:
        assert torch.equal(got_opt["m"][n], opt["m"][n])
        assert torch.equal(got_opt["v"][n], opt["v"][n])


def test_a_mesh_checkpoint_loads_into_the_reference(p4, init, ckpt_dir):
    """The P = 4 checkpoint's arrays, restored by the reference's
    CheckpointManager into its own tree, are the one-device port's state
    after 2 steps at microbatches 4."""
    _, model, opt = _one_device(init[0], 2, 4)
    got = JCheckpointManager(ckpt_dir).restore(2, {"params": init[0], "opt": init[1]})
    want = _stacked({n: ranks._np(p) for n, p in model.named_parameters()})
    for path, leaf in j_flatten(got["params"]):
        np.testing.assert_array_equal(np.asarray(leaf), want[path], err_msg=path)
    for key in ("m", "v"):
        want = _stacked({n: ranks._np(t) for n, t in opt[key].items()})
        for path, leaf in j_flatten(got["opt"][key]):
            np.testing.assert_array_equal(np.asarray(leaf), want[path], err_msg=path)
    assert int(got["opt"]["step"]) == 2


def test_the_launcher_trains_over_data_ranks_and_resumes(p2):
    """launcher.train under runtime.configure(mesh=) on two ranks: 2 steps
    with a checkpoint, then a resume to 4, bitwise the one-device launcher
    at microbatches 2."""
    want, _, _, _ = launcher.train(
        smoke_config(ARCHS["gemma2-2b"]), SHAPES["train_4k"], steps=4,
        microbatches=2, **ranks.LAUNCHER_KW)
    for rank_jobs in p2:
        got = rank_jobs[6]
        assert got["start"] == 2 and got["latest"] == 4
        for n, p in want.named_parameters():
            _same(got["params"][n], ranks._np(p), n)


# ------------------------------------------------------------- (f) compression
_REF_COMPRESS = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, {src!r})
    from functools import partial
    import jax, jax.numpy as jnp, numpy as np
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P
    from repro.train.compression import (compressed_psum, psum_with_error_feedback,
                                         tree_compressed_psum)
    mesh = jax.make_mesh((8,), ("pod",))
    row = P("pod", None)
    x = jax.random.normal(jax.random.PRNGKey(1), (8, 128), jnp.float32)
    out = {{"x": np.asarray(x)}}
    out["one_shot"] = shard_map(partial(compressed_psum, axis_name="pod"), mesh=mesh,
                                in_specs=row, out_specs=row)(x)
    step = shard_map(partial(psum_with_error_feedback, axis_name="pod"), mesh=mesh,
                     in_specs=(row, row), out_specs=(row, row))
    err = jnp.zeros_like(x)
    for r in range({rounds}):
        o, err = step(x, err)
        out[f"mean_{{r}}"], out[f"err_{{r}}"] = o, err
    xn = np.asarray(x)
    tree = {{"b": jnp.asarray(xn * np.float32(3.0)),
             "a": [x, jnp.asarray(xn[:, :64] - np.float32(1.0))]}}
    errs = {{"b": jnp.zeros_like(x), "a": [jnp.full_like(x, 0.01),
                                          jnp.zeros((8, 64), jnp.float32)]}}
    spec = {{"b": row, "a": [row, row]}}
    with jax.set_mesh(mesh):  # its astype needs the mesh in context under jax 0.9
        means, new_errs = shard_map(partial(tree_compressed_psum, axis_name="pod"),
                                    mesh=mesh, in_specs=(spec, spec),
                                    out_specs=(spec, spec))(tree, errs)
    for i, t in enumerate((means["b"], means["a"][0], means["a"][1], new_errs["b"],
                           new_errs["a"][0], new_errs["a"][1])):
        out[f"tree_{{i}}"] = t
    np.savez({path!r}, **{{k: np.asarray(v) for k, v in out.items()}})
""")
ROUNDS = 16


@pytest.fixture(scope="module", autouse=True)
def _compress_reference_run(tmp_path_factory):
    """The reference's run, started with the module's first test (its 16
    eager rounds take most of a minute; the spawns run meanwhile) and
    stopped at the end if no test read it."""
    path = str(tmp_path_factory.mktemp("compress") / "ref.npz")
    code = _REF_COMPRESS.format(src=os.path.join(ROOT, "src"), rounds=ROUNDS, path=path)
    with tempfile.TemporaryFile("w+") as err:
        proc = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.DEVNULL,
                                stderr=err, env=dict(os.environ, JAX_PLATFORMS="cpu"))
        try:
            yield proc, path, err
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def compress_reference(_compress_reference_run):
    proc, path, err = _compress_reference_run
    rc = proc.wait(timeout=300)
    err.seek(0)
    assert rc == 0, err.read()
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_compressed_collectives_are_the_references_bitwise(compress_reference,
                                                           tmp_path_factory):
    ref = compress_reference
    job = dict(ranks=8, x=ref["x"], rounds=ROUNDS)
    outs = _spawn(ranks.compress_run, 8, job, tmp_path_factory, "compress")
    rows = lambda a, r: a[r:r + 1]  # noqa: E731
    for o in outs:
        r = o["rank"]
        _same(o["one_shot"], rows(ref["one_shot"], r), f"one-shot rank {r}")
        for i, (mean, err) in enumerate(o["rounds"]):
            _same(mean, rows(ref[f"mean_{i}"], r), f"round {i} mean, rank {r}")
            _same(err, rows(ref[f"err_{i}"], r), f"round {i} error, rank {r}")
        for i, t in enumerate(o["tree"]):
            _same(t, rows(ref[f"tree_{i}"], r), f"tree leaf {i}, rank {r}")
    # the reference test's criteria, on the port's outputs
    x = ref["x"]
    want = np.broadcast_to(x.mean(axis=0, keepdims=True), x.shape)
    got = np.concatenate([o["one_shot"] for o in outs])
    one_err = float(np.max(np.abs(got - want)))
    assert one_err / (np.max(np.abs(want)) + 1e-9) < 0.02
    tot = sum(np.concatenate([o["rounds"][i][0] for o in outs]) for i in range(ROUNDS))
    assert float(np.max(np.abs(tot / ROUNDS - want))) < 0.6 * one_err


# ------------------------------------------------------------- (g) the launcher
def test_state_reckoning_over_data_ranks():
    n = 1_000_000
    assert launcher.state_bytes_per_rank(n) == 16 * n
    assert launcher.state_bytes_per_rank(n, 4) == 10 * n
    assert launcher.state_bytes_per_rank(n, 4, master=True) == 11 * n
    assert launcher.state_bytes_per_rank(n, 4, zero_stage=0) == 16 * n
    # gemma2-2b cut to 2 layers over four ranks on one card (the card's phase)
    cfg = ARCHS["gemma2-2b"]
    import dataclasses

    cut = dataclasses.replace(cfg, n_layers=2)
    count = launcher.param_count(cut)
    per = launcher.state_bytes_per_rank(count, 4)
    assert abs(count - 0.7456e9) < 0.0005e9 and abs(per - 7.46e9) < 0.01e9


def test_init_reckoning_on_a_model_axis():
    """A rank of a model axis draws each leaf whole before it keeps its
    slice: its peak while drawing is its f32 weights, its AdamW shard and
    the largest leaf (gemma2-2b's 256,000 x 2304 embedding), not the
    gradients; check_fits takes the larger of that and the state."""
    import dataclasses

    cut = dataclasses.replace(ARCHS["gemma2-2b"], n_layers=2)
    n = launcher.rank_param_count(cut, 4)
    leaf = 4 * 256_000 * 2304
    assert launcher.largest_leaf_bytes(cut) == leaf
    assert launcher.init_bytes_per_rank(cut, n, 2, model_ranks=4) == 4 * n + 4 * n + leaf
    assert launcher.init_bytes_per_rank(cut, n, 2) == 8 * n
    assert abs(launcher.init_bytes_per_rank(cut, n, 2, model_ranks=4) - 3.85e9) < 0.01e9


def test_check_fits_counts_the_ranks_on_a_card(monkeypatch):
    monkeypatch.setattr(launcher, "param_count", lambda cfg: 2_000_000_000)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: SimpleNamespace(total_memory=80_000_000_000))
    cfg, card = ARCHS["gemma2-2b"], torch.device("cuda")
    launcher.check_fits(cfg, card)                        # 32 GB
    launcher.check_fits(cfg, card, data_ranks=4, ranks_per_card=4)   # 4 x 20 GB
    with pytest.raises(ValueError, match="4 rank"):
        launcher.check_fits(cfg, card, data_ranks=4, ranks_per_card=4,
                            master=True)                  # 4 x 22 GB
    with pytest.raises(ValueError, match="more than"):
        launcher.check_fits(cfg, card, data_ranks=1, ranks_per_card=3)
    launcher.check_fits(cfg, torch.device("cpu"), ranks_per_card=100)  # never on the CPU


def _no_model(*args, **kw):
    raise AssertionError("the launcher built a model")


@pytest.mark.parametrize("mesh", ["debug", "pod1", "pod2"])
def test_the_model_axis_meshes_name_item_7c(mesh, monkeypatch):
    """The meshes with a model axis (item 7c): ``debug`` spawns its 8 ranks
    on this host; ``pod1`` and ``pod2`` need torchrun with exactly 256 or
    512 ranks and raise, saying so, before a model is built."""
    monkeypatch.setattr(launcher, "init_state", _no_model)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    spawned = []
    monkeypatch.setattr(launcher, "spawn_ranks", lambda fn, n, **kw: spawned.append(
        (fn, n, kw)) or [{"rank": 0, "start": 0, "quantiles": {}, "stragglers": 0}])
    argv = ["--arch", "gemma2-2b", "--mesh", mesh, "--steps", "1", "--device", "cpu"]
    if mesh == "debug":
        launcher.main(argv)
        (fn, n, kw), = spawned
        assert fn is launcher.mesh_rank and n == 8 and kw["backend"] == "gloo"
        assert kw["args"][2] == "debug"
        return
    need = {"pod1": 256, "pod2": 512}[mesh]
    with pytest.raises(RuntimeError, match=f"torchrun and exactly {need} ranks"):
        launcher.main(argv)
    monkeypatch.setenv("WORLD_SIZE", "8")
    with pytest.raises(RuntimeError, match=f"exactly {need} torchrun ranks"):
        launcher.main(argv)
    assert not spawned


# ------------------------------------------------------------- the card's phase
def test_chip_train_mesh_phase_rehearses_on_the_cpu(monkeypatch, capsys):
    """``chip_smoke.py``'s train_mesh phase, its control flow on the CPU:
    gemma2-2b at its smoke config cut to 2 layers, b 8, s 32, gloo in place
    of the NCCL rank; every check of the phase holds (the phase's time
    limit is checked on the card only)."""
    import chip_smoke

    from repro_torch import configs

    failed = []
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    monkeypatch.setattr(chip_smoke, "check",
                        lambda cond, msg: None if cond else failed.append(msg))
    monkeypatch.setitem(chip_smoke.TRAIN_MESH, "seq", 32)
    monkeypatch.setitem(chip_smoke.TRAIN_MESH, "one_rank_backend", "gloo")
    monkeypatch.setitem(chip_smoke.TRAIN_MESH, "timeout", LIMIT_S)
    monkeypatch.setitem(configs.ARCHS, "gemma2-2b", smoke_config(ARCHS["gemma2-2b"]))
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    chip_smoke.phase_train_mesh({})
    assert not failed, failed
    out = [json.loads(line) for line in capsys.readouterr().out.splitlines()
           if line.startswith("{")]
    lines = {d["phase"]: d for d in out if d.get("phase", "").startswith("train_mesh")}
    assert set(lines) == {"train_mesh", "train_mesh_nccl", "train_mesh_compress",
                          "train_mesh_phase"}
    for name in ("train_mesh", "train_mesh_nccl"):
        assert all(lines[name]["bitwise"].values()), name
    assert all(lines["train_mesh"]["elastic"]["bitwise"].values())
    assert lines["train_mesh_compress"]["host_equal"]
    for row in lines["train_mesh"]["per_rank"]:
        assert {"step_ms_first", "step_ms_p50_rest", "staged_bytes_per_step",
                "peak_bytes", "save_s"} <= set(row)


def test_chip_mesh_tp_phase_rehearses_on_the_cpu(monkeypatch, capsys):
    """``chip_smoke.py``'s mesh_tp phase, its control flow on the CPU:
    gemma2-2b at its smoke config cut to 2 layers over 8 gloo ranks at
    (data 2, model 4), b 8, s 32, a 64-token prompt, 8 new tokens and 4
    forced steps; every check of the phase holds (the time limit, the
    launch counts and the memory checks are the card's)."""
    import chip_smoke

    from repro_torch import configs

    failed = []
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    monkeypatch.setattr(chip_smoke, "check",
                        lambda cond, msg: None if cond else failed.append(msg))
    for k, v in dict(seq=32, prompt=64, new_tokens=8, forced_steps=4, tail=8,
                     timeout=LIMIT_S).items():
        monkeypatch.setitem(chip_smoke.MESH_TP, k, v)
    monkeypatch.setitem(configs.ARCHS, "gemma2-2b", smoke_config(ARCHS["gemma2-2b"]))
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    chip_smoke.phase_mesh_tp({})
    assert not failed, failed
    out = [json.loads(line) for line in capsys.readouterr().out.splitlines()
           if line.startswith("{")]
    line = next(d for d in out if d.get("phase") == "mesh_tp")
    assert line["train"]["repeat_bitwise"] and line["train"]["replicated_equal"]
    assert line["serve"]["repeat_bitwise"] and line["serve"]["slot_agreement"] >= 0.999
    assert all(h["prefill"]["calls"] == 1 and h["decode"]["calls"] == 2 * 4
               for h in line["serve"]["k5_held"])
    assert len(line["per_rank"]) == 8


def test_chip_mesh_ep_phase_rehearses_on_the_cpu(monkeypatch, capsys):
    """``chip_smoke.py``'s mesh_ep phase, its control flow on the CPU:
    deepseek-moe-16b and mamba2-370m at their smoke configs cut to 2 and 8
    layers over 8 gloo ranks at (data 2, model 4) (one expert and two SSD
    heads a rank), b 8, s 32, a 64-token prompt, 8 new tokens and 4 forced
    steps (mamba2: 4 decode steps); the one-device trainer's routing
    replayed on the ranks, the ranks' serving routing replayed on one
    device; every check of the phase holds (the time limit, the launch
    counts and the memory checks are the card's)."""
    import chip_smoke

    from repro_torch import configs

    failed = []
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    monkeypatch.setattr(chip_smoke, "check",
                        lambda cond, msg: None if cond else failed.append(msg))
    for k, v in dict(seq=32, prompt=64, new_tokens=8, forced_steps=4, tail=8,
                     timeout=LIMIT_S).items():
        monkeypatch.setitem(chip_smoke.MESH_TP, k, v)
    monkeypatch.setitem(chip_smoke.MESH_EP, "ssm_steps", 4)
    for arch in ("deepseek-moe-16b", "mamba2-370m"):
        monkeypatch.setitem(configs.ARCHS, arch, smoke_config(ARCHS[arch]))
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    state = {}
    chip_smoke.phase_mesh_ep(state)
    assert not failed, failed
    out = [json.loads(line) for line in capsys.readouterr().out.splitlines()
           if line.startswith("{")]
    moe = next(d for d in out if d.get("phase") == "mesh_ep_moe")
    ssm = next(d for d in out if d.get("phase") == "mesh_ep_ssm")
    for line in (moe, ssm):
        assert line["train"]["repeat_bitwise"] and line["train"]["replicated_equal"]
        assert len(line["per_rank"]) == 8
    assert moe["serve"]["slot_agreement"] >= 0.999 and ssm["serve"]["slot_agreement"] is None
    assert all(h["prefill"]["calls"] == 2 and h["decode"]["calls"] == 2 * 4
               for h in moe["serve"]["k5_held"])
    assert moe["train"]["pinned_to_one_device"]["far"] == 0
    assert all(sum(r["expert_gather_bytes_per_step"]) > 0 for r in moe["per_rank"])
    assert all(sum(r["expert_gather_bytes_per_step"]) == 0 for r in ssm["per_rank"])
    assert state["mesh_ep_measured"]["ranks_ops"]
