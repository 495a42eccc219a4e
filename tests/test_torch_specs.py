"""The model axis's specs and plans against the reference's, as pure
tuples (no processes): every arch of ``ARCHS`` at full size.

  * ``param_specs`` at tp 1, 4 and 16: every parameter of the port's
    model, keyed by its own name, equal to the reference's spec of the leaf
    that ``utils.tree.param_path`` maps it to (a scanned leaf's leading
    None dropped), each padded to the leaf's rank; the leaf shapes agree;
  * ``make_plan`` (both ``heads_mode``s), ``batch_specs`` and
    ``cache_specs`` on the debug mesh (2, 4) and the production meshes
    (16, 16) and (2, 16, 16), at the ``train_4k``, ``prefill_32k``,
    ``decode_32k`` and ``long_500k`` shapes; the reference reads only a
    mesh's ``axis_names`` and ``shape``, so a ``SimpleNamespace`` stands
    in for its meshes and the port's ``MeshShape`` for the port's;
  * ``zero_opt_specs`` on those meshes, over the reference's stacked
    leaves.
"""
import functools
from types import SimpleNamespace

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from repro.configs import ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.launch.mesh import batch_specs as j_batch_specs
from repro.launch.mesh import make_plan as j_make_plan
from repro.models import build as j_build
from repro.train.optimizer import zero_opt_specs as j_zero_opt_specs
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch.mesh import MeshShape, PRODUCTION_MESHES, batch_specs, make_plan
from repro_torch.models import build, encdec, transformer
from repro_torch.train.optimizer import zero_opt_specs
from repro_torch.utils.tree import param_path

MESHES = {"debug": MeshShape(("data", "model"), (2, 4)), **PRODUCTION_MESHES}


def _t(spec):
    return None if spec is None else tuple(spec)


def _pad(spec, rank):
    spec = tuple(spec)
    assert len(spec) <= rank, (spec, rank)
    return spec + (None,) * (rank - len(spec))


def _strip(spec):
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


def _flat(tree, is_leaf=None):
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
            for path, leaf in leaves}


def _is_p(x):
    return isinstance(x, P)


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch):
    jb = j_build(J_ARCHS[arch])
    return {p: tuple(s.shape) for p, s in
            _flat(jax.eval_shape(jb.init, jax.random.PRNGKey(0))).items()}


@functools.lru_cache(maxsize=None)
def _port_shapes(arch):
    cfg = ARCHS[arch]
    make = encdec.EncDec if cfg.family == "encdec-audio" else transformer.LM
    return {n: tuple(p.shape) for n, p in
            make(cfg, device="meta", trainable=True).named_parameters()}


def _ref_ref(ref_spec, shape, repeat):
    """A reference leaf's spec as the port's per-layer leaf holds it."""
    spec = _pad(ref_spec, len(shape))
    if repeat is not None:
        assert spec[0] is None, spec
        spec = spec[1:]
    return spec


@pytest.mark.parametrize("tp_size", [1, 4, 16])
@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_param_specs_match_the_reference(arch, tp_size):
    cfg = ARCHS[arch]
    want = _flat(j_build(J_ARCHS[arch]).param_specs(tp="model", tp_size=tp_size),
                 is_leaf=_is_p)
    shapes, port_shapes = _ref_shapes(arch), _port_shapes(arch)
    got = build(cfg).param_specs(tp="model", tp_size=tp_size)
    assert sorted(got) == sorted(port_shapes)
    covered = set()
    for name, spec in got.items():
        path, r = param_path(cfg, name)
        covered.add(path)
        ref_shape = shapes[path] if r is None else shapes[path][1:]
        assert port_shapes[name] == ref_shape, name
        assert _pad(spec, len(ref_shape)) == _ref_ref(want[path], shapes[path], r), \
            (name, spec, want[path])
    assert covered == set(want) == set(shapes)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_plans_batch_and_cache_specs_match_the_reference(arch, mesh):
    port_mesh = MESHES[mesh]
    ref_mesh = SimpleNamespace(axis_names=port_mesh.mesh_dim_names,
                               shape=dict(zip(port_mesh.mesh_dim_names, port_mesh.sizes)))
    cfg, jcfg = ARCHS[arch], J_ARCHS[arch]
    tp = ref_mesh.shape["model"]
    jb, bundle = j_build(jcfg), build(cfg)
    for shape_name in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        shape, jshape = SHAPES[shape_name], J_SHAPES[shape_name]
        for mode in ("auto", "seq"):
            want = j_make_plan(jcfg, jshape, ref_mesh, heads_mode=mode)
            got = make_plan(cfg, shape, port_mesh, heads_mode=mode)
            for field in ("resid", "heads", "kv", "mamba_heads", "ep", "cache", "logits"):
                assert getattr(got, field) == _t(getattr(want, field)), \
                    (shape_name, mode, field)
            _same_cache_specs(cfg, jb.cache_specs(want, tp_size=tp),
                              bundle.cache_specs(got, tp_size=tp))
        kind = shape.kind
        want_b = j_batch_specs(jcfg, jshape, ref_mesh, kind=kind)
        assert batch_specs(cfg, shape, port_mesh, kind=kind) == \
            {k: _t(v) for k, v in want_b.items()}, shape_name


def _same_cache_specs(cfg, want, got):
    """The reference's cache specs (prefix / stacked with a leading None;
    the enc-dec's all stacked) against the port's per-layer list."""
    layers = got["layers"]
    assert len(layers) == cfg.n_layers
    if cfg.family == "encdec-audio":
        flat_want = _flat(want, is_leaf=_is_p)
        for layer in layers:
            for path, spec in _flat(layer, is_leaf=lambda x: isinstance(x, tuple)).items():
                ref = _strip(flat_want[path])
                assert ref[:1] in ((), (None,))
                assert _strip(spec) == _strip(ref[1:]), path
        return
    n_prefix, period, _ = transformer.stack_plan(cfg)
    for l, layer in enumerate(layers):
        if l < n_prefix:
            ref, stacked = want["prefix"][l], False
        else:
            ref, stacked = want["stack"][(l - n_prefix) % period], True
        for key, spec in layer.items():
            r = _strip(ref[key])
            if stacked:
                assert r[:1] in ((), (None,)), (l, key)
                r = _strip(r[1:])
            assert _strip(spec) == r, (l, key, spec, ref[key])


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_zero_opt_specs_match_the_reference(arch, mesh):
    """The port's ``zero_opt_specs`` on the reference's stacked leaves (the
    port's param specs with a scanned leaf's leading None put back) equal
    the reference's."""
    port_mesh = MESHES[mesh]
    mesh_shape = dict(zip(port_mesh.mesh_dim_names, port_mesh.sizes))
    axes = tuple(a for a in ("pod", "data") if a in mesh_shape)
    cfg, tp = ARCHS[arch], mesh_shape["model"]
    shapes = _ref_shapes(arch)
    jb = j_build(J_ARCHS[arch])
    want = j_zero_opt_specs(jb.param_specs(tp="model", tp_size=tp),
                            jax.eval_shape(jb.init, jax.random.PRNGKey(0)), axes,
                            mesh_shape)
    pspecs = {}
    for name, spec in build(cfg).param_specs(tp="model", tp_size=tp).items():
        path, r = param_path(cfg, name)
        pspecs[path] = (None,) + tuple(spec) if r is not None else tuple(spec)
    got = zero_opt_specs(pspecs, shapes, axes, mesh_shape)
    flat_want = _flat(want["m"], is_leaf=_is_p)
    assert sorted(got["m"]) == sorted(flat_want)
    for path, spec in got["m"].items():
        rank = len(shapes[path])
        assert _pad(spec, rank) == _pad(flat_want[path], rank), (path, spec)
    assert got["step"] == tuple(want["step"]) == ()


def test_production_mesh_shapes():
    assert PRODUCTION_MESHES["pod1"].size() == 256
    assert PRODUCTION_MESHES["pod2"].size() == 512
    assert MESHES["debug"].size(1) == 4
    assert np.prod(PRODUCTION_MESHES["pod2"].sizes) == 512
