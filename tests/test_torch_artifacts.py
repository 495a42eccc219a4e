"""The port's IndexStore against the JAX package's: the same on-disk format
both ways (an index either package saves, the other loads and serves with
the same labels, packed buffers included, every bit kept), and the same
refusals of torn artifacts."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import gmm_sample

import repro
from repro.core.index import ClusterIndex as JIndex
from repro.serve.artifacts import ArtifactError as JArtifactError
from repro.serve.artifacts import IndexStore as JStore
from repro_torch.core.index import ClusterIndex
from repro_torch.serve import ArtifactError, IndexStore

torch.set_num_threads(1)

FIELDS = ("protos", "proto_mass", "proto_valid", "proto_labels", "n_prototypes",
          "protos_bf16", "protos_q8", "q8_scale", "q8_zero")


@pytest.fixture(scope="module")
def jindex():
    x, _ = gmm_sample(1500, np.random.default_rng(1))
    return JIndex.build(repro.fit(jnp.asarray(x), 2, 2, "kmeans", k=3)), x


def bits(a):
    """Any array or tensor as comparable host bits (bf16 as int16)."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def assert_same_index(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(bits(x), bits(y), err_msg=f)


def test_jax_saved_index_loads_and_serves_in_the_port(tmp_path, jindex):
    jidx, x = jindex
    v = JStore(tmp_path).save(jidx, metadata={"from": "jax"})
    idx = IndexStore(tmp_path).load(v, expect_dim=2, device="cpu")
    assert idx.protos_bf16.dtype == torch.bfloat16 and idx.protos_q8.dtype == torch.int8
    assert_same_index(idx, jidx)
    q = (x[:800] + np.random.default_rng(2).normal(size=(800, 2)) * 0.1
         ).astype(np.float32)
    for impl in ("fused", "fused_bf16", "fused_int8"):
        np.testing.assert_array_equal(
            idx.assign(q, impl=impl).numpy(),
            np.asarray(jidx.assign(jnp.asarray(q), impl=impl)), err_msg=impl)


def test_port_saved_index_loads_and_serves_in_jax(tmp_path, jindex):
    jidx, x = jindex
    fields = {f: np.asarray(getattr(jidx, f)) for f in FIELDS[:5]}
    mine = ClusterIndex.build(ClusterIndex.from_numpy(fields, device="cpu"))
    v = IndexStore(tmp_path).save(mine)
    back = JStore(tmp_path).load(v, expect_dim=2)
    assert_same_index(mine, back)
    assert_same_index(back, jidx)  # the port packed what the reference packs
    manifest = json.loads((tmp_path / f"v{v:04d}" / "manifest.json").read_text())
    assert manifest["arrays"]["protos_bf16"]["stored_dtype"] == "uint16"
    assert manifest["arrays"]["protos_bf16"]["dtype"] == "bfloat16"
    q = x[:300]
    np.testing.assert_array_equal(np.asarray(back.assign(jnp.asarray(q),
                                                         impl="fused_int8")),
                                  mine.assign(q, impl="fused_int8").numpy())


def test_port_roundtrip_bitwise_and_unpacked(tmp_path, jindex):
    jidx, _ = jindex
    fields = {f: np.asarray(getattr(jidx, f)) for f in FIELDS[:5]}
    bare = ClusterIndex.from_numpy(fields, device="cpu")
    store = IndexStore(tmp_path)
    v1 = store.save(bare)                              # no packed buffers
    v2 = store.save(ClusterIndex.build(bare), metadata={"n": 1})
    assert store.list_versions() == [v1, v2] == [1, 2] and store.latest() == 2
    assert_same_index(store.load(v1, device="cpu"), bare)
    assert_same_index(store.load(device="cpu"), ClusterIndex.build(bare))
    assert not [n for n in os.listdir(tmp_path) if n.startswith("_tmp")]


def test_save_takes_a_fit_result(tmp_path):
    import repro_torch

    x, _ = gmm_sample(400, np.random.default_rng(3))
    res = repro_torch.fit(x, 2, 1, k=3, device="cpu")
    store = IndexStore(tmp_path)
    idx = store.load(store.save(res), device="cpu")
    assert idx.protos_q8 is not None
    np.testing.assert_array_equal(idx.assign(x).numpy(), res.labels.numpy())
    with pytest.raises(TypeError, match="ClusterIndex or FitResult"):
        store.save({"protos": x})


@pytest.mark.parametrize("damage", ["flip", "truncate", "missing", "manifest",
                                    "format", "shape", "empty"])
def test_torn_artifacts_raise_in_both_packages(tmp_path, jindex, damage):
    jidx, _ = jindex
    v = JStore(tmp_path).save(jidx)
    vdir = tmp_path / f"v{v:04d}"
    mpath = vdir / "manifest.json"
    if damage == "flip":
        raw = bytearray((vdir / "protos_q8.npy").read_bytes())
        raw[-1] ^= 0x01
        (vdir / "protos_q8.npy").write_bytes(bytes(raw))
    elif damage == "truncate":
        (vdir / "protos.npy").write_bytes((vdir / "protos.npy").read_bytes()[:40])
    elif damage == "missing":
        (vdir / "q8_scale.npy").unlink()
    elif damage == "manifest":
        mpath.write_text(mpath.read_text()[:30])
    elif damage == "format":
        m = json.loads(mpath.read_text())
        m["format"] = 99
        mpath.write_text(json.dumps(m))
    elif damage == "shape":
        m = json.loads(mpath.read_text())
        m["arrays"]["proto_mass"]["shape"] = [1]
        mpath.write_text(json.dumps(m))
    else:
        v = 7  # a version that was never published
    with pytest.raises(ArtifactError):
        IndexStore(tmp_path).load(v, device="cpu")
    with pytest.raises(JArtifactError):
        JStore(tmp_path).load(v)


def test_load_checks_the_tenant_dim_and_the_empty_store(tmp_path, jindex):
    jidx, _ = jindex
    store = IndexStore(tmp_path)
    with pytest.raises(ArtifactError, match="empty"):
        store.load(device="cpu")
    JStore(tmp_path).save(jidx)
    with pytest.raises(ArtifactError, match="not servable"):
        store.load(expect_dim=3, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            store.load()  # the default device is the card
