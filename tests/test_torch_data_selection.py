"""The port's LM data pipeline and ITIS instance selection
(``repro_torch.data.pipeline``, ``repro_torch.data.instance_selection``)
against the JAX package's, fed the same numpy inputs.

Tolerances. ``make_batch``: the tokens are the reference's, none may
differ (the uniform bits are equal; ``base`` truncates pareto·7, which an
ulp of ``exp``/``log1p`` moves only within an ulp of an integer, and no
such token showed in these batches). ``featurize``: within 1e-6 of the
reference (XLA and PyTorch may sum the s rows of a mean in other orders);
bitwise on dyadic-grid tables with s a power of two, where every mean is
exact. ``select_instances``: bitwise (indices, weights, validity,
assignment) on dyadic-grid tables; on the reference's topic corpora,
whose features carry the rounding above, agreement >= 0.999 (every case
here read 1.0). ``reduced_batch``: exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import smoke_config as j_smoke_config
from repro.data import make_batch as j_make_batch
from repro.data.instance_selection import SelectionConfig as JSelectionConfig
from repro.data.instance_selection import featurize as j_featurize
from repro.data.instance_selection import reduced_batch as j_reduced_batch
from repro.data.instance_selection import select_instances as j_select
from repro_torch import prng
from repro_torch.configs import ARCHS, SHAPES, smoke_config
from repro_torch.data import make_batch
from repro_torch.data.instance_selection import (
    SelectionConfig,
    featurize,
    projection,
    reduced_batch,
    select_instances,
)

MIN_AGREEMENT = 0.999
FIELDS = ("indices", "weights", "valid", "assignment")


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen2.5-32b", "minitron-8b"])
@pytest.mark.parametrize("smoke", [True, False])
def test_make_batch_matches_reference(arch, smoke):
    cfg, jcfg = ARCHS[arch], J_ARCHS[arch]
    if smoke:
        cfg, jcfg = smoke_config(cfg), j_smoke_config(jcfg)
    for step in (0, 1, 7, 1000):
        want = j_make_batch(jcfg, J_SHAPES["train_4k"], step, batch_override=8,
                            seq_override=256)
        got = make_batch(cfg, SHAPES["train_4k"], step, batch_override=8,
                         seq_override=256)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_run_config_drives_batch_iterator():
    """A RunConfig holds the reference's ParallelConfig defaults, and its
    batch stream is make_batch at consecutive steps, the reference's."""
    import dataclasses

    from repro.configs.base import ParallelConfig as JParallelConfig
    from repro.data import batch_iterator as j_batch_iterator
    from repro_torch.configs import ParallelConfig, RunConfig
    from repro_torch.data import batch_iterator

    cfg = smoke_config(ARCHS["gemma2-2b"])
    run = RunConfig(model=cfg, shape=SHAPES["train_4k"])
    assert dataclasses.asdict(run.parallel) == dataclasses.asdict(JParallelConfig())
    run = run.replace(parallel=ParallelConfig(remat="block", microbatches=2))
    assert (run.parallel.remat, run.parallel.microbatches) == ("block", 2)
    kw = dict(batch_override=4, seq_override=16)
    got = batch_iterator(run.model, run.shape, start_step=5, **kw)
    want = j_batch_iterator(j_smoke_config(J_ARCHS["gemma2-2b"]), J_SHAPES["train_4k"],
                            start_step=5, **kw)
    for step in (5, 6, 7):
        b, jb = next(got), next(want)
        ref = make_batch(cfg, SHAPES["train_4k"], step, **kw)
        for k in ("tokens", "labels"):
            assert torch.equal(b[k], ref[k]), (step, k)
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(jb[k]))


def test_batches_are_pure_functions_of_step():
    cfg = smoke_config(ARCHS["qwen2.5-32b"])
    b1 = make_batch(cfg, SHAPES["train_4k"], 7, batch_override=4, seq_override=16)
    b2 = make_batch(cfg, SHAPES["train_4k"], 7, batch_override=4, seq_override=16)
    assert torch.equal(b1["tokens"], b2["tokens"])
    b3 = make_batch(cfg, SHAPES["train_4k"], 8, batch_override=4, seq_override=16)
    assert not torch.equal(b1["tokens"], b3["tokens"])


def test_batches_have_learnable_structure():
    cfg = smoke_config(ARCHS["qwen2.5-32b"])
    toks = make_batch(cfg, SHAPES["train_4k"], 0, batch_override=16,
                      seq_override=64)["tokens"].numpy()
    assert toks.min() >= 0 and toks.max() < cfg.vocab_size
    top = np.sort(np.bincount(toks.ravel()))[::-1][:10].sum() / toks.size
    assert top > 0.3, top


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "seamless-m4t-large-v2"])
def test_frontend_batches_not_ported(arch):
    """Both front ends' batches are ported (``test_torch_vlm_encdec.py``
    holds them against the reference's); a front end the reference does not
    define is refused."""
    cfg = smoke_config(ARCHS[arch])
    batch = make_batch(cfg, SHAPES["train_4k"], 0, batch_override=2, seq_override=16)
    name = "patch_embeds" if cfg.frontend == "vision" else "frames"
    assert set(batch) == {"tokens", "labels", name}
    with pytest.raises(ValueError, match="unknown frontend"):
        make_batch(dataclasses.replace(cfg, frontend="video"), SHAPES["train_4k"], 0,
                   batch_override=2, seq_override=16)


def _topic_corpus(rng, n=256, s=24, vocab=97):
    topics = rng.integers(0, 4, size=n)
    return (topics[:, None] * (vocab // 4)
            + rng.integers(0, vocab // 4, size=(n, s))).astype(np.int32), vocab


def _dyadic(seed, n=512, s=32, vocab=200, width=24):
    """A table on the grid of quarters in [-2, 2) and s a power of two:
    every pooled mean, and every sum of them, is exact in f32."""
    rng = np.random.default_rng(seed)
    table = (rng.integers(-8, 8, size=(vocab, width)) / 4).astype(np.float32)
    toks = rng.integers(0, vocab, size=(n, s)).astype(np.int32)
    return toks, vocab, table


def test_projection_matches_reference_within_ulps():
    """The port's random projection against the reference's (its normals
    differ by the ulps ``test_torch_prng`` bounds)."""
    kf = jax.random.split(jax.random.PRNGKey(0))[0]
    want = np.asarray(jax.random.normal(kf, (97, 16), jnp.float32) / 4.0)
    got = projection(prng.split(prng.PRNGKey(0))[0], 97, 16).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_featurize_matches_reference(rng):
    toks, vocab = _topic_corpus(rng)
    kf = jax.random.split(jax.random.PRNGKey(0))[0]
    proj = np.array(jax.random.normal(kf, (vocab, 16), jnp.float32) / 4.0)
    want = np.asarray(j_featurize(jnp.asarray(toks), vocab, 16, key=kf))
    # the random path, its projection carried across as a table
    got = featurize(torch.from_numpy(toks), vocab, 16,
                    embed_table=torch.from_numpy(proj)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the port's own projection
    got = featurize(torch.from_numpy(toks), vocab, 16,
                    key=prng.split(prng.PRNGKey(0))[0]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the table path: the first dim columns of the pooled rows, rows chunked
    table = rng.normal(size=(vocab, 40)).astype(np.float32)
    want = np.asarray(j_featurize(jnp.asarray(toks), vocab, 16,
                                  embed_table=jnp.asarray(table)))
    got = featurize(torch.from_numpy(toks), vocab, 16,
                    embed_table=torch.from_numpy(table)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", range(3))
def test_featurize_bitwise_on_dyadic_tables(seed, monkeypatch):
    from repro_torch.data import instance_selection

    toks, vocab, table = _dyadic(seed)
    want = np.asarray(j_featurize(jnp.asarray(toks), vocab, 16,
                                  embed_table=jnp.asarray(table)))
    monkeypatch.setattr(instance_selection, "POOL_ROWS", 100)  # several chunks
    got = featurize(torch.from_numpy(toks), vocab, 16,
                    embed_table=torch.from_numpy(table)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _assert_selected_equal(got, want):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("scfg", [dict(feature_dim=16),
                                  dict(feature_dim=16, standardize=False),
                                  dict(feature_dim=8, threshold=3, iterations=1),
                                  dict(feature_dim=16, iterations=3, weighted=False)],
                         ids=["default", "raw", "t3m1", "m3unweighted"])
def test_select_instances_bitwise_on_dyadic_tables(seed, scfg):
    toks, vocab, table = _dyadic(seed)
    want = j_select(jnp.asarray(toks), vocab, JSelectionConfig(**scfg),
                    embed_table=jnp.asarray(table))
    got = select_instances(torch.from_numpy(toks), vocab, SelectionConfig(**scfg),
                           embed_table=torch.from_numpy(table))
    _assert_selected_equal(got, want)


def _agreement(got, want) -> float:
    a_g, a_w = got.assignment.numpy(), np.asarray(want.assignment)
    same = ((a_g == a_w)
            & (got.indices.numpy()[a_g] == np.asarray(want.indices)[a_w])
            & (got.weights.numpy()[a_g] == np.asarray(want.weights)[a_w]))
    return float(same.mean())


@pytest.mark.parametrize("corpus", ["four_topics", "two_topics"])
def test_select_instances_on_topic_corpora(rng, corpus):
    """The reference's two topic corpora, each package with its own
    random projection."""
    if corpus == "four_topics":
        toks, vocab = _topic_corpus(rng)
        scfg = dict(threshold=2, iterations=2, feature_dim=16)
    else:
        n, vocab = 128, 80
        topics = rng.integers(0, 2, size=n)
        toks = (topics[:, None] * 40 + rng.integers(0, 8, size=(n, 16))).astype(np.int32)
        scfg = dict(threshold=2, iterations=2, feature_dim=8)
    want = j_select(jnp.asarray(toks), vocab, JSelectionConfig(**scfg))
    got = select_instances(torch.from_numpy(toks), vocab, SelectionConfig(**scfg))
    assert _agreement(got, want) >= MIN_AGREEMENT


def test_instance_selection_reduces_and_weights(rng):
    n, s = 256, 24
    toks, vocab = _topic_corpus(rng, n, s)
    toks = torch.from_numpy(toks)
    sel = select_instances(toks, vocab, SelectionConfig(2, 2, feature_dim=16))
    n_sel = int(sel.valid.sum())
    assert n_sel <= n // 4
    total = float(torch.where(sel.valid, sel.weights, 0.0).sum())
    assert abs(total - n) < 1e-2
    assert int(sel.assignment.min()) >= 0
    idx = sel.indices[sel.valid]
    assert len(set(idx.tolist())) == n_sel
    rb = reduced_batch(toks, sel)
    assert tuple(rb["tokens"].shape) == (sel.indices.shape[0], s - 1)
    assert bool((rb["weights"][sel.valid] > 0).all())
    assert bool((rb["labels"][~sel.valid] == -1).all())


def test_instance_selection_groups_topics(rng):
    n = 128
    topics = rng.integers(0, 2, size=n)
    toks = torch.from_numpy(
        (topics[:, None] * 40 + rng.integers(0, 8, size=(n, 16))).astype(np.int32))
    assign = select_instances(toks, 80, SelectionConfig(2, 2, feature_dim=8)
                              ).assignment.numpy()
    same = cross = 0
    for i in range(0, n, 3):
        for j in range(1, n, 7):
            if assign[i] == assign[j]:
                if topics[i] == topics[j]:
                    same += 1
                else:
                    cross += 1
    assert same > 5 * max(cross, 1)


def test_medoid_is_the_nearest_member_lowest_index_first():
    """Each selected example is its prototype's member nearest the
    prototype, ties to the lowest example index (the reference's
    sequential scan of the stable order)."""
    toks, vocab, table = _dyadic(7, n=256, s=16)
    sel = select_instances(torch.from_numpy(toks), vocab,
                           SelectionConfig(feature_dim=8, standardize=False),
                           embed_table=torch.from_numpy(table))
    from repro_torch.core.itis import itis
    from repro_torch.data.instance_selection import featurize as feat

    x = feat(torch.from_numpy(toks), vocab, 8, embed_table=torch.from_numpy(table))
    r = itis(x, 2, 2, key=prng.split(prng.PRNGKey(0))[1], weighted=True)
    a = sel.assignment.numpy()
    for pid in np.unique(a):
        members = np.flatnonzero(a == pid)
        d = ((x[members] - r.protos[pid]) ** 2).sum(1).numpy()
        best = members[np.flatnonzero(d == d.min())[0]]
        assert int(sel.indices[pid]) == best


def test_reduced_batch_matches_reference(rng):
    toks, vocab = _topic_corpus(rng)
    want_sel = j_select(jnp.asarray(toks), vocab, JSelectionConfig(2, 2, feature_dim=16))
    want = j_reduced_batch(jnp.asarray(toks), want_sel)
    sel = select_instances(torch.from_numpy(toks), vocab, SelectionConfig(2, 2, feature_dim=16))
    got = reduced_batch(torch.from_numpy(toks), sel)
    for k in ("tokens", "labels", "weights"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
