"""``repro_torch.fit`` against ``repro.fit`` (k-means backend, same key).

On a dyadic grid the level assignments, the prototypes and the final
labels agree bit for bit. Those runs use a one-block segment-sum fold on
both sides: under ``jit`` XLA:CPU does not keep the rounding of the
reference's 8-block fold once centroids leave the grid (see
test_torch_tc_itis.py). On the paper's GMM (continuous data) the bar is
label agreement ≥ 0.99 up to a renaming of the clusters and accuracy
within 0.01 of the JAX fit and ≥ 0.88.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import gmm_sample

import repro
import repro_torch
from repro import runtime as j_runtime
from repro_torch import prng
from repro_torch import runtime as t_runtime
from repro_torch.cluster.metrics import clustering_accuracy

torch.set_num_threads(1)


def dyadic(rng, shape, scale=0.25, lim=16):
    return (rng.integers(-lim, lim + 1, size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("t", [2, 3])
@pytest.mark.parametrize("m", [0, 1, 2, 3])
def test_fit_dyadic_bitwise(rng, t, m):
    x = dyadic(rng, (300, 2))
    jk = jax.random.PRNGKey(10 * t + m)
    tk = prng.key_from_numpy(np.asarray(jk))
    with j_runtime.configure(n_blocks=1):
        want = repro.fit(jnp.asarray(x), t, m, "kmeans", k=3, key=jk)
    with t_runtime.configure(n_blocks=1):
        got = repro_torch.fit(x, t, m, "kmeans", k=3, key=tk, device="cpu")
    assert len(got.assignments) == len(want.assignments)
    for a, b in zip(got.assignments, want.assignments):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for f in ("protos", "proto_mass", "proto_valid", "proto_labels", "n_prototypes"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert got.labels.dtype == torch.int32 and got.labels.shape == (300,)
    assert len(got.info["mis_rounds"]) == len(got.assignments)
    assert got.backend_result.iters >= 1


def test_fit_fused_policy_matches_default_on_cpu(rng):
    x = dyadic(rng, (200, 2))
    a = repro_torch.fit(x, 2, 2, "kmeans", k=3, device="cpu")
    b = repro_torch.fit(x, 2, 2, "kmeans", k=3, device="cpu", impl="fused",
                        knn_block=64)
    np.testing.assert_array_equal(a.labels.numpy(), b.labels.numpy())
    np.testing.assert_array_equal(a.protos.numpy(), b.protos.numpy())


@pytest.mark.parametrize("t,m", [(2, 1), (3, 1), (3, 2)])
def test_fit_gmm_matches_reference(t, m):
    x, comp = gmm_sample(2000, np.random.default_rng(0))
    want = np.asarray(repro.fit(jnp.asarray(x), t, m, "kmeans", k=3).labels)
    got = repro_torch.fit(x, t, m, "kmeans", k=3, device="cpu").labels.numpy()
    # cluster ids are arbitrary: agreement under the best renaming
    assert clustering_accuracy(want, got, 3) >= 0.99
    acc_j = clustering_accuracy(comp, want, 3)
    acc_t = clustering_accuracy(comp, got, 3)
    assert abs(acc_t - acc_j) <= 0.01
    assert acc_t >= 0.88


def test_fit_rejects_what_it_cannot_run(rng):
    x = dyadic(rng, (20, 2))
    with pytest.raises(ValueError, match="threshold t"):
        repro_torch.fit(x, 1, 2, device="cpu")
    with pytest.raises(ValueError, match="resident"):
        repro_torch.fit(iter([x]), 2, 1, executor="memory", device="cpu")
    with pytest.raises(ValueError, match="iterable of host chunks"):
        repro_torch.fit(x, 2, 1, executor="streaming", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        repro_torch.fit(x, 2, 1, "hac", device="cpu")
    with pytest.raises(ValueError, match="unknown executor"):
        repro_torch.fit(x, 2, 1, executor="sharded", device="cpu")
