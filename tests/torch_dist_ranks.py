"""Rank functions of tests/test_torch_distributed.py.

``repro_torch.launch.mesh.spawn_ranks`` starts each rank in a fresh
process and calls one of these by name, so they live in a module that
imports neither jax nor the JAX package (a rank imports only what it
runs). Each returns host numpy arrays; the test compares them with the
single-device port and the reference in its own process.
"""
import numpy as np
import torch

torch.set_num_threads(1)


def _np(t):
    return t.detach().cpu().numpy()


def _fit_fields(r):
    out = {f: _np(getattr(r, f)) for f in ("protos", "proto_mass", "proto_valid",
                                           "proto_labels", "n_prototypes")}
    out["labels"] = np.asarray(r.labels)
    if r.backend_result is not None:
        out["centers"] = _np(r.backend_result.centers)
    return out


def all_checks(rank, inp):
    """Every sharded piece on this rank's rows (see the test file)."""
    import repro_torch
    from repro_torch import prng, runtime
    from repro_torch.core import distributed as D
    from repro_torch.core.index import ClusterIndex
    from repro_torch.core.knn import ring_knn
    from repro_torch.data import stream_to_mesh
    from repro_torch.serve import ClusterService

    mesh = D.make_data_mesh(device_type="cpu")
    axis = D._axis(mesh, "data")
    rows = lambda a: D._local_rows(torch.from_numpy(a), axis)  # noqa: E731
    out = {"rank": axis.index, "size": axis.size}

    # ring kNN, on continuous and on dyadic points, some keys invalid
    for name in ("knn_x", "knn_dyadic"):
        d, i = ring_knn(rows(inp[name]), inp["knn_k"], axis=axis,
                        valid=rows(inp["knn_valid"]))
        out[name] = (_np(axis.gather_rows(d)), _np(axis.gather_rows(i)))

    # the ordered fold of the segment sums
    s, m = D._folded_segment_sum(rows(inp["seg_x"]), rows(inp["seg_ids"]),
                                 inp["seg_S"], rows(inp["seg_w"]), axis=axis,
                                 n_blocks=8, impl=None)
    out["segsum"] = (_np(s), _np(m))

    # TC
    tc = D.tc_sharded(rows(inp["tc_x"]), rows(inp["tc_valid"]), inp["tc_t"],
                      prng.PRNGKey(inp["tc_seed"]), axis=axis)
    out["tc"] = tuple(_np(a) for a in tc[:4]) + (tc.mis_rounds,)

    # mesh k-means
    km = D.kmeans_sharded(torch.from_numpy(inp["km_x"]), 3,
                          valid=torch.from_numpy(inp["km_valid"]),
                          weights=torch.from_numpy(inp["km_w"]),
                          key=prng.PRNGKey(3), mesh=mesh)
    out["kmeans"] = (_np(km.centers), _np(km.labels), _np(km.inertia), km.iters)

    # the fit, three ways in, and the deprecated drivers
    x, key = inp["fit_x"], prng.PRNGKey(7)
    res = repro_torch.fit(x, 3, 2, "kmeans", k=3, key=key, mesh=mesh, device="cpu")
    out["fit"] = _fit_fields(res)
    out["fit_info"] = dict(res.info)
    out["fit_executor"] = res.executor
    with runtime.configure(mesh=mesh):
        out["fit_configured"] = _fit_fields(
            repro_torch.fit(x, 3, 2, "kmeans", k=3, key=key, device="cpu"))
    out["fit_ihtc_sharded"] = _fit_fields(
        repro_torch.ihtc_sharded(x, 3, 2, "kmeans", k=3, key=key, mesh=mesh,
                                 device="cpu"))
    out["fit_ihtc"] = _fit_fields(
        repro_torch.ihtc(x, 3, 2, "kmeans", k=3, key=key, mesh=mesh, device="cpu"))
    try:
        repro_torch.fit(x, 3, 2, "kmeans", k=3, mesh=mesh, knn_block=64,
                        device="cpu")
        out["knn_block_raises"] = ""
    except ValueError as e:
        out["knn_block_raises"] = str(e)

    # the padded path
    pad = repro_torch.fit(inp["pad_x"], 2, 3, "kmeans", k=3, key=key, mesh=mesh,
                          device="cpu")
    out["padded"] = _fit_fields(pad)
    out["padded_info"] = dict(pad.info)

    # ingestion onto the mesh, and a fit of what it made
    chunks = [inp["fit_x"][i:i + 100] for i in range(0, 576, 100)]
    xs, vs = stream_to_mesh(iter(chunks), mesh, 576, x.shape[1], device="cpu")
    out["stream_to_mesh"] = (tuple(xs.shape), _np(axis.gather_rows(xs.to_local())),
                             _np(axis.gather_rows(vs.to_local())))
    out["fit_streamed"] = _fit_fields(repro_torch.fit(
        xs, 3, 2, "kmeans", k=3, key=key, valid=vs, mesh=mesh, device="cpu"))
    ragged = [inp["pad_x"][i:i + 128] for i in range(0, 500, 128)]
    xr, vr = stream_to_mesh(iter(ragged), mesh, 500, 2, device="cpu")
    out["stream_ragged"] = (tuple(xr.shape), _np(axis.gather_rows(xr.to_local())),
                            _np(axis.gather_rows(vr.to_local())))

    # the composed streaming path
    sx = inp["stream_x"]
    sres = repro_torch.fit(iter([sx[i:i + 256] for i in range(0, 768, 256)]),
                           2, 3, "kmeans", k=3, key=key, mesh=mesh,
                           reservoir_n=256, device="cpu")
    out["streaming_sharded"] = _fit_fields(sres)
    out["streaming_executor"] = sres.executor
    out["streaming_cascades"] = sres.n_cascades

    # a hole-heavy stream: near-duplicate chunks leave the reservoir mostly
    # holes, so it is compacted (gathered, squeezed, re-blocked)
    hole = repro_torch.fit(iter(inp["hole_chunks"]), 3, 2, "kmeans", k=1,
                           key=prng.PRNGKey(0), mesh=mesh, chunk_n=32,
                           reservoir_n=24, device="cpu")
    finalize_maps = len(hole.spill.ingest_stats["finalize_n_valid"])
    out["hole"] = dict(compactions=len(hole.spill.maps) - finalize_maps
                       - hole.n_cascades, labels=np.asarray(hole.labels),
                       mass=_np(hole.proto_mass[hole.proto_valid]))

    # serving under the mesh: 100 queries (not a multiple of 8: the pad path)
    idx = ClusterIndex.build(res)
    q = torch.from_numpy(inp["queries"])
    out["assign"] = _np(idx.assign(q, mesh=mesh))
    with runtime.configure(mesh=mesh):
        svc = ClusterService(idx, buckets=(32, 128))
        svc.warmup()
        out["assign_service"] = _np(svc.assign(q))
    return out


def fit_only(rank, inp):
    """The fit at the reference's device count."""
    import repro_torch
    from repro_torch import prng
    from repro_torch.core.distributed import make_data_mesh

    mesh = make_data_mesh(device_type="cpu")
    res = repro_torch.fit(inp["fit_x"], 3, 2, "kmeans", k=3, key=prng.PRNGKey(7),
                          mesh=mesh, device="cpu")
    return _fit_fields(res)


def fails_on_rank_1(rank):
    """Rank 1 raises while rank 0 waits in a collective."""
    from repro_torch.core.distributed import _axis, make_data_mesh

    axis = _axis(make_data_mesh(device_type="cpu"), "data")
    if rank == 1:
        raise RuntimeError("planted failure on rank 1")
    return axis.pmax(torch.ones(4))
