"""repro_torch.tune — empirical dispatch tuning with a persistent cache.

The port of ``repro.tune``. The dispatch knobs (each kernel's route —
the port's counterpart of the Pallas ``block_q``/``block_k`` tiles the
reference sweeps, since the CUDA tiles are fixed when a kernel is
compiled —, the impl choice, the blocked-kNN row block, the streaming
chunk budget) default to hand-picked constants and shape rules. This
package measures the candidates per device kind and shape bucket and
persists the winners.

Policy (``RuntimeConfig.tune`` / ``REPRO_TORCH_TUNE``):

  * ``"off"``      — the default; every constant and rule as written.
  * ``"cached"``   — consult the cache, the constants on a miss; never
    measures.
  * ``"onthefly"`` — consult the cache and measure on a miss, persisting
    the winner.

:func:`tuned_params` is the one gate every consumer goes through (the
ops of :mod:`repro_torch.kernels.ops`, ``core.knn.resolve_auto_block``,
``plan_fit``); with the policy off it returns ``{}`` without touching the
cache, so the off path costs one config read. A winner that can no longer
be honoured (an impl the port does not register, a plain version under a
card's kind, a route its bucket's edge cannot run, a tile that is not a
power of two) is warned about, pruned and ignored before any launch.

CLI: ``python -m repro_torch.tune populate|show|prune|clear``.
"""
from __future__ import annotations

import os
import warnings
from typing import Any, Dict, Mapping, Optional

from repro_torch import runtime
from repro_torch.runtime.config import TUNE_CACHE_ENV as CACHE_ENV
from repro_torch.tune.cache import (  # noqa: F401  (re-exported API)
    TuningCache,
    cache_epoch,
    default_cache_path,
    get_cache,
    pow2_bucket,
    set_cache,
    shape_bucket,
)

__all__ = [
    "CACHE_ENV", "TuningCache", "autotune_cell", "cache_epoch",
    "default_cache_path", "get_cache", "pow2_bucket", "set_cache",
    "shape_bucket", "tuned_params",
]

# cached params that size a block/tile/budget: every candidate is a power
# of two and buckets round up to powers of two, so "a positive power of
# two" is exactly "still divides some bucket edge"
_SIZE_PARAMS = ("block_q", "block_k", "block_s", "block_n", "knn_block",
                "chunk_n", "reservoir_n")

# the package's directory, as its modules' frames spell it and normalized:
# the stale warning skips those frames, so it points at the code that
# called into the port
_PACKAGE_DIRS = tuple({os.path.dirname(os.path.dirname(f)) + os.sep
                       for f in (__file__, os.path.abspath(__file__))})


def _route_reason(kernel: Optional[str], name: Any,
                  dims: Optional[Mapping[str, int]]) -> Optional[str]:
    """Why ``name`` is no route of cell ``kernel`` at the edge of the
    bucket of ``dims`` (None = fine). Every route bound is a power of two,
    so a route that runs at the edge runs every shape of the bucket."""
    from repro_torch.kernels import fused_assign, pairwise_l2
    from repro_torch.kernels import segment_sum as segsum

    cells = {"knn": fused_assign.ROUTES, "assign": fused_assign.ROUTES,
             "pairwise_sq_l2": pairwise_l2.ROUTES, "segment_sum": segsum.ROUTES}
    if not isinstance(name, str):
        return f"route {name!r} is not a route name"
    if kernel is None:
        known = {r for names in cells.values() for r in names}
        return None if name in known else f"route {name!r} is no kernel's route"
    if kernel not in cells:
        return f"cell {kernel!r} takes no route, got {name!r}"
    if name not in cells[kernel]:
        return f"route {name!r} is not one of {kernel}'s {cells[kernel]}"
    if dims is None:
        return None
    edge = {a: pow2_bucket(v) for a, v in dims.items()}
    if kernel in ("knn", "assign"):
        ok = fused_assign.route_ok(name, edge.get("d", 1), edge.get("k", 1))
    elif kernel == "pairwise_sq_l2":
        ok = pairwise_l2.route_ok(name, edge.get("m", 1), edge.get("d", 1))
    else:
        ok = segsum.route_ok(name, edge.get("s", 1))
    return None if ok else (f"route {name!r} cannot run the bucket edge "
                            f"{shape_bucket(**dims)}")


def _stale_reason(params: Any, kernel: Optional[str] = None,
                  device_kind: str = "cpu",
                  dims: Optional[Mapping[str, int]] = None) -> Optional[str]:
    """Why a cached winner can no longer be honoured (None = fine): the
    reference's checks against the port's impls, plus a plain version
    under a card's kind (the main path never runs it when a card is
    present) and a route that is not ``kernel``'s or cannot run the edge
    of the bucket of ``dims``."""
    if not isinstance(params, dict):
        return f"params is {type(params).__name__}, not a dict"
    impl = params.get("impl")
    if impl is not None:
        if not isinstance(impl, str) or impl not in runtime.IMPLS or impl == "auto":
            return f"impl {impl!r} is not a registered impl"
        if impl == "ref" and device_kind != "cpu":
            return (f"impl 'ref' (the plain version) under the card's kind "
                    f"{device_kind!r}")
    for name in _SIZE_PARAMS:
        if name not in params:
            continue
        v = params[name]
        if not isinstance(v, int) or isinstance(v, bool) or v < 1 \
                or (v & (v - 1)) != 0:
            return (f"{name}={v!r} is not a positive power of two and "
                    f"cannot tile a pow2 shape bucket")
    # prefetch_depth is a queue depth, not a tile: any int >= 0
    if "prefetch_depth" in params:
        v = params["prefetch_depth"]
        if not isinstance(v, int) or isinstance(v, bool) or v < 0:
            return f"prefetch_depth={v!r} is not a non-negative int"
    if "route" in params:
        return _route_reason(kernel, params["route"], dims)
    return None


def tuned_params(kernel: str, *, dtype: str = "float32", device: Any = None,
                 **dims: int) -> Dict[str, Any]:
    """Winning params for ``kernel`` at the bucket of ``dims`` on ``device``
    (default: the configured one), or ``{}``.

    ``off`` never looks, ``cached`` looks but never measures, ``onthefly``
    measures (and persists) on a miss. A missing key in the result means
    "use the constant". A stale entry is warned about (pointing at the
    caller outside the package), pruned from the cache and the file, and
    ignored.
    """
    mode = runtime.active().tune
    if mode == "off":
        return {}
    from repro_torch.tune.autotune import current_device_kind

    device_kind = current_device_kind(device)
    bucket = shape_bucket(**dims)
    cache = get_cache()
    params = cache.lookup(device_kind, kernel, bucket, dtype)
    if params is not None:
        reason = _stale_reason(params, kernel, device_kind, dims)
        if reason is not None:
            warnings.warn(
                f"ignoring stale tuning-cache entry "
                f"{device_kind}|{kernel}|{bucket}|{dtype}: {reason}; "
                f"pruned — falling back to the built-in constants "
                f"(re-run `python -m repro_torch.tune populate` to "
                f"re-measure)",
                RuntimeWarning, stacklevel=2, skip_file_prefixes=_PACKAGE_DIRS)
            cache.discard(device_kind, kernel, bucket, dtype)
            params = None
    if params is None and mode == "onthefly":
        from repro_torch.tune.autotune import autotune_cell

        params, _ = autotune_cell(kernel, dims, dtype=dtype, cache=cache,
                                  device=device)
    return dict(params or {})


def autotune_cell(*args, **kwargs):
    """Measure one cell now — see :func:`repro_torch.tune.autotune.autotune_cell`."""
    from repro_torch.tune import autotune

    return autotune.autotune_cell(*args, **kwargs)
