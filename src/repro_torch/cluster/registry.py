"""Backend registry for IHTC's "sophisticated" clusterers — the port of
``repro.cluster.registry``.

Every backend satisfies one contract::

    fn(x, *, valid=None, weights=None, key=None, impl=None, **kwargs)
      -> (n,) int32 labels (-1 for invalid/noise rows),
         or a result with a ``.labels`` field (the planner keeps it)

checked by signature inspection at registration. The built-in backends
are k-means, HAC and DBSCAN, as in the reference.
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Union

BackendFn = Callable[..., Any]

REQUIRED_KWARGS = ("valid", "weights", "key", "impl")

_REGISTRY: Dict[str, BackendFn] = {}


def validate_backend_fn(fn: BackendFn, name: str = "") -> None:
    """Raise TypeError unless ``fn`` matches the BackendFn contract."""
    label = name or getattr(fn, "__name__", repr(fn))
    if not callable(fn):
        raise TypeError(f"backend {label!r} is not callable")
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return  # builtins/partials without introspectable signatures: trust
    params = list(sig.parameters.values())
    positional = [p for p in params
                  if p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                                inspect.Parameter.POSITIONAL_OR_KEYWORD)]
    if not positional and not any(
            p.kind is inspect.Parameter.VAR_POSITIONAL for p in params):
        raise TypeError(
            f"backend {label!r} must take the prototype array as its first "
            f"positional argument; signature is {sig}")
    accepts_var_kw = any(p.kind is inspect.Parameter.VAR_KEYWORD for p in params)
    missing = [kw for kw in REQUIRED_KWARGS
               if kw not in sig.parameters and not accepts_var_kw]
    if missing:
        raise TypeError(
            f"backend {label!r} must accept keyword argument(s) {missing} "
            f"(or **kwargs); signature is {sig}")


def register_backend(name: str) -> Callable[[BackendFn], BackendFn]:
    """Decorator: ``@register_backend("kmeans")`` on a BackendFn adapter."""

    def deco(fn: BackendFn) -> BackendFn:
        if name in _REGISTRY and _REGISTRY[name] is not fn:
            raise ValueError(f"backend {name!r} is already registered "
                             f"({_REGISTRY[name]!r})")
        validate_backend_fn(fn, name)
        _REGISTRY[name] = fn
        return fn

    return deco


def _ensure_builtin_backends() -> None:
    # importing the modules runs their @register_backend decorators
    from repro_torch.cluster import dbscan, hac, kmeans  # noqa: F401


def resolve_backend(backend: Union[str, BackendFn]) -> BackendFn:
    """Name or callable → validated BackendFn."""
    if callable(backend):
        validate_backend_fn(backend)
        return backend
    _ensure_builtin_backends()
    if backend not in _REGISTRY:
        raise ValueError(f"unknown backend {backend!r}; have {available_backends()}")
    return _REGISTRY[backend]


def available_backends() -> list:
    """Sorted names of every registered backend."""
    _ensure_builtin_backends()
    return sorted(_REGISTRY)
