"""HS — host-sync discipline on the hot paths.

The fit, serve and kernel paths (``repro_torch/kernels``, ``repro_torch/core``,
``repro_torch/serve``) queue their work on the card and let the host run
ahead. A read of a device value on the host — ``.item()``, ``.cpu()``,
``.tolist()``, ``.numpy()``, ``np.asarray`` of a tensor, ``bool``/
``int``/``float`` of a tensor, ``torch.cuda.synchronize()`` — waits for
the card to drain its queue: latency the profiler attributes to nothing,
and in a loop, one stall a round (the MIS flag of ``core/tc.py``, ROADMAP
item 1). Deliberate sync points carry a ``# repro_torch: allow[HS...]:
reason`` pragma naming why (and, where one is planned, the ROADMAP item
that removes them); everything else is a bug.
"""
from __future__ import annotations

import ast
from typing import Iterator, Set

from repro_torch.analysis.context import FileContext
from repro_torch.analysis.registry import RawFinding, register_rule

HOT_PATHS = ("src/repro_torch/kernels/", "src/repro_torch/core/",
             "src/repro_torch/serve/")

# calls that force (or can force) a device->host transfer / sync
_SYNC_CALLS = {
    "numpy.asarray": "np.asarray",
    "numpy.array": "np.array",
    "numpy.ascontiguousarray": "np.ascontiguousarray",
    "torch.cuda.synchronize": "torch.cuda.synchronize",
}
_SYNC_METHODS = ("item", "cpu", "tolist", "numpy")

#: tensor methods whose result is a tensor (for the scalar-coercion rule:
#: ``bool(act.any())``)
_TENSOR_METHODS = frozenset({
    "any", "all", "sum", "max", "min", "amax", "amin", "mean", "prod", "count_nonzero",
    "argmax", "argmin", "norm", "abs", "eq", "ne", "lt", "le", "gt", "ge",
    "isfinite", "isnan", "isinf", "equal", "allclose",
})
#: modules whose methods of those names compute on the host
_HOST_ROOTS = frozenset({"np", "numpy", "math", "statistics"})


@register_rule(
    "HS201",
    title="device->host sync or copy on a hot path",
    explain="""
    ``.item()`` / ``.cpu()`` / ``.tolist()`` / ``.numpy()`` /
    ``np.asarray`` / ``np.array`` / ``np.ascontiguousarray`` /
    ``torch.cuda.synchronize()`` inside ``repro_torch/kernels``,
    ``repro_torch/core`` or ``repro_torch/serve``. On a CUDA tensor each
    blocks the host until the card has finished the work queued before
    it: the host can no longer run ahead, and the card idles while the
    host queues the next launches.

    The analyzer cannot see types, so every occurrence on a hot path is
    flagged; the documented sync points answer with a pragma stating the
    reason, e.g.::

        rounds = int(n.item())  # repro_torch: allow[HS201]: one read a level, after the loop (ROADMAP item 1)

    Anything without a pragma is either an accidental sync (fix: keep the
    value on the card, or batch the transfer at a documented boundary) or
    an undocumented one (fix: add the reasoned pragma).
    """,
    scope=HOT_PATHS,
)
def hs201(ctx: FileContext) -> Iterator[RawFinding]:
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = ctx.dotted(node.func)
        if name in _SYNC_CALLS:
            yield node, (
                f"{_SYNC_CALLS[name]}(...) on a hot path waits for the card "
                f"(a device->host sync) — sync points must be deliberate and "
                f"pragma'd")
        elif isinstance(node.func, ast.Attribute) \
                and node.func.attr in _SYNC_METHODS and not node.args \
                and not node.keywords:
            yield node, (
                f".{node.func.attr}() on a hot path blocks the host until the "
                f"card drains its queue — sync points must be deliberate and "
                f"pragma'd")


def _is_torch_value(node: ast.AST, tensor_names: Set[str]) -> bool:
    """A call rooted at ``torch``, a tensor method's result, or a local
    name assigned from either (or a subscript of one)."""
    if isinstance(node, ast.Call):
        cur = node.func
        method = isinstance(cur, ast.Attribute) and cur.attr in _TENSOR_METHODS
        while isinstance(cur, ast.Attribute):
            cur = cur.value
        root = cur.id if isinstance(cur, ast.Name) else ""
        return root == "torch" or (method and root not in _HOST_ROOTS)
    if isinstance(node, ast.Subscript):
        return _is_torch_value(node.value, tensor_names)
    if isinstance(node, ast.Compare):
        return any(_is_torch_value(x, tensor_names)
                   for x in [node.left, *node.comparators])
    return isinstance(node, ast.Name) and node.id in tensor_names


def _local_tensor_names(fn: ast.AST) -> Set[str]:
    """Names assigned from a torch call or a tensor method's result within
    ``fn`` (one level: ``x = torch.all(...); int(x)``)."""
    names: Set[str] = set()
    for sub in ast.walk(fn):
        if isinstance(sub, ast.Assign) and _is_torch_value(sub.value, set()):
            for t in sub.targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
    return names


@register_rule(
    "HS202",
    title="python scalar of a tensor on a hot path",
    explain="""
    ``int(...)`` / ``float(...)`` / ``bool(...)`` applied to a torch value
    (a call rooted at ``torch``, a tensor method's result such as
    ``act.any()``, or a local name assigned from one) inside the hot-path
    packages. Coercing a CUDA tensor to a python scalar waits for the
    card — per loop round, the difference between a loop the host runs
    ahead of and one that stalls every step (the MIS loop's flag,
    ``core/tc.py``, ROADMAP item 1).

    Fix by keeping the decision on the card, deriving the quantity from
    host-side arithmetic (shapes, counters), or — where a host decision
    point is genuinely required, e.g. an early exit — making the sync
    explicit and pragma'd.
    """,
    scope=HOT_PATHS,
)
def hs202(ctx: FileContext) -> Iterator[RawFinding]:
    locals_cache: dict = {}

    def scope_names(node: ast.AST) -> Set[str]:
        encl = next(
            (i.node for i in ctx.enclosing_functions(node)), ctx.tree)
        if encl not in locals_cache:
            locals_cache[encl] = _local_tensor_names(encl)
        return locals_cache[encl]

    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id in ("int", "float", "bool")
                and len(node.args) == 1 and not node.keywords):
            continue
        if _is_torch_value(node.args[0], scope_names(node)):
            yield node, (
                f"{node.func.id}() of a tensor waits for the card on a hot "
                f"path — derive it host-side or pragma the deliberate sync")
