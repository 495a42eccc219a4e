"""RT — re-capture and recompile hazards.

The RC rules make config changes reach captured code; these catch the
patterns that defeat that from the other side: mutating the process
default inside a scoped override (the mutation is shadowed, so nothing
changes until the scope exits), mutable defaults of a compiled function
(``torch.compile`` guards on them), and CUDA graphs or compiled wrappers
built anew in every round of a loop (every round captures or compiles
again). The reference's RT rules are the same hazards at ``jax.jit``.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.context import BUILD_CALLS, FileContext
from repro_torch.analysis.registry import RawFinding, register_rule

_MUTATORS = ("repro_torch.runtime.update_default", "repro_torch.runtime.set_default",
             "repro_torch.runtime.config.update_default",
             "repro_torch.runtime.config.set_default")
_CONFIGURE = ("repro_torch.runtime.configure", "repro_torch.runtime.config.configure")


@register_rule(
    "RT301",
    title="process-default config mutation inside a configure() scope",
    explain="""
    ``runtime.update_default(...)`` / ``runtime.set_default(...)`` called
    lexically inside a ``with runtime.configure(...):`` block. The scoped
    override sits on top of the default on the thread-local stack, so the
    mutated default is shadowed until the scope exits: dispatch keeps
    resolving the scope's values, and the "change" silently applies only
    after an unwind the author may be three frames away from. Mutate the
    default outside the scope, or use a nested ``configure(...)``
    override instead.
    """,
)
def rt301(ctx: FileContext) -> Iterator[RawFinding]:
    scopes = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                expr = item.context_expr
                if isinstance(expr, ast.Call) \
                        and ctx.dotted(expr.func) in _CONFIGURE:
                    scopes.append(node)
                    break
    for scope in scopes:
        for node in ast.walk(scope):
            if isinstance(node, ast.Call) \
                    and ctx.dotted(node.func) in _MUTATORS:
                fn = ctx.dotted(node.func).rsplit(".", 1)[-1]
                yield node, (
                    f"runtime.{fn}(...) inside a `with runtime.configure"
                    f"(...)` scope — the scoped override shadows the "
                    f"mutated default, so the change is invisible until the "
                    f"scope exits")


@register_rule(
    "RT302",
    title="compiled or captured function with a mutable default argument",
    explain="""
    A function that runs compiled or captured (``@torch.compile``, a
    callable handed to ``torch.compile`` / ``make_graphed_callables``, or
    called inside ``with torch.cuda.graph(...)``) takes a parameter whose
    default is a list / dict / set. ``torch.compile`` guards on the
    default's contents: a call that mutates it recompiles the next call,
    and the shared object carries state from one call into the next —
    into a graph that was captured with the old contents. Use a tuple /
    frozenset / None default (the counterpart of the reference's rule on
    a jit static's unhashable default).
    """,
)
def rt302(ctx: FileContext) -> Iterator[RawFinding]:
    for node, info in ctx.functions.items():
        if not info.captured:
            continue
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        a = node.args
        pos = a.posonlyargs + a.args
        pairs = list(zip(pos[len(pos) - len(a.defaults):], a.defaults,
                         strict=True))
        pairs += [(arg, d)
                  for arg, d in zip(a.kwonlyargs, a.kw_defaults, strict=True)
                  if d is not None]
        for arg, default in pairs:
            if isinstance(default, (ast.List, ast.Dict, ast.Set, ast.DictComp,
                                    ast.ListComp, ast.SetComp)):
                kind = type(default).__name__.lower().replace("comp", " comp")
                yield default, (
                    f"argument `{arg.arg}` of captured `{info.qualname}` "
                    f"defaults to a {kind} — torch.compile guards on its "
                    f"contents and the shared object leaks state between "
                    f"calls; use tuple/frozenset/None")


@register_rule(
    "RT303",
    title="CUDA graph or torch.compile built inside a loop",
    explain="""
    ``torch.cuda.CUDAGraph()``, ``torch.compile(...)`` or
    ``torch.cuda.make_graphed_callables(...)`` called in a for/while body.
    A graph is captured, and a compiled wrapper keeps its cache, per
    object: one built per round captures or compiles again every round,
    even when shapes repeat — the cost a graph exists to avoid, paid n
    times. Build it once, outside the loop (or cache it by shape, as a
    decode step's graph per cache size would be). A sweep that *intends*
    one capture per round (each a different shape) carries a pragma
    saying so.
    """,
)
def rt303(ctx: FileContext) -> Iterator[RawFinding]:
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call) \
                and ctx.dotted(node.func) in BUILD_CALLS \
                and ctx.in_loop(node):
            yield node, (
                f"{ctx.dotted(node.func)}(...) inside a loop body captures or "
                f"compiles anew every round; build it once, outside the loop")
