"""RC — the runtime-config dispatch contract, for captured and compiled code.

The contract: config resolution happens where it can be redone. Public
drivers read ``runtime.active()`` on every call and dispatch eagerly, so a
``configure(...)`` scope or ``update_default`` takes effect at the next
call. A function captured into a CUDA graph (``torch.cuda.graph``,
``make_graphed_callables``) or compiled (``torch.compile``) is different:
what it read from the config while it was captured or traced is baked
into the graph or the compiled code, and replaying it after the config
changed runs the old choice. Such a function must carry the runtime's
``dispatch_key()`` as a ``_dispatch`` parameter, so its caller re-captures
or recompiles when the key changes. ROADMAP items 4 (the decode step as
one captured graph) and 10 (the train step's graph) bring such functions;
these rules guard them before they land. The reference's RC rules police
the same contract at the ``jax.jit`` boundary.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.context import (
    CONFIG_READ_CALLS,
    DISPATCH_PARAM,
    FileContext,
)
from repro_torch.analysis.registry import RawFinding, register_rule


@register_rule(
    "RC101",
    title="config read inside a captured or compiled function without a "
          "_dispatch pin",
    explain="""
    A function that runs captured or compiled — a ``@torch.compile``
    decorated def, a callable handed to ``torch.compile(...)`` or
    ``torch.cuda.make_graphed_callables(...)``, a function called inside a
    ``with torch.cuda.graph(...)`` block, or the block itself — calls
    ``runtime.active()`` / ``runtime.dispatch_key()`` /
    ``runtime.default_config()`` directly, and takes no ``_dispatch``
    parameter.

    What the capture read is baked into the graph or the compiled code;
    without a ``_dispatch`` parameter nothing ties a replay to the
    configuration it was captured under — change the config, replay the
    stale choice. Fix by resolving the config before the capture and
    passing concrete values in, or by adding a ``_dispatch: tuple = ()``
    parameter fed ``runtime.dispatch_key()`` by a caller that re-captures
    when the key changes.
    """,
)
def rc101(ctx: FileContext) -> Iterator[RawFinding]:
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = ctx.dotted(node.func)
        if name not in CONFIG_READ_CALLS:
            continue
        cap = ctx.enclosing_capture(node)
        if cap is None or cap.has_dispatch:
            continue
        yield node, (
            f"`{ctx.line_text(node.lineno)[:60]}` reads the runtime config "
            f"inside captured `{cap.qualname}`, which has no "
            f"`{DISPATCH_PARAM}` parameter — a config change will not "
            f"re-capture it")


@register_rule(
    "RC102",
    title="captured or compiled function calls a config-reading callee "
          "without a _dispatch pin",
    explain="""
    A captured or compiled function without a ``_dispatch`` parameter
    calls — possibly through several layers — a function that reads the
    runtime config (the ``kernels.ops`` entry points, ``attend``, any
    public wrapper that resolves ``None`` kwargs from
    ``runtime.active()``). The read happens while *this* function is
    being captured, so it is exactly the RC101 hazard, one call deeper:
    the graph or the compiled code keeps the configuration the capture
    consulted.

    The call graph is resolved over dotted names across the analyzed file
    set (best-effort: dynamic dispatch and registry indirection do not
    propagate). Fix like RC101 — resolve before the capture, or add the
    ``_dispatch`` parameter and thread ``runtime.dispatch_key()`` from the
    call sites.
    """,
)
def rc102(ctx: FileContext) -> Iterator[RawFinding]:
    if ctx.project is None:
        return
    for info in ctx.functions.values():
        # config_read_lines, not reads_config: finalize() propagates the
        # latter transitively, and a *lexical* read is RC101's finding
        if not info.captured or info.has_dispatch or info.config_read_lines:
            continue
        readers = ctx.project.reading_callees(info)
        if not readers:
            continue
        pretty = ", ".join(r.rsplit(".", 1)[-1] for r in readers[:3])
        yield info.node, (
            f"captured `{info.qualname}` has no `{DISPATCH_PARAM}` parameter "
            f"but calls config-reading callee(s) {pretty} — the capture keeps "
            f"the config they resolve")


@register_rule(
    "RC103",
    title="REPRO_* environment read outside the runtime config",
    explain="""
    ``os.environ`` / ``os.getenv`` is consulted for a ``REPRO_TORCH_*`` or
    ``REPRO_*`` variable somewhere other than ``runtime/config.py``. The
    runtime config reads every override once, into the process default;
    a second ad-hoc read sees a different value after
    ``update_default``/``configure`` scopes, or changes behaviour
    mid-process when the environment mutates — configuration must flow
    through :class:`RuntimeConfig` so scoping, ``dispatch_key()`` and the
    documented precedence apply. Fix by adding a config field (and its
    environment entry) and reading the active config instead.
    """,
)
def rc103(ctx: FileContext) -> Iterator[RawFinding]:
    if ctx.path.endswith("runtime/config.py"):
        return
    for node in ast.walk(ctx.tree):
        var = None
        if isinstance(node, ast.Call):
            name = ctx.dotted(node.func)
            if name in ("os.getenv", "os.environ.get") and node.args:
                a0 = node.args[0]
                if isinstance(a0, ast.Constant) and isinstance(a0.value, str):
                    var = a0.value
        elif isinstance(node, ast.Subscript):
            if ctx.dotted(node.value) == "os.environ" \
                    and isinstance(node.slice, ast.Constant) \
                    and isinstance(node.slice.value, str) \
                    and isinstance(node.ctx, ast.Load):
                var = node.slice.value
        if var is not None and var.startswith("REPRO_"):
            yield node, (
                f"{var} read outside runtime/config.py — overrides must flow "
                f"through RuntimeConfig so scoped configure() and "
                f"dispatch_key() see them")
