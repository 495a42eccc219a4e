"""WN — warning hygiene.

A ``warnings.warn`` without ``stacklevel=`` reports the *library* line
that raised it, not the caller that triggered it. For the warnings the
port emits on behalf of user code (stale tune-cache winners, deprecated
aliases), that renders the warning useless: the user sees a line of
``repro_torch`` instead of their own call site, and
``-W error::DeprecationWarning`` jobs can't attribute the failure.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.context import FileContext
from repro_torch.analysis.registry import RawFinding, register_rule


@register_rule(
    "WN601",
    title="warnings.warn without stacklevel",
    explain="""
    ``warnings.warn(...)`` called without a ``stacklevel=`` keyword.
    The default (``stacklevel=1``) attributes the warning to the line
    inside this library that raised it — the one place the user did not
    write. Warnings that fire on behalf of a caller must pass
    ``stacklevel=2`` (or deeper, matching the wrapper depth) so the
    reported filename/lineno is the user's call site; the tune-cache
    prune warning is the port's example. If the warning genuinely
    concerns this module itself (an import-time environment notice), say
    so with a pragma.
    """,
)
def wn601(ctx: FileContext) -> Iterator[RawFinding]:
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        if ctx.dotted(node.func) != "warnings.warn":
            continue
        if any(kw.arg == "stacklevel" for kw in node.keywords):
            continue
        yield node, (
            "warnings.warn(...) without stacklevel= reports the library "
            "line, not the caller's — pass stacklevel=2 (or deeper) so "
            "the warning points at the triggering call site")
