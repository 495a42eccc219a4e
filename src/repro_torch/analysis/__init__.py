"""Static analysis of the PyTorch/CUDA port's runtime contracts — the
port of ``repro.analysis``, with the port's meaning of each rule.

The contracts that make the port fast and reproducible — no host sync on
the hot paths, config reads that a captured or compiled function cannot
keep stale, kernel geometry the card accepts, bitwise repeats — are
invariants the test suite can only spot-check: a stray ``.item()`` in a
loop or a float ``atomicAdd`` produces *correct numbers, slowly or
unreproducibly*. This package checks them structurally, over the Python
AST and the CUDA sources' text, with no runtime dependencies (no torch
import), so it runs before anything is built.

Layout (the reference's):

- ``registry``   ``@register_rule`` + resolution (cf. ``cluster.registry``)
- ``context``    per-file context (Python and ``.cu``) + the call-graph index
- ``rules/``     the rule families: RC, HS, RT, PK, DT, WN
- ``pragmas``    ``# repro_torch: allow[RULE]: reason`` suppressions
- ``baseline``   committed, reasoned debt ledger (``analysis-baseline-torch.json``)
- ``runner``     two-pass driver producing a settled :class:`Report`
- ``selftest``   per-rule bad/clean/pragma'd golden snippets
- ``__main__``   ``python -m repro_torch.analysis check|explain|baseline|self-test``

Import note: this package imports neither torch nor ``repro`` — keep it
that way (the port keeps its own copy of the reference's engine).
"""
from repro_torch.analysis.baseline import (
    Baseline,
    BaselineEntry,
    load_baseline,
    save_baseline,
)
from repro_torch.analysis.findings import Finding, PragmaError, Suppression
from repro_torch.analysis.registry import (
    FAMILIES,
    Rule,
    available_rules,
    iter_rules,
    register_rule,
    resolve_rule,
)
from repro_torch.analysis.runner import Report, gather_sources, run_check
from repro_torch.analysis.selftest import run_selftest

__all__ = [
    "Baseline",
    "BaselineEntry",
    "FAMILIES",
    "Finding",
    "PragmaError",
    "Report",
    "Rule",
    "Suppression",
    "available_rules",
    "gather_sources",
    "iter_rules",
    "load_baseline",
    "register_rule",
    "resolve_rule",
    "run_check",
    "run_selftest",
    "save_baseline",
]
