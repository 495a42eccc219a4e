"""The two-pass analysis driver.

Pass 1 parses every Python file into a :class:`FileContext` (and every
``.cu`` source into a :class:`CudaContext`) and feeds the
:class:`ProjectIndex`, which closes ``reads_config`` over the dotted-name
call graph — this is why the runner cannot be a per-file loop: RC102
needs the whole file set indexed before any rule runs. Pass 2 runs each
registered rule over each in-scope file, then settles every raw finding
against the file's pragmas and the committed baseline.

Sources arrive as a ``{repo-relative path: source}`` mapping, so tests and
the self-test analyze virtual files without touching disk; the CLI builds
the mapping by walking real directories.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.analysis.baseline import Baseline, BaselineEntry
from repro_torch.analysis.context import CudaContext, FileContext, ProjectIndex
from repro_torch.analysis.findings import Finding, PragmaError, Suppression
from repro_torch.analysis.pragmas import parse_pragmas
from repro_torch.analysis.registry import iter_rules


@dataclasses.dataclass
class Report:
    """Everything one ``check`` run learned, settled into buckets."""

    new: List[Finding] = dataclasses.field(default_factory=list)
    suppressed_pragma: List[Tuple[Finding, Suppression]] = \
        dataclasses.field(default_factory=list)
    suppressed_baseline: List[Finding] = dataclasses.field(
        default_factory=list)
    stale_baseline: List[BaselineEntry] = dataclasses.field(
        default_factory=list)
    pragma_errors: List[PragmaError] = dataclasses.field(
        default_factory=list)
    unused_pragmas: List[Suppression] = dataclasses.field(
        default_factory=list)
    files_checked: int = 0

    @property
    def ok(self) -> bool:
        """check passes iff there are no new findings and no bad pragmas.

        Stale baseline entries and unused pragmas are reported but do not
        fail the run — they are cleanup debt, not contract violations.
        """
        return not self.new and not self.pragma_errors

    def all_findings(self) -> List[Finding]:
        return (self.new
                + [f for f, _ in self.suppressed_pragma]
                + self.suppressed_baseline)


def _locate(ctx: FileContext, where: object) -> Tuple[int, int]:
    if isinstance(where, int):
        return where, 0
    line = getattr(where, "lineno", 0) or 0
    col = getattr(where, "col_offset", 0) or 0
    return line, col


def collect_findings(sources: Dict[str, str],
                     only: Optional[Iterable[str]] = None,
                     ) -> Tuple[List[Finding], List[PragmaError],
                                Dict[str, List[Suppression]]]:
    """Run the rules; return raw findings + pragma parse results.

    Findings here are *unsettled* — suppression/baseline matching is
    :func:`run_check`'s job.
    """
    project = ProjectIndex()
    contexts: List = []
    errors: List[PragmaError] = []
    for path in sorted(sources):
        if path.endswith(".cu"):
            contexts.append(CudaContext(path, sources[path], project=project))
            continue
        try:
            ctx = FileContext(path, sources[path], project=project)
        except SyntaxError as exc:
            errors.append(PragmaError(
                path=path, line=exc.lineno or 0,
                message=f"file does not parse: {exc.msg}"))
            continue
        project.add_file(ctx)
        contexts.append(ctx)
    project.finalize()

    rules = iter_rules(only)
    findings: List[Finding] = []
    suppressions: Dict[str, List[Suppression]] = {}
    for ctx in contexts:
        supp, perrs = parse_pragmas(ctx.path, ctx.source)
        suppressions[ctx.path] = supp
        errors.extend(perrs)
        for rule in rules:
            if not rule.applies_to(ctx.path):
                continue
            for where, message in rule.check(ctx):
                line, col = _locate(ctx, where)
                findings.append(Finding(
                    rule=rule.rule_id, path=ctx.path, line=line, col=col,
                    message=message, line_text=ctx.line_text(line)))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings, errors, suppressions


def run_check(sources: Dict[str, str],
              baseline: Optional[Baseline] = None,
              only: Optional[Iterable[str]] = None) -> Report:
    """Analyze ``sources`` and settle findings against pragmas+baseline."""
    baseline = baseline or Baseline()
    findings, errors, suppressions = collect_findings(sources, only)

    report = Report(pragma_errors=errors, files_checked=len(sources))
    used: set = set()
    for f in findings:
        supp = _matching_pragma(f, suppressions.get(f.path, ()))
        if supp is not None:
            used.add(id(supp))
            report.suppressed_pragma.append((f, supp))
        elif baseline.match(f):
            report.suppressed_baseline.append(f)
        else:
            report.new.append(f)
    for path in sorted(suppressions):
        for supp in suppressions[path]:
            if id(supp) not in used:
                report.unused_pragmas.append(supp)
    report.stale_baseline = baseline.stale(findings)
    return report


def _matching_pragma(finding: Finding,
                     supps: Iterable[Suppression],
                     ) -> Optional[Suppression]:
    for supp in supps:
        if supp.line == finding.line and finding.rule in supp.rules:
            return supp
    return None


# --------------------------------------------------------------- sources
_SKIP_DIRS = {"__pycache__", ".git", ".pytest_cache", ".ruff_cache"}


def gather_sources(paths: Iterable[str],
                   root: str = ".") -> Dict[str, str]:
    """Walk ``paths`` (files or directories, relative to ``root``) into a
    ``{repo-relative posix path: source}`` mapping of ``.py`` and ``.cu``
    files."""
    out: Dict[str, str] = {}
    for spec in paths:
        full = os.path.join(root, spec)
        if os.path.isfile(full):
            out[_rel(full, root)] = _read(full)
            continue
        for dirpath, dirnames, filenames in os.walk(full):
            dirnames[:] = sorted(
                d for d in dirnames if d not in _SKIP_DIRS)
            for fn in sorted(filenames):
                if fn.endswith((".py", ".cu")):
                    fp = os.path.join(dirpath, fn)
                    out[_rel(fp, root)] = _read(fp)
    return out


def _rel(path: str, root: str) -> str:
    return os.path.relpath(path, root).replace(os.sep, "/")


def _read(path: str) -> str:
    with open(path, "r", encoding="utf-8") as fh:
        return fh.read()
