"""CLI: ``python -m repro_torch.analysis <check|explain|baseline|self-test>``
(``--self-test`` too, as the reference's).

Run from the repo root — rule scopes and baseline paths are repo-relative.
By default it reads the port's package (``src/repro_torch``, its Python
modules and its CUDA sources) and the card's scripts (``chip_smoke.py``,
``chip_ab.py``), against its own baseline (``analysis-baseline-torch.json``).
Pure stdlib: it imports neither torch nor the package it reads.

Exit codes: 0 clean / self-test passed; 1 findings, pragma errors or
self-test failures; 2 usage errors.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import List

from repro_torch.analysis.baseline import (
    DEFAULT_BASELINE_PATH,
    extend_baseline,
    load_baseline,
    prune_baseline,
    save_baseline,
)
from repro_torch.analysis.registry import FAMILIES, available_rules, resolve_rule
from repro_torch.analysis.runner import Report, gather_sources, run_check
from repro_torch.analysis.selftest import run_selftest

DEFAULT_PATHS = ("src/repro_torch", "chip_smoke.py", "chip_ab.py")


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static analyzer for the PyTorch/CUDA port's runtime "
                    "contracts.")
    p.add_argument("--self-test", action="store_true",
                   help="verify every rule flags its canonical violation "
                        "and spares the repaired idiom, then exit")
    sub = p.add_subparsers(dest="command")

    chk = sub.add_parser("check", help="analyze files; fail on new findings")
    chk.add_argument("paths", nargs="*", default=list(DEFAULT_PATHS),
                     help="files/directories to analyze "
                          f"(default: {' '.join(DEFAULT_PATHS)})")
    chk.add_argument("--rules", help="comma-separated rule ids to run "
                                     "(default: all)")
    chk.add_argument("--baseline", default=DEFAULT_BASELINE_PATH,
                     help="baseline file (default: %(default)s)")
    chk.add_argument("--no-baseline", action="store_true",
                     help="ignore the baseline; report every finding")
    chk.add_argument("--json", action="store_true",
                     help="machine-readable report on stdout")
    chk.add_argument("--verbose", action="store_true",
                     help="also list pragma- and baseline-suppressed "
                          "findings")

    sub.add_parser("self-test", help="the --self-test flag as a command")

    exp = sub.add_parser("explain",
                         help="explain rule ids (no args: list all rules)")
    exp.add_argument("rules", nargs="*", help="rule ids, e.g. RC101 HS202")

    bl = sub.add_parser(
        "baseline",
        help="manage the committed findings baseline")
    bl.add_argument("paths", nargs="*", default=list(DEFAULT_PATHS))
    bl.add_argument("--baseline", default=DEFAULT_BASELINE_PATH)
    bl.add_argument("--write", action="store_true",
                    help="add every currently-new finding to the baseline "
                         "(requires --reason)")
    bl.add_argument("--reason",
                    help="why these findings are accepted (mandatory with "
                         "--write)")
    bl.add_argument("--prune", action="store_true",
                    help="drop baseline entries nothing matches anymore")
    return p


def main(argv: List[str] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    parser = _build_parser()
    args = parser.parse_args(argv)

    if args.self_test or args.command == "self-test":
        ok, lines = run_selftest()
        for line in lines:
            print(line)
        print("self-test:", "PASS" if ok else "FAIL")
        return 0 if ok else 1

    if args.command == "explain":
        return _cmd_explain(args)
    if args.command == "baseline":
        return _cmd_baseline(args)
    if args.command == "check" or args.command is None:
        if args.command is None:  # bare invocation = check with defaults
            args = parser.parse_args(["check"] + argv)
        return _cmd_check(args)
    parser.error(f"unknown command {args.command!r}")
    return 2


def _cmd_explain(args: argparse.Namespace) -> int:
    if not args.rules:
        print("rule families:")
        for fam in sorted(FAMILIES):
            print(f"  {fam}  {FAMILIES[fam]}")
        print("\nrules:")
        for rid in available_rules():
            print(f"  {rid}  {resolve_rule(rid).title}")
        print("\nsuppress with `# repro_torch: allow[RULE,...]: reason` "
              "(`//` in a .cu source; same line or the line above);")
        print("accept tracked debt with "
              "`python -m repro_torch.analysis baseline --write --reason ...`.")
        return 0
    try:
        rules = [resolve_rule(r) for r in args.rules]
    except ValueError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    for i, rule in enumerate(rules):
        if i:
            print()
        print(f"{rule.rule_id}: {rule.title}")
        print(f"  family: {rule.family} — {FAMILIES[rule.family]}")
        if rule.scope:
            print(f"  scope:  {', '.join(rule.scope)}")
        print()
        for line in rule.explain.splitlines():
            print(f"  {line}")
    return 0


def _run(paths: List[str], baseline_path: str, use_baseline: bool,
         only: List[str] = None) -> Report:
    sources = gather_sources(paths)
    baseline = load_baseline(baseline_path) if use_baseline else None
    return run_check(sources, baseline=baseline, only=only)


def _cmd_check(args: argparse.Namespace) -> int:
    only = args.rules.split(",") if args.rules else None
    try:
        report = _run(args.paths, args.baseline,
                      not args.no_baseline, only)
    except ValueError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2

    if args.json:
        print(json.dumps(_report_json(report), indent=2))
        return 0 if report.ok else 1

    for err in report.pragma_errors:
        print(err.format())
    for f in report.new:
        print(f.format())
    if args.verbose:
        for f, supp in report.suppressed_pragma:
            print(f.format(suffix=f"pragma: {supp.reason}"))
        for f in report.suppressed_baseline:
            print(f.format(suffix="baseline"))
    for supp in report.unused_pragmas:
        print(f"{supp.path}:{supp.comment_line}: note: unused pragma "
              f"allow[{','.join(supp.rules)}]")
    for entry in report.stale_baseline:
        print(f"{entry.path}: note: stale baseline entry {entry.rule} "
              f"(`{entry.line_text}`) — run "
              f"`python -m repro_torch.analysis baseline --prune`")

    n_supp = len(report.suppressed_pragma) + len(report.suppressed_baseline)
    print(f"{report.files_checked} files, {len(report.new)} new finding(s), "
          f"{n_supp} suppressed, {len(report.pragma_errors)} pragma "
          f"error(s)")
    return 0 if report.ok else 1


def _cmd_baseline(args: argparse.Namespace) -> int:
    if args.write and not (args.reason and args.reason.strip()):
        print("error: --write requires --reason (baseline entries must "
              "say why they are accepted)", file=sys.stderr)
        return 2
    if not args.write and not args.prune:
        print("error: nothing to do — pass --write and/or --prune",
              file=sys.stderr)
        return 2
    try:
        baseline = load_baseline(args.baseline)
        sources = gather_sources(args.paths)
        report = run_check(sources, baseline=baseline)
    except ValueError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    if args.prune:
        removed = prune_baseline(baseline, report.all_findings())
        print(f"pruned {removed} stale entr{'y' if removed == 1 else 'ies'}")
    if args.write:
        added = extend_baseline(baseline, report.new, args.reason)
        print(f"baselined {added} finding(s)")
    save_baseline(args.baseline, baseline)
    print(f"wrote {args.baseline} ({len(baseline)} entries)")
    return 0


def _report_json(report: Report) -> dict:
    return {
        "ok": report.ok,
        "files_checked": report.files_checked,
        "new": [dataclasses.asdict(f) for f in report.new],
        "suppressed_pragma": [
            {"finding": dataclasses.asdict(f), "reason": s.reason}
            for f, s in report.suppressed_pragma],
        "suppressed_baseline": [
            dataclasses.asdict(f) for f in report.suppressed_baseline],
        "pragma_errors": [
            dataclasses.asdict(e) for e in report.pragma_errors],
        "unused_pragmas": [
            {"path": s.path, "line": s.comment_line,
             "rules": list(s.rules)} for s in report.unused_pragmas],
        "stale_baseline": [
            dataclasses.asdict(e) for e in report.stale_baseline],
    }


if __name__ == "__main__":
    sys.exit(main())
