"""The committed findings baseline.

The baseline is the adoption mechanism: pre-existing, *justified* findings
live in a committed JSON file so ``check`` can gate on "no NEW findings"
from day one. Entries are matched by fingerprint — ``(rule, path, stripped
line text)`` — never line numbers, so edits elsewhere in a file do not
expire them. When the flagged line itself changes or disappears, the
entry goes stale and ``check`` reports it for pruning: a baseline only
shrinks.

Every entry carries a mandatory reason, same policy as pragmas. Pragmas
are for sites whose justification is local and permanent (a deliberate
sync point); the baseline is for debt being tracked toward zero. The
port keeps its own file, never the reference's ``analysis-baseline.json``.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterable, List, Tuple

from repro_torch.analysis.findings import Finding

BASELINE_VERSION = 1
DEFAULT_BASELINE_PATH = "analysis-baseline-torch.json"

Fingerprint = Tuple[str, str, str]  # (rule, path, line_text)


@dataclasses.dataclass(frozen=True)
class BaselineEntry:
    rule: str
    path: str
    line_text: str
    reason: str

    def fingerprint(self) -> Fingerprint:
        return (self.rule, self.path, self.line_text)


class Baseline:
    """In-memory view of the committed baseline file."""

    def __init__(self, entries: Iterable[BaselineEntry] = ()) -> None:
        self.entries: Dict[Fingerprint, BaselineEntry] = {}
        for e in entries:
            self.entries[e.fingerprint()] = e

    def __len__(self) -> int:
        return len(self.entries)

    def match(self, finding: Finding) -> bool:
        return finding.fingerprint() in self.entries

    def stale(self, findings: Iterable[Finding]) -> List[BaselineEntry]:
        """Entries no current finding matches — fixed or drifted; prune."""
        seen = {f.fingerprint() for f in findings}
        return [e for fp, e in sorted(self.entries.items())
                if fp not in seen]


def load_baseline(path: str) -> Baseline:
    """Read the baseline file; a missing file is an empty baseline."""
    try:
        with open(path, "r", encoding="utf-8") as fh:
            raw = json.load(fh)
    except FileNotFoundError:
        return Baseline()
    if not isinstance(raw, dict) or raw.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"{path}: not a v{BASELINE_VERSION} analysis baseline")
    entries = []
    for row in raw.get("entries", []):
        entry = BaselineEntry(
            rule=row["rule"], path=row["path"],
            line_text=row["line_text"], reason=row["reason"])
        if not entry.reason.strip():
            raise ValueError(
                f"{path}: baseline entry for {entry.rule} at {entry.path} "
                f"has no reason — every accepted finding must say why")
        entries.append(entry)
    return Baseline(entries)


def save_baseline(path: str, baseline: Baseline) -> None:
    rows = [dataclasses.asdict(e)
            for _, e in sorted(baseline.entries.items())]
    payload = {"version": BASELINE_VERSION, "entries": rows}
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=2, ensure_ascii=False)
        fh.write("\n")


def extend_baseline(baseline: Baseline, findings: Iterable[Finding],
                    reason: str) -> int:
    """Add every finding (by fingerprint) with ``reason``; returns #added."""
    if not reason.strip():
        raise ValueError("baseline entries require a --reason")
    added = 0
    for f in findings:
        fp = f.fingerprint()
        if fp not in baseline.entries:
            baseline.entries[fp] = BaselineEntry(
                rule=f.rule, path=f.path, line_text=f.line_text,
                reason=reason.strip())
            added += 1
    return added


def prune_baseline(baseline: Baseline,
                   findings: Iterable[Finding]) -> int:
    """Drop entries nothing matches anymore; returns #removed."""
    stale = baseline.stale(findings)
    for e in stale:
        del baseline.entries[e.fingerprint()]
    return len(stale)
