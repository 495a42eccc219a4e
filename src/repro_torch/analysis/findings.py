"""Finding records and their stable fingerprints.

A finding is one rule violation at one source location. Findings are
matched against the committed baseline by *fingerprint* — ``(rule, path,
stripped source line)`` — never by line number, so unrelated edits above a
baselined site do not expire its entry.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str            # rule id, e.g. "RC101"
    path: str            # repo-relative posix path
    line: int            # 1-based
    col: int             # 0-based
    message: str         # one-line description of this occurrence
    line_text: str = ""  # stripped source of the flagged line

    def fingerprint(self) -> Tuple[str, str, str]:
        """Identity used for baseline matching (line numbers drift)."""
        return (self.rule, self.path, self.line_text)

    def format(self, *, suffix: str = "") -> str:
        tail = f"  [{suffix}]" if suffix else ""
        return (f"{self.path}:{self.line}:{self.col + 1}: "
                f"{self.rule} {self.message}{tail}")


@dataclasses.dataclass(frozen=True)
class PragmaError:
    """A malformed suppression pragma (missing reason / unknown rule id).

    Pragma errors fail ``check`` like findings do: an unreasoned
    suppression is exactly the silent contract erosion the analyzer
    exists to stop.
    """

    path: str
    line: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: PRAGMA {self.message}"


@dataclasses.dataclass(frozen=True)
class Suppression:
    """A parsed ``# repro_torch: allow[RULE,...]: reason`` pragma."""

    path: str
    line: int            # line the pragma suppresses (its own physical line,
                         # or the next line for a standalone comment)
    rules: Tuple[str, ...]
    reason: str
    comment_line: Optional[int] = None  # where the comment physically sits
