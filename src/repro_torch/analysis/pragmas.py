"""Suppression pragmas: ``# repro_torch: allow[RULE,...]: reason`` (in a
``.cu`` source ``// repro_torch: allow[RULE,...]: reason``).

Grammar (one comment, same physical line as the violation or a standalone
comment on the line directly above it)::

    # repro_torch: allow[HS201]: one flag read a round (ROADMAP item 1)
    # repro_torch: allow[RC101,RC102]: resolved before the capture

The prefix is the port's own: the reference's analyzer (``repro.analysis``,
which scans all of ``src/``) reads ``# repro: allow[...]`` and would fail a
pragma naming a rule it does not have; it does not read these.

The *reason* is mandatory: a suppression with no stated justification is
exactly the silent contract erosion the analyzer exists to prevent, so a
reasonless or unknown-rule pragma is a check failure (:class:`PragmaError`),
not a warning.

Parsing uses :mod:`tokenize`, not string search, so pragma examples inside
docstrings and string literals (this repo documents the grammar in several
places, including this module) never act as live suppressions.
"""
from __future__ import annotations

import io
import re
import tokenize
from typing import List, Tuple

from repro_torch.analysis.findings import PragmaError, Suppression
from repro_torch.analysis.registry import known_rule

PRAGMA_RE = re.compile(
    r"(?:#|//)\s*repro_torch:\s*allow\[(?P<rules>[^\]]*)\]\s*"
    r"(?::\s*(?P<reason>.*))?$")

#: loose detector for things that *look like* a pragma but do not parse —
#: a typo'd pragma must fail loudly, not silently suppress nothing
PRAGMA_HINT_RE = re.compile(r"(?:#|//)\s*repro_torch:")


def _comments(path: str, source: str) -> List[Tuple[str, int, int]]:
    """(text, line, column) of each comment: python comments by
    :mod:`tokenize`; in a ``.cu`` source each ``//`` comment."""
    if path.endswith(".cu"):
        out = []
        for i, line in enumerate(source.splitlines(), 1):
            m = re.search(r"//.*$", line)
            if m:
                out.append((m.group(0), i, m.start()))
        return out
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, IndentationError):
        return []  # the runner reports the syntax error
    return [(tok.string, tok.start[0], tok.start[1]) for tok in tokens
            if tok.type == tokenize.COMMENT]


def parse_pragmas(path: str, source: str,
                  ) -> Tuple[List[Suppression], List[PragmaError]]:
    """Extract suppressions (and malformed-pragma errors) from a module or
    a ``.cu`` source.

    A trailing comment suppresses its own line; a standalone comment
    (nothing but whitespace before it) suppresses the next line.
    """
    suppressions: List[Suppression] = []
    errors: List[PragmaError] = []
    for text, lineno, col in _comments(path, source):
        text = text.strip()
        if not PRAGMA_HINT_RE.match(text):
            continue
        m = PRAGMA_RE.match(text)
        if not m:
            errors.append(PragmaError(
                path=path, line=lineno,
                message=(f"malformed pragma {text!r} — expected "
                         f"`# repro_torch: allow[RULE,...]: reason`")))
            continue
        rules = tuple(r.strip() for r in m.group("rules").split(",")
                      if r.strip())
        reason = (m.group("reason") or "").strip()
        if not rules:
            errors.append(PragmaError(
                path=path, line=lineno,
                message="pragma suppresses no rules — allow[] is empty"))
            continue
        unknown = [r for r in rules if not known_rule(r)]
        if unknown:
            errors.append(PragmaError(
                path=path, line=lineno,
                message=(f"pragma names unknown rule(s) "
                         f"{', '.join(unknown)} — see "
                         f"`python -m repro_torch.analysis explain`")))
            continue
        if not reason:
            errors.append(PragmaError(
                path=path, line=lineno,
                message=(f"pragma allow[{','.join(rules)}] has no reason — "
                         f"a suppression must say *why* the contract does "
                         f"not apply here")))
            continue
        # standalone comment (only whitespace before it) covers the next
        # line; a trailing comment covers its own
        line_src = source.splitlines()[lineno - 1]
        standalone = line_src[:col].strip() == ""
        suppressions.append(Suppression(
            path=path,
            line=lineno + 1 if standalone else lineno,
            rules=rules,
            reason=reason,
            comment_line=lineno,
        ))
    return suppressions, errors
