"""Rule registry — the analyzer's twin of the backend/executor registries.

Rules register with ``@register_rule(...)`` exactly the way clustering
backends register with ``@register_backend`` and fit executors with
``@register_executor``: a decorator validates the contract at import time
and a resolver is the single lookup point. A rule is a checker function

    fn(ctx: FileContext | CudaContext) -> Iterable[RawFinding]

where a ``RawFinding`` is ``(node_or_line, message)`` — the runner turns it
into a located :class:`repro_torch.analysis.findings.Finding`. Rules that need
whole-package context (the RC call-graph rule) read ``ctx.project``. A
rule reads Python modules, CUDA sources or both (``languages``).

Rule ids are ``<FAMILY><number>`` (``RC101``); the family prefix groups
rules that police one contract, the families of the reference's analyzer
(``repro.analysis``) with the port's meaning of each.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

# rule family prefix -> what contract it polices
FAMILIES = {
    "RC": "runtime-config dispatch contract (config reads and CUDA-graph "
          "capture / torch.compile)",
    "HS": "host-sync discipline on hot paths (kernels, core, serve)",
    "RT": "re-capture and recompile hazards",
    "PK": "CUDA kernel geometry (warps, launch bounds, static shared memory)",
    "DT": "determinism (seeded draws, ordered iteration, no float atomics)",
    "WN": "warning hygiene",
}

# (ast node | int line, message)
RawFinding = Tuple[Union[object, int], str]
CheckFn = Callable[..., Iterable[RawFinding]]


@dataclasses.dataclass(frozen=True)
class Rule:
    """A registered rule: id, one-line title, long explanation, checker."""

    rule_id: str
    title: str
    explain: str
    check: CheckFn
    # path prefixes (repo-relative, posix) the rule is restricted to;
    # empty = every analyzed file
    scope: Tuple[str, ...] = ()
    # the sources it reads: "py" modules, "cu" CUDA sources
    languages: Tuple[str, ...] = ("py",)

    @property
    def family(self) -> str:
        return "".join(c for c in self.rule_id if c.isalpha())

    def applies_to(self, path: str) -> bool:
        if path.rsplit(".", 1)[-1] not in self.languages:
            return False
        if not self.scope:
            return True
        return any(path.startswith(prefix) for prefix in self.scope)


_REGISTRY: Dict[str, Rule] = {}


def register_rule(rule_id: str, *, title: str, explain: str,
                  scope: Tuple[str, ...] = (),
                  languages: Tuple[str, ...] = ("py",)) -> Callable[[CheckFn], CheckFn]:
    """Decorator: ``@register_rule("RC101", title=..., explain=...)``.

    Validates the id (known family prefix, unique) and the checker
    signature (must accept exactly one positional ``ctx`` argument) at
    import time, mirroring ``register_backend``'s fail-at-import policy —
    a malformed rule must never surface as a silent no-op in CI.
    """
    family = "".join(c for c in rule_id if c.isalpha())
    if family not in FAMILIES:
        raise ValueError(
            f"rule id {rule_id!r} has unknown family {family!r}; "
            f"known families: {sorted(FAMILIES)}")
    if not title or not explain:
        raise ValueError(f"rule {rule_id!r} needs a title and an explain text")

    def deco(fn: CheckFn) -> CheckFn:
        if rule_id in _REGISTRY and _REGISTRY[rule_id].check is not fn:
            raise ValueError(f"rule {rule_id!r} is already registered")
        sig = inspect.signature(fn)
        positional = [
            p for p in sig.parameters.values()
            if p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                          inspect.Parameter.POSITIONAL_OR_KEYWORD)
        ]
        if len(positional) != 1:
            raise TypeError(
                f"rule {rule_id!r} checker must take exactly one positional "
                f"argument (the file's context); signature is {sig}")
        _REGISTRY[rule_id] = Rule(rule_id=rule_id, title=title,
                                  explain=inspect.cleandoc(explain),
                                  check=fn, scope=scope,
                                  languages=tuple(languages))
        return fn

    return deco


def _ensure_builtin_rules() -> None:
    # importing the package runs every @register_rule decorator; local
    # import keeps the registry importable without a cycle
    from repro_torch.analysis import rules  # noqa: F401


def resolve_rule(rule_id: str) -> Rule:
    """Rule id -> Rule (the one lookup point; raises on unknown ids)."""
    _ensure_builtin_rules()
    if rule_id not in _REGISTRY:
        raise ValueError(
            f"unknown rule {rule_id!r}; have {available_rules()}")
    return _REGISTRY[rule_id]


def known_rule(rule_id: str) -> bool:
    _ensure_builtin_rules()
    return rule_id in _REGISTRY


def available_rules() -> List[str]:
    """Sorted ids of every registered rule."""
    _ensure_builtin_rules()
    return sorted(_REGISTRY)


def iter_rules(only: Optional[Iterable[str]] = None) -> List[Rule]:
    """Registered rules, optionally restricted to the given ids."""
    _ensure_builtin_rules()
    if only is None:
        return [_REGISTRY[k] for k in sorted(_REGISTRY)]
    return [resolve_rule(r) for r in only]
