"""Built-in rule families. Importing this package runs every
``@register_rule`` decorator, populating the registry — the same
import-time registration the clustering backends use."""
from repro_torch.analysis.rules import dt, hs, pk, rc, rt, wn  # noqa: F401

__all__ = ["dt", "hs", "pk", "rc", "rt", "wn"]
