"""DT — determinism.

The port's reproducibility contract (ROADMAP's standing rules): same
config + same seed → identical assignments, identical checkpoints, and a
repeat on the card bitwise the first run. These rules catch what breaks
it silently — draws from torch's, numpy's or python's process-global RNG
(or one seeded from wall-clock/OS entropy), iteration orders the runtime
does not define (sets, directory listings), and float atomics, whose
order of additions changes from one run to the next.
"""
from __future__ import annotations

import ast
import re
from typing import Iterator, Optional

from repro_torch.analysis.context import FLOAT_TYPES, CudaContext, FileContext
from repro_torch.analysis.registry import RawFinding, register_rule

#: draws against the process-global numpy RNG — order-dependent across
#: every call site in the process, untouched by the repo's seed plumbing
_GLOBAL_NP_DRAWS = frozenset(
    f"numpy.random.{fn}" for fn in (
        "rand", "randn", "randint", "random", "random_sample", "normal",
        "uniform", "choice", "permutation", "shuffle", "standard_normal",
    ))
_GLOBAL_STDLIB_DRAWS = frozenset(
    f"random.{fn}" for fn in (
        "random", "randint", "randrange", "uniform", "choice", "choices",
        "sample", "shuffle", "gauss",
    ))
_RNG_FACTORIES = ("numpy.random.default_rng", "random.Random")
_SEEDERS = ("numpy.random.seed", "random.seed")

#: torch draws that take ``generator=``; without one they read the global
#: generator, whose state every other draw in the process moves
_TORCH_DRAWS = frozenset(
    f"torch.{fn}" for fn in ("rand", "rand_like", "randn", "randn_like", "randint",
                             "randint_like", "randperm", "normal", "bernoulli",
                             "multinomial", "poisson"))
_TORCH_DRAW_METHODS = frozenset({"normal_", "uniform_", "random_", "bernoulli_",
                                 "exponential_", "geometric_", "cauchy_",
                                 "log_normal_"})
_TORCH_GLOBAL_SEEDERS = frozenset({"torch.manual_seed", "torch.seed",
                                   "torch.cuda.manual_seed",
                                   "torch.cuda.manual_seed_all", "torch.random.seed",
                                   "torch.random.manual_seed"})

#: calls whose value is wall-clock / OS entropy — a seed derived from one
#: makes the "seed" different every run by construction
_ENTROPY_PREFIXES = ("time.", "secrets.", "uuid.")
_ENTROPY_CALLS = ("os.urandom",)


def _entropy_call(ctx: FileContext, node: ast.AST) -> Optional[str]:
    if not isinstance(node, ast.Call):
        return None
    name = ctx.dotted(node.func)
    if name is None:
        return None
    if name in _ENTROPY_CALLS or name.startswith(_ENTROPY_PREFIXES):
        return name
    return None


@register_rule(
    "DT501",
    title="unseeded, global or entropy-seeded randomness",
    explain="""
    A torch draw without ``generator=`` — ``torch.rand*`` / ``randn`` /
    ``randint`` / ``randperm`` / ``normal`` / ``bernoulli`` /
    ``multinomial``, or a tensor's ``normal_`` / ``uniform_`` /
    ``random_`` … — or a global ``torch.manual_seed`` /
    ``torch.cuda.manual_seed``; an RNG constructed from OS entropy
    (``np.random.default_rng()`` / ``random.Random()`` with no seed, a
    seed derived from ``time.*`` / ``os.urandom`` / ``secrets`` /
    ``uuid``); or any draw against the process-global ``np.random`` /
    ``random`` singletons.

    The contract is bit-exact reruns: the port threads explicit seeded
    ``torch.Generator``s (the weights) and the threefry keys of
    ``repro_torch.prng`` (TC seeds, k-means++) precisely so the same job
    replays identically. A draw from the global generator depends on
    every other draw in the process, and a global seed moves it for
    everyone. Fix by threading a generator or key from the caller.
    """,
)
def dt501(ctx: FileContext) -> Iterator[RawFinding]:
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in _TORCH_DRAW_METHODS \
                and not any(kw.arg == "generator" for kw in node.keywords):
            yield node, (
                f".{node.func.attr}(...) without generator= draws from torch's "
                f"global generator — thread a seeded torch.Generator")
            continue
        name = ctx.dotted(node.func)
        if name is None:
            continue
        if name in _TORCH_DRAWS and not any(kw.arg == "generator"
                                            for kw in node.keywords):
            yield node, (
                f"{name}(...) without generator= draws from torch's global "
                f"generator — thread a seeded torch.Generator")
            continue
        if name in _TORCH_GLOBAL_SEEDERS:
            yield node, (
                f"{name}(...) reseeds torch's process-global generator for "
                f"every caller — thread a seeded torch.Generator instead")
            continue
        if name in _GLOBAL_NP_DRAWS or name in _GLOBAL_STDLIB_DRAWS:
            yield node, (
                f"{name}(...) draws from the process-global RNG — state "
                f"depends on unrelated call sites; thread an explicit "
                f"seeded generator instead")
            continue
        if name in _RNG_FACTORIES or name in _SEEDERS:
            if not node.args and not node.keywords:
                yield node, (
                    f"{name}() with no seed draws OS entropy — two runs of "
                    f"the same job diverge; thread an explicit seed")
                continue
            seed = node.args[0] if node.args else None
            if seed is None:
                for kw in node.keywords:
                    if kw.arg in ("seed", None):
                        seed = kw.value
            ent = _entropy_call(ctx, seed) if seed is not None else None
            if ent:
                yield node, (
                    f"{name}(...) seeded from {ent}() — a wall-clock/OS "
                    f"entropy seed is different every run; derive seeds "
                    f"from the job seed")


def _sorted_wrapped(ctx: FileContext, node: ast.AST) -> bool:
    """Whether ``node`` is a direct argument of ``sorted(...)``."""
    parent = ctx.parents.get(node)
    return (isinstance(parent, ast.Call)
            and isinstance(parent.func, ast.Name)
            and parent.func.id == "sorted")


def _iteration_targets(tree: ast.AST) -> Iterator[ast.AST]:
    """Every expression something iterates over: for-loops and
    comprehension generators."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.For, ast.AsyncFor)):
            yield node.iter
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            for gen in node.generators:
                yield gen.iter


@register_rule(
    "DT502",
    title="iteration over a set with undefined order",
    explain="""
    A ``for`` loop or comprehension iterates a set literal or
    ``set(...)`` / ``frozenset(...)`` call directly. Set iteration order
    is a function of insertion history and hash seeding — stable enough to
    pass tests, unstable enough to reorder work across processes. When
    the loop feeds anything order-sensitive (accumulation into a float
    sum, key derivation, file emission order), two runs differ. Wrap in
    ``sorted(...)`` — the port pays the O(n log n) everywhere order can
    escape (cache keys in ``tune``, manifest writes in ``train``).
    """,
)
def dt502(ctx: FileContext) -> Iterator[RawFinding]:
    for it in _iteration_targets(ctx.tree):
        bad = None
        if isinstance(it, ast.Set):
            bad = "a set literal"
        elif isinstance(it, ast.Call) and isinstance(it.func, ast.Name) \
                and it.func.id in ("set", "frozenset"):
            bad = f"{it.func.id}(...)"
        if bad and not _sorted_wrapped(ctx, it):
            yield it, (
                f"iterating {bad} — set order is undefined across "
                f"processes; wrap in sorted(...) so downstream order is "
                f"reproducible")


_FS_LISTING_CALLS = {
    "os.listdir": "os.listdir",
    "os.scandir": "os.scandir",
    "glob.glob": "glob.glob",
    "glob.iglob": "glob.iglob",
}
_FS_LISTING_METHODS = ("iterdir", "glob", "rglob")


@register_rule(
    "DT503",
    title="unsorted filesystem listing order",
    explain="""
    A loop or comprehension iterates ``os.listdir`` / ``glob.glob`` /
    ``Path.iterdir`` output directly. Listing order is filesystem-
    dependent (POSIX guarantees nothing; it differs between ext4, tmpfs
    and object-store FUSE mounts) — so checkpoint discovery, shard
    ingestion and cache scans ordered by it do different things on
    different machines. ``sorted(...)`` makes the order part of the
    program. The checkpoint manager's retention scan is the canonical
    example: it must delete the *oldest* steps, not the first ones the
    filesystem happens to return.
    """,
)
def dt503(ctx: FileContext) -> Iterator[RawFinding]:
    for it in _iteration_targets(ctx.tree):
        if not isinstance(it, ast.Call) or _sorted_wrapped(ctx, it):
            continue
        name = ctx.dotted(it.func)
        label = None
        if name in _FS_LISTING_CALLS:
            label = _FS_LISTING_CALLS[name]
        elif isinstance(it.func, ast.Attribute) \
                and it.func.attr in _FS_LISTING_METHODS \
                and name is None:
            # method on a non-module object: Path(...).iterdir() and such
            label = f".{it.func.attr}()"
        if label:
            yield it, (
                f"iterating {label} output directly — filesystem listing "
                f"order is platform-dependent; wrap in sorted(...)")


_ATOMIC_RE = re.compile(r"\b(atomicAdd(?:_block|_system)?)\s*\(")
#: hot-path python ops that add floats in an order the card does not fix
_PY_ATOMIC_METHODS = ("index_add_", "scatter_add_", "index_add", "scatter_add")
_HOT_PATHS = ("src/repro_torch/kernels/", "src/repro_torch/core/",
              "src/repro_torch/serve/")


def _target_type(ctx: CudaContext, arg: str, before: int) -> Optional[str]:
    """The element type of the variable an atomic's first argument names
    (``&cnt[id]``, ``done``, ``&rare_n``), from its nearest declaration
    before ``before``: a parameter ``int* __restrict__ cnt``, a local or a
    ``__shared__`` one."""
    m = re.match(r"\s*&?\s*\(?\s*(\w+)", arg)
    if not m:
        return None
    var = m.group(1)
    decl = None
    pat = re.compile(r"((?:unsigned |signed |long )*[A-Za-z_]\w*)\s*(?:\*\s*)?"
                     r"(?:__restrict__\s*)?(?:const\s*)?(?:\*\s*)?\b" + var
                     + r"\b\s*(?:\[|[,;=)])")
    for d in pat.finditer(ctx.code, 0, before):
        if d.group(1) not in ("return", "else", "case", "goto"):
            decl = d
    return decl.group(1).strip() if decl else None


@register_rule(
    "DT504",
    title="float atomics: an addition order the card does not fix",
    explain="""
    In a CUDA source, ``atomicAdd`` / ``atomicAdd_block`` on a ``float``,
    ``double`` or half-precision target; on a hot path in Python
    (``repro_torch/kernels``, ``core``, ``serve``), ``index_add_``,
    ``scatter_add_`` or ``index_put_(..., accumulate=True)``. Float
    addition is not associative, and atomics (and these ops on a CUDA
    tensor, which use them) add in whatever order the threads arrive: two
    runs of the same job differ in their last bits, and the port's
    contract is that a repeat on the card is bitwise the first run (the
    fixed-tree fold of the segment sum, the rank-order gradient sum).
    Integer atomics (counters, slots) are exact in any order and stay
    clean. The plain versions, which run these ops on the CPU where
    ``index_add_`` folds the rows in order, answer with a pragma.
    """,
    languages=("py", "cu"),
)
def dt504(ctx) -> Iterator[RawFinding]:
    if isinstance(ctx, CudaContext):
        for m in _ATOMIC_RE.finditer(ctx.code):
            close = ctx.code.find(")", m.end())
            args = ctx.code[m.end():close]
            first = args.split(",")[0]
            ctype = _target_type(ctx, first, m.start())
            if ctype is None or ctype in FLOAT_TYPES:
                what = f"a {ctype} target" if ctype else "a target of unknown type"
                yield ctx.line_of(m.start()), (
                    f"{m.group(1)} on {what}: float additions in arrival order "
                    f"differ run to run — use a fixed-order reduction")
        return
    if not ctx.path.startswith(_HOT_PATHS):
        return
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
            continue
        attr = node.func.attr
        acc = attr in ("index_put_", "index_put") and any(
            kw.arg == "accumulate" and isinstance(kw.value, ast.Constant)
            and kw.value.value is True for kw in node.keywords)
        if attr in _PY_ATOMIC_METHODS or acc:
            yield node, (
                f".{attr}(...) on a hot path adds with atomics on a CUDA tensor, "
                f"in an order that differs run to run — use a fixed-order "
                f"reduction (the K3 fold), or pragma the CPU-only plain version")
