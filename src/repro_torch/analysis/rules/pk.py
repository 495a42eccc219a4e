"""PK — kernel geometry of the CUDA sources (``src/repro_torch/csrc/*.cu``).

A Hopper block is scheduled in warps of 32 threads: a block size that is
not a multiple of 32 leaves lanes of its last warp idle on every
instruction, and a launch of more threads than the kernel's
``__launch_bounds__`` fails at run time (fewer than it promised wastes the
registers the bound bought). Static ``__shared__`` memory is capped at
48 KB a block — more fails in ``ptxas``, on the card's build only (the
CPU tests never compile a kernel), and dynamic shared memory past 48 KB
is a launch-time request (``cudaFuncSetAttribute``, up to 227 KB), not a
declaration these rules read.

The rules read the sources as text: the file's ``constexpr`` integers,
each kernel's template parameters and body, and the instantiations the
launch switches name (``CudaContext.instantiations``). What they cannot
evaluate — a dimension that depends on a branch the switch does not take,
a struct's size — is reported as unevaluated, never as a finding.
"""
from __future__ import annotations

import re
from typing import Dict, Iterator, List, Optional, Tuple

from repro_torch.analysis.context import (
    TYPE_BYTES,
    CExprError,
    CudaContext,
    CudaFunction,
    eval_c,
    split_top,
)
from repro_torch.analysis.registry import RawFinding, register_rule

WARP = 32
#: static __shared__ bytes a block may declare
STATIC_SHARED_LIMIT = 48 * 1024

_THREADS_NAME = re.compile(r"^k\w*Threads$")


def _is_cuda(ctx) -> bool:
    return isinstance(ctx, CudaContext)


def _eval(expr: str, env: Dict[str, object]) -> Optional[int]:
    try:
        v = eval_c(expr, env)
    except CExprError:
        return None
    return v if isinstance(v, int) else None


@register_rule(
    "PK401",
    title="CUDA block size off the warp, or off its kernel's __launch_bounds__",
    explain="""
    A block-size constant (a file-scope ``constexpr int k...Threads``, or
    the block argument of a ``kernel<<<grid, block, ...>>>`` launch that
    the analyzer can evaluate) that is not a multiple of the warp (32),
    or a launch whose block size differs from the first argument of the
    launched kernel's ``__launch_bounds__``. A partial warp idles lanes on
    every instruction; a block larger than the bound fails to launch; a
    smaller one wastes the registers the bound reserved. Sizes that depend
    on values known only at run time are skipped, not guessed.

    The reference's PK401 polices Pallas block shapes against the TPU's
    (8, 128) tiling; the port's kernels are CUDA, so the geometry is the
    warp's.
    """,
    scope=("src/repro_torch/csrc/",),
    languages=("cu",),
)
def pk401(ctx) -> Iterator[RawFinding]:
    if not _is_cuda(ctx):
        return
    for name, value in sorted(ctx.consts.items()):
        if _THREADS_NAME.match(name) and isinstance(value, int) and value % WARP:
            m = re.search(rf"\b{name}\s*=", ctx.code)
            yield ctx.line_of(m.start()) if m else 1, (
                f"block size {name} = {value} is not a multiple of the warp "
                f"({WARP}): its last warp runs with idle lanes")
    for fns in ctx.functions.values():
        for fn in fns:
            env = ctx.local_env(fn, {})  # template arguments unknown here
            for callee, _, is_launch, line, config in ctx.calls(fn):
                if not is_launch:
                    continue
                parts = split_top(config)
                if len(parts) < 2:
                    continue
                block = _eval(parts[1], env)
                if block is None:
                    continue
                if block % WARP:
                    yield line, (f"launch of {callee} with {block} threads a block, "
                                 f"not a multiple of the warp ({WARP})")
                for target in ctx.functions.get(callee, []):
                    if target.is_kernel and target.launch_bounds is not None:
                        bound = _eval(target.launch_bounds, ctx.consts)
                        if bound is not None and bound != block:
                            yield line, (
                                f"launch of {callee} with {block} threads a block, "
                                f"its __launch_bounds__ says {bound}")


def _decl_bytes(ctype: str, dims: List[str], align: int,
                env: Dict[str, object]) -> Tuple[Optional[int], int, str]:
    """(bytes, alignment, why not) of one static declaration."""
    ctype = str(env.get(ctype, ctype))
    if ctype not in TYPE_BYTES:
        return None, 1, f"type {ctype}"
    n = TYPE_BYTES[ctype]
    for d in dims:
        v = _eval(d, env)
        if v is None:
            return None, 1, f"dimension [{d}]"
        n *= v
    return n, max(align, TYPE_BYTES[ctype]), ""


def place(decls: List[Tuple[str, int, int]]) -> int:
    """Bytes of static shared declarations ``(name, bytes, alignment)``,
    each placed at its alignment in declaration order."""
    total = 0
    for _, n, al in decls:
        total = -(-total // al) * al + n
    return total


def static_shared(ctx: CudaContext) -> Dict[str, List[dict]]:
    """Kernel name -> one entry per instantiation: ``{"args": (int template
    arguments, in order), "binding", "line", "bytes", "decls"}`` — the
    static ``__shared__`` bytes (:func:`place`) and each declaration's
    ``(name, bytes, alignment)`` — or ``"unevaluated"`` with the reason
    instead, and ``"dynamic": True`` where the kernel also takes dynamic
    shared memory at launch."""
    out: Dict[str, List[dict]] = {}
    insts = ctx.instantiations()
    for fn in ctx.kernels():
        decls, dynamic = ctx.shared_decls(fn)
        for binding, line in insts.get(fn.name, []):
            if len(binding) != len(fn.params):
                continue
            env = ctx.local_env(fn, binding)
            sized, why = [], ""
            for d in decls:
                n, al, why = _decl_bytes(d.ctype, d.dims, d.align, env)
                if n is None:
                    break
                sized.append((d.name, n, al))
            entry = {"args": tuple(v for v in binding.values() if isinstance(v, int)),
                     "binding": dict(binding), "line": line, "dynamic": dynamic}
            if why:
                entry["unevaluated"] = why
            else:
                entry["bytes"], entry["decls"] = place(sized), sized
            out.setdefault(fn.name, []).append(entry)
    return out


def _kernel_line(fn: CudaFunction) -> int:
    return fn.line


@register_rule(
    "PK402",
    title="kernel's static __shared__ memory over 48 KB",
    explain="""
    The static ``__shared__`` declarations of a kernel, at an
    instantiation its launch switch names, add up to more than 48 KB (each
    declaration at its type's size and alignment, dimensions from the
    file's and the body's ``constexpr`` values and the template
    arguments). ``ptxas`` refuses such a kernel, on the card's build only:
    the CPU tests never compile it, so the first signal would be the
    card's smoke. Dynamic shared memory (``extern __shared__``, sized at
    the launch with a ``cudaFuncSetAttribute`` opt-in up to 227 KB) is a
    request at run time, not counted here. An instantiation whose size
    the analyzer cannot evaluate is reported as unevaluated, not as a
    finding; the card's build phase holds every evaluated size against
    ``cuobjdump --dump-resource-usage``.

    The reference's PK402 reckons a Pallas call's VMEM working set against
    the TPU core's 16 MiB; shared memory is the port's counterpart.
    """,
    scope=("src/repro_torch/csrc/",),
    languages=("cu",),
)
def pk402(ctx) -> Iterator[RawFinding]:
    if not _is_cuda(ctx):
        return
    for name, entries in sorted(static_shared(ctx).items()):
        for e in entries:
            if e.get("bytes", 0) > STATIC_SHARED_LIMIT:
                args = ", ".join(f"{k}={v}" for k, v in e["binding"].items())
                fn = ctx.functions[name][0]
                yield _kernel_line(fn), (
                    f"{name}<{args}> declares {e['bytes']} B of static shared "
                    f"memory, over the {STATIC_SHARED_LIMIT} B a block may "
                    f"declare (ptxas refuses it on the card's build)")
