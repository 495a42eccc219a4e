"""Analyzer self-test: every rule must catch its canonical violation.

For each registered rule there is a *bad* snippet (the exact idiom the
rule exists to flag, at a virtual path inside the rule's scope) and a
*clean* snippet (the repaired idiom at the same path). The self-test runs
the full pipeline — FileContext, ProjectIndex, pragma parsing — over the
virtual files and asserts: bad flags the rule, clean stays quiet, and a
pragma'd copy of the bad snippet is suppressed. The tests run it
so a refactor of the analyzer cannot silently lobotomize a rule: the gate
would go green for the wrong reason, which is the one failure mode a
static gate must not have. The ``.cu`` cases take ``//`` pragmas.
"""
from __future__ import annotations

import dataclasses
import textwrap
from typing import Dict, List, Tuple

from repro_torch.analysis.registry import available_rules
from repro_torch.analysis.runner import run_check


@dataclasses.dataclass(frozen=True)
class Case:
    rule: str
    path: str        # virtual repo-relative path (chooses the rule's scope)
    bad: str         # must yield >=1 finding of `rule`
    clean: str       # must yield none
    pragma_ok: bool = True  # also verify a pragma'd bad copy is suppressed


CASES: Tuple[Case, ...] = (
    Case(
        rule="RC101",
        path="src/repro_torch/serve/x.py",
        bad="""
            import torch
            from repro_torch import runtime

            @torch.compile
            def step(x):
                cfg = runtime.active()
                return x * cfg.knn_block
            """,
        clean="""
            import torch
            from repro_torch import runtime

            @torch.compile
            def step(x, _dispatch=()):
                cfg = runtime.active()
                return x * cfg.knn_block
            """,
    ),
    Case(
        rule="RC102",
        path="src/repro_torch/serve/x.py",
        bad="""
            import torch
            from repro_torch import runtime

            def pick_impl(x):
                return runtime.active().impl

            def decode(x):
                return pick_impl(x)

            def capture(g, x):
                with torch.cuda.graph(g):
                    y = decode(x)
                return y
            """,
        clean="""
            import torch
            from repro_torch import runtime

            def pick_impl(x):
                return runtime.active().impl

            def decode(x, _dispatch=()):
                return pick_impl(x)

            def capture(g, x):
                with torch.cuda.graph(g):
                    y = decode(x, runtime.dispatch_key())
                return y
            """,
    ),
    Case(
        rule="RC103",
        path="src/repro_torch/models/x.py",
        bad="""
            import os

            IMPL = os.getenv("REPRO_TORCH_IMPL", "auto")
            """,
        clean="""
            from repro_torch import runtime

            def impl():
                return runtime.active().impl
            """,
    ),
    Case(
        rule="HS201",
        path="src/repro_torch/core/x.py",
        bad="""
            def rounds(n_active):
                return n_active.item()
            """,
        clean="""
            def rounds(n_active):
                return n_active
            """,
    ),
    Case(
        rule="HS202",
        path="src/repro_torch/core/x.py",
        bad="""
            def mis_round(act):
                return bool(act.any())
            """,
        clean="""
            def mis_round(rounds_done, max_rounds):
                return bool(rounds_done >= max_rounds)
            """,
    ),
    Case(
        rule="RT301",
        path="src/repro_torch/models/x.py",
        bad="""
            from repro_torch import runtime

            def run(cfg):
                with runtime.configure(impl="ref"):
                    runtime.update_default(impl="auto")
            """,
        clean="""
            from repro_torch import runtime

            def run(cfg):
                runtime.update_default(impl="auto")
                with runtime.configure(impl="ref"):
                    pass
            """,
    ),
    Case(
        rule="RT302",
        path="src/repro_torch/models/x.py",
        bad="""
            import torch

            @torch.compile
            def step(x, seen=[]):
                return x
            """,
        clean="""
            import torch

            @torch.compile
            def step(x, seen=()):
                return x
            """,
    ),
    Case(
        rule="RT303",
        path="src/repro_torch/serve/x.py",
        bad="""
            import torch

            def decode_all(step, xs):
                for x in xs:
                    g = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(g):
                        step(x)
                    g.replay()
            """,
        clean="""
            import torch

            def decode_all(step, xs, x0):
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    step(x0)
                for x in xs:
                    x0.copy_(x)
                    g.replay()
            """,
    ),
    Case(
        rule="PK401",
        path="src/repro_torch/csrc/x.cu",
        bad="""
            constexpr int kThreads = 100;

            __global__ void __launch_bounds__(kThreads) add_kernel(float* y) {
              y[threadIdx.x] += 1.f;
            }

            void launch(float* y, cudaStream_t s) {
              add_kernel<<<1, kThreads, 0, s>>>(y);
            }
            """,
        clean="""
            constexpr int kThreads = 128;

            __global__ void __launch_bounds__(kThreads) add_kernel(float* y) {
              y[threadIdx.x] += 1.f;
            }

            void launch(float* y, cudaStream_t s) {
              add_kernel<<<1, kThreads, 0, s>>>(y);
            }
            """,
    ),
    Case(
        rule="PK402",
        path="src/repro_torch/csrc/x.cu",
        bad="""
            constexpr int kThreads = 256;

            template <int D>
            __global__ void __launch_bounds__(kThreads) stage_kernel(float* y) {
              __shared__ float tile[kThreads][D];
              tile[threadIdx.x][0] = y[threadIdx.x];
              y[threadIdx.x] = tile[threadIdx.x][0];
            }

            void launch(float* y, cudaStream_t s) {
              stage_kernel<49><<<1, kThreads, 0, s>>>(y);
            }
            """,
        clean="""
            constexpr int kThreads = 256;

            template <int D>
            __global__ void __launch_bounds__(kThreads) stage_kernel(float* y) {
              __shared__ float tile[kThreads][D];
              tile[threadIdx.x][0] = y[threadIdx.x];
              y[threadIdx.x] = tile[threadIdx.x][0];
            }

            void launch(float* y, cudaStream_t s) {
              stage_kernel<48><<<1, kThreads, 0, s>>>(y);
            }
            """,
    ),
    Case(
        rule="DT501",
        path="src/repro_torch/models/x.py",
        bad="""
            import torch

            def init(n):
                return torch.randn(n)
            """,
        clean="""
            import torch

            def init(n, seed):
                g = torch.Generator().manual_seed(seed)
                return torch.randn(n, generator=g)
            """,
    ),
    Case(
        rule="DT502",
        path="src/repro_torch/models/x.py",
        bad="""
            def emit(handlers):
                out = []
                for name in {"b", "a", "c"}:
                    out.append(handlers[name])
                return out
            """,
        clean="""
            def emit(handlers):
                out = []
                for name in sorted({"b", "a", "c"}):
                    out.append(handlers[name])
                return out
            """,
    ),
    Case(
        rule="DT503",
        path="src/repro_torch/train/x.py",
        bad="""
            import os

            def steps(d):
                return [f for f in os.listdir(d) if f.startswith("step_")]
            """,
        clean="""
            import os

            def steps(d):
                return [f for f in sorted(os.listdir(d))
                        if f.startswith("step_")]
            """,
    ),
    Case(
        rule="DT504",
        path="src/repro_torch/csrc/x.cu",
        bad="""
            __global__ void hist_kernel(const int* ids, float* mass, int n) {
              int r = blockIdx.x * blockDim.x + threadIdx.x;
              if (r < n) atomicAdd(&mass[ids[r]], 1.f);
            }
            """,
        clean="""
            __global__ void hist_kernel(const int* ids, int* cnt, int n) {
              int r = blockIdx.x * blockDim.x + threadIdx.x;
              if (r < n) atomicAdd(&cnt[ids[r]], 1);
            }
            """,
    ),
    Case(
        rule="DT504",
        path="src/repro_torch/core/x.py",
        bad="""
            def reduce(sums, ids, x):
                sums.index_add_(0, ids, x)
                return sums
            """,
        clean="""
            from repro_torch.kernels import ops

            def reduce(sums, ids, x):
                return ops.segment_sum(x, ids, sums.shape[0])[0]
            """,
    ),
    Case(
        rule="WN601",
        path="src/repro_torch/models/x.py",
        bad="""
            import warnings

            def prune(cache):
                warnings.warn("stale entry", RuntimeWarning)
            """,
        clean="""
            import warnings

            def prune(cache):
                warnings.warn("stale entry", RuntimeWarning, stacklevel=2)
            """,
    ),
)


def _pragma_variant(case: Case) -> str:
    """The bad snippet with a standalone pragma above every line the rule
    flags — built by running the rule and inserting comments."""
    src = textwrap.dedent(case.bad).strip("\n") + "\n"
    report = run_check({case.path: src}, only=[case.rule])
    lines = src.splitlines()
    flagged = sorted({f.line for f in report.new}, reverse=True)
    for line in flagged:
        indent = lines[line - 1][: len(lines[line - 1])
                                 - len(lines[line - 1].lstrip())]
        mark = "//" if case.path.endswith(".cu") else "#"
        lines.insert(
            line - 1,
            f"{indent}{mark} repro_torch: allow[{case.rule}]: self-test suppression")
    return "\n".join(lines) + "\n"


def run_selftest() -> Tuple[bool, List[str]]:
    """Run every case; returns (all passed, human-readable lines)."""
    lines: List[str] = []
    ok = True
    covered = {c.rule for c in CASES}
    missing = [r for r in available_rules() if r not in covered]
    if missing:
        ok = False
        lines.append(
            f"FAIL registry: rules without a self-test case: "
            f"{', '.join(missing)}")

    for case in CASES:
        bad_src = textwrap.dedent(case.bad).strip("\n") + "\n"
        clean_src = textwrap.dedent(case.clean).strip("\n") + "\n"
        failures: List[str] = []

        bad = run_check({case.path: bad_src}, only=[case.rule])
        if not any(f.rule == case.rule for f in bad.new):
            failures.append("bad snippet not flagged")

        clean = run_check({case.path: clean_src}, only=[case.rule])
        if clean.new:
            failures.append(
                "clean snippet flagged: "
                + "; ".join(f.format() for f in clean.new))

        if case.pragma_ok and not failures:
            sup = run_check({case.path: _pragma_variant(case)},
                            only=[case.rule])
            if sup.new:
                failures.append("pragma did not suppress the bad snippet")
            elif not sup.suppressed_pragma:
                failures.append("pragma variant produced no suppression")

        if failures:
            ok = False
            lines.append(f"FAIL {case.rule}: " + "; ".join(failures))
        else:
            lines.append(f"ok   {case.rule}")
    return ok, lines
