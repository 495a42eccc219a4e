"""The port's static analyzer (``repro_torch.analysis``): the counterparts of
``tests/test_analysis.py`` — rule registry contract, golden
violating/clean/pragma-suppressed snippets per family, whole-package
call-graph resolution, pragma grammar failures, baseline add/expire
semantics, CLI smoke, and the port-is-clean gate — plus the port's own
rules: the CUDA sources' geometry (warps, launch bounds, static shared
memory, float atomics), the reference's rules left clean over the port,
and the two analyzers' pragmas kept apart."""
import json
import subprocess
import sys
import textwrap

import pytest

from repro_torch.analysis import (
    Baseline,
    available_rules,
    load_baseline,
    run_check,
    run_selftest,
    save_baseline,
)
from repro_torch.analysis.baseline import extend_baseline, prune_baseline
from repro_torch.analysis.registry import register_rule
from repro_torch.analysis.selftest import CASES


def check_one(path, src, rule=None):
    only = [rule] if rule else None
    return run_check({path: textwrap.dedent(src).strip("\n") + "\n"},
                     only=only)


# ------------------------------------------------------------- registry


def test_every_family_has_rules_and_selftest_coverage():
    rules = available_rules()
    fams = {"".join(c for c in r if c.isalpha()) for r in rules}
    assert fams == {"RC", "HS", "RT", "PK", "DT", "WN"}
    assert {c.rule for c in CASES} == set(rules)


def test_register_rule_rejects_unknown_family_and_bad_signature():
    with pytest.raises(ValueError, match="unknown family"):
        register_rule("ZZ999", title="t", explain="e")(lambda ctx: [])
    with pytest.raises(ValueError, match="already registered"):
        register_rule("RC101", title="t", explain="e")(lambda ctx: [])
    with pytest.raises(TypeError, match="exactly one positional"):
        register_rule("RC199", title="t", explain="e")(lambda a, b: [])


# --------------------------------------- golden snippets, per rule family


@pytest.mark.parametrize("case", CASES, ids=[c.rule for c in CASES])
def test_golden_bad_flags_clean_passes(case):
    """Every rule's canonical violation flags; the repaired idiom does
    not. (The pragma'd variant is covered by run_selftest below — these
    are the committed golden fixtures.)"""
    bad = check_one(case.path, case.bad, rule=case.rule)
    assert any(f.rule == case.rule for f in bad.new), \
        f"{case.rule}: bad snippet produced {bad.new}"
    clean = check_one(case.path, case.clean, rule=case.rule)
    assert not clean.new, \
        f"{case.rule}: clean snippet flagged {clean.new}"


def test_selftest_passes():
    ok, lines = run_selftest()
    assert ok, "\n".join(lines)


def test_rc102_links_the_call_graph_across_files():
    """The capture hazard one file away: a compiled function calls a helper
    from another module that reads the config."""
    helper = '''
        from repro_torch import runtime

        def pick_impl(x):
            return runtime.active().impl
        '''
    user = '''
        import torch

        from repro_torch.models.helper import pick_impl

        @torch.compile
        def step(x):
            return pick_impl(x)
        '''
    sources = {
        "src/repro_torch/models/helper.py":
            textwrap.dedent(helper).strip("\n") + "\n",
        "src/repro_torch/models/user.py":
            textwrap.dedent(user).strip("\n") + "\n",
    }
    report = run_check(sources, only=["RC102"])
    assert [f.rule for f in report.new] == ["RC102"]
    assert report.new[0].path == "src/repro_torch/models/user.py"
    assert "pick_impl" in report.new[0].message


def test_scope_restricts_hot_path_rules():
    """np.asarray outside kernels/core/serve is nobody's business."""
    src = '''
        import numpy as np

        def f(x):
            return np.asarray(x)
        '''
    assert check_one("src/repro_torch/core/x.py", src, rule="HS201").new
    assert not check_one("src/repro_torch/train/x.py", src, rule="HS201").new
    assert not check_one("chip_smoke.py", src, rule="HS201").new
    # the reference's hot paths are the reference's analyzer's business
    assert not check_one("src/repro/core/x.py", src, rule="HS201").new


# --------------------------------------------------------------- pragmas


BAD_HS = '''
    import numpy as np

    def f(x):
        return np.asarray(x)
    '''


def test_pragma_same_line_and_preceding_line_both_suppress():
    trailing = '''
        import numpy as np

        def f(x):
            return np.asarray(x)  # repro_torch: allow[HS201]: test spill
        '''
    standalone = '''
        import numpy as np

        def f(x):
            # repro_torch: allow[HS201]: test spill
            return np.asarray(x)
        '''
    for src in (trailing, standalone):
        rep = check_one("src/repro_torch/core/x.py", src, rule="HS201")
        assert not rep.new and len(rep.suppressed_pragma) == 1
        _, supp = rep.suppressed_pragma[0]
        assert supp.reason == "test spill"


def test_pragma_without_reason_is_a_check_failure():
    src = '''
        import numpy as np

        def f(x):
            return np.asarray(x)  # repro_torch: allow[HS201]
        '''
    rep = check_one("src/repro_torch/core/x.py", src, rule="HS201")
    assert not rep.ok
    assert any("no reason" in e.message for e in rep.pragma_errors)


def test_pragma_with_unknown_rule_is_a_check_failure():
    src = '''
        def f(x):
            return x  # repro_torch: allow[XX123]: whatever
        '''
    rep = check_one("src/repro_torch/core/x.py", src)
    assert any("unknown rule" in e.message for e in rep.pragma_errors)


def test_pragma_for_wrong_rule_does_not_suppress():
    src = '''
        import numpy as np

        def f(x):
            return np.asarray(x)  # repro_torch: allow[DT501]: wrong family
        '''
    rep = check_one("src/repro_torch/core/x.py", src, rule="HS201")
    assert [f.rule for f in rep.new] == ["HS201"]


def test_unused_pragma_reported_but_not_fatal():
    src = '''
        def f(x):
            return x  # repro_torch: allow[HS201]: nothing here anymore
        '''
    rep = check_one("src/repro_torch/core/x.py", src)
    assert rep.ok
    assert len(rep.unused_pragmas) == 1


def test_pragma_inside_docstring_is_inert():
    src = '''
        import numpy as np

        def f(x):
            """Docs may show `# repro_torch: allow[HS201]: example` verbatim."""
            return np.asarray(x)
        '''
    rep = check_one("src/repro_torch/core/x.py", src, rule="HS201")
    # the docstring mention neither suppresses nor errors
    assert [f.rule for f in rep.new] == ["HS201"]
    assert not rep.pragma_errors and not rep.suppressed_pragma


# -------------------------------------------------------------- baseline


def _hs_finding():
    rep = check_one("src/repro_torch/core/x.py", BAD_HS, rule="HS201")
    assert rep.new
    return rep.new[0]


def test_baseline_matches_by_line_text_not_line_number(tmp_path):
    f = _hs_finding()
    bl = Baseline()
    extend_baseline(bl, [f], "accepted for the test")
    # same violation, pushed three lines down by an unrelated edit
    shifted = "\n\n\n" + textwrap.dedent(BAD_HS).strip("\n") + "\n"
    rep = run_check({"src/repro_torch/core/x.py": shifted},
                    baseline=bl, only=["HS201"])
    assert rep.ok
    assert len(rep.suppressed_baseline) == 1
    assert not rep.stale_baseline


def test_baseline_entry_expires_when_the_line_changes(tmp_path):
    f = _hs_finding()
    bl = Baseline()
    extend_baseline(bl, [f], "accepted for the test")
    fixed = '''
        def f(x):
            return x
        '''
    rep = check_one("src/repro_torch/core/x.py", fixed)
    rep = run_check(
        {"src/repro_torch/core/x.py":
         textwrap.dedent(fixed).strip("\n") + "\n"}, baseline=bl)
    assert rep.ok  # stale entries don't fail check...
    assert len(rep.stale_baseline) == 1  # ...but are reported
    assert prune_baseline(bl, rep.all_findings()) == 1
    assert len(bl) == 0


def test_baseline_requires_reason_and_roundtrips(tmp_path):
    bl = Baseline()
    with pytest.raises(ValueError, match="reason"):
        extend_baseline(bl, [_hs_finding()], "   ")
    extend_baseline(bl, [_hs_finding()], "why not")
    path = str(tmp_path / "bl.json")
    save_baseline(path, bl)
    loaded = load_baseline(path)
    assert len(loaded) == 1
    assert loaded.match(_hs_finding())
    # a hand-edited entry with the reason blanked refuses to load
    blob = json.load(open(path))
    blob["entries"][0]["reason"] = ""
    json.dump(blob, open(path, "w"))
    with pytest.raises(ValueError, match="no reason"):
        load_baseline(path)


def test_missing_baseline_file_is_empty():
    assert len(load_baseline("/nonexistent/baseline.json")) == 0


# ------------------------------------------------------------- CLI smoke


def _cli(args, cwd):
    import os
    import pathlib

    src = str(pathlib.Path(__file__).resolve().parent.parent / "src")
    env = dict(os.environ)
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis"] + args,
        capture_output=True, text=True, cwd=cwd, env=env)


@pytest.fixture
def mini_repo(tmp_path):
    pkg = tmp_path / "src" / "repro_torch" / "core"
    pkg.mkdir(parents=True)
    (pkg / "x.py").write_text(
        textwrap.dedent(BAD_HS).strip("\n") + "\n")
    return tmp_path


def test_cli_check_flags_then_baseline_then_clean(mini_repo):
    r = _cli(["check", "src", "--no-baseline"], str(mini_repo))
    assert r.returncode == 1
    assert "HS201" in r.stdout

    r = _cli(["baseline", "src", "--write",
              "--reason", "smoke-test debt"], str(mini_repo))
    assert r.returncode == 0, r.stderr
    assert (mini_repo / "analysis-baseline-torch.json").exists()
    assert not (mini_repo / "analysis-baseline.json").exists()

    r = _cli(["check", "src"], str(mini_repo))
    assert r.returncode == 0, r.stdout
    assert "0 new finding" in r.stdout


def test_cli_baseline_write_requires_reason(mini_repo):
    r = _cli(["baseline", "src", "--write"], str(mini_repo))
    assert r.returncode == 2
    assert "--reason" in r.stderr


def test_cli_check_json_output(mini_repo):
    r = _cli(["check", "src", "--no-baseline", "--json"], str(mini_repo))
    assert r.returncode == 1
    payload = json.loads(r.stdout)
    assert payload["ok"] is False
    assert payload["new"][0]["rule"] == "HS201"


def test_cli_explain(tmp_path):
    r = _cli(["explain"], str(tmp_path))
    assert r.returncode == 0
    for rid in available_rules():
        assert rid in r.stdout
    r = _cli(["explain", "RC101"], str(tmp_path))
    assert r.returncode == 0
    assert "dispatch" in r.stdout and "capture" in r.stdout
    assert _cli(["explain", "NOPE99"], str(tmp_path)).returncode == 2


@pytest.mark.parametrize("how", [["--self-test"], ["self-test"]])
def test_cli_self_test(tmp_path, how):
    r = _cli(how, str(tmp_path))
    assert r.returncode == 0, r.stdout
    assert "self-test: PASS" in r.stdout


# ----------------------------------------------------- the repo is clean


def test_port_passes_its_own_analyzer(repo_root):
    """The gate: no new findings and valid pragmas over the default scope
    (the port's Python and CUDA sources, chip_smoke.py, chip_ab.py)."""
    r = _cli(["check"], str(repo_root))
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    n_cu = len(list((repo_root / "src" / "repro_torch" / "csrc").glob("*.cu")))
    n_py = len(list((repo_root / "src" / "repro_torch").rglob("*.py")))
    assert f"{n_py + n_cu + 2} files" in r.stdout


def test_the_reference_analyzer_stays_clean_over_the_port(repo_root):
    """``python -m repro.analysis check src/repro_torch``: the port's files
    pass the reference's rules too (no REPRO_* read, stacklevels, seeds),
    and its ``# repro_torch:`` pragmas are not the reference's."""
    import os

    env = dict(os.environ)
    env["PYTHONPATH"] = str(repo_root / "src") + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-m", "repro.analysis", "check",
                        "src/repro_torch", "chip_smoke.py", "chip_ab.py"],
                       capture_output=True, text=True, cwd=str(repo_root), env=env)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.fixture
def repo_root(tmp_path_factory):
    import pathlib

    root = pathlib.Path(__file__).resolve().parent.parent
    assert (root / "src" / "repro_torch").is_dir()
    return root


# ------------------------------------------------------- the port's rules


def test_the_pragma_prefixes_stay_apart():
    """A reference pragma is no pragma of the port's, and the other way
    round: each analyzer reads its own prefix only."""
    from repro.analysis.pragmas import parse_pragmas as ref_parse
    from repro_torch.analysis.pragmas import parse_pragmas

    port = "x = 1  # repro_torch: allow[DT504]: a port-only rule\n"
    assert ref_parse("src/repro_torch/x.py", port) == ([], [])
    supp, errs = parse_pragmas("src/repro_torch/x.py", port)
    assert not errs and supp[0].rules == ("DT504",)
    ref = "x = 1  # repro: allow[HS201]: the reference's\n"
    assert parse_pragmas("src/repro_torch/x.py", ref) == ([], [])
    cu = "  y += 1;  // repro_torch: allow[PK401]: a .cu pragma\n"
    supp, errs = parse_pragmas("src/repro_torch/csrc/x.cu", cu)
    assert not errs and supp[0].line == 1


CU_ATOMICS = '''
    __global__ void k(const int* ids, int* __restrict__ cnt, float* mass,
                      double* tot, int* done, int n) {
      __shared__ int rare_n;
      __shared__ __half hsum;
      int r = threadIdx.x;
      atomicAdd(&cnt[ids[r]], 1);
      atomicAdd(&mass[ids[r]], 1.f);
      atomicAdd_block(tot, 2.0);
      bool last = atomicAdd(done, 1) == 7;
      atomicAdd(&rare_n, 1);
      atomicAdd(&hsum, __float2half(1.f));
    }
    '''


def test_float_atomics_flagged_integer_atomics_clean():
    rep = check_one("src/repro_torch/csrc/x.cu", CU_ATOMICS, rule="DT504")
    assert sorted(f.line for f in rep.new) == [7, 8, 11]


def test_the_segment_sum_atomics_are_integer():
    """segment_sum.cu's four atomics (counts, a done flag, slots, a rare
    list) are integer: clean."""
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "src/repro_torch/csrc/segment_sum.cu"
    src = path.read_text()
    assert src.count("atomicAdd(") >= 5  # four calls and a comment
    assert not run_check({"src/repro_torch/csrc/segment_sum.cu": src},
                         only=["DT504"]).new


def test_static_shared_over_48_kb_is_flagged():
    """PK402 at the instantiations the launch switch names: 49 KB of
    static shared memory flagged, 48 KB clean, and a template it cannot
    evaluate reported as unevaluated, not flagged."""
    from repro_torch.analysis.context import CudaContext
    from repro_torch.analysis.rules.pk import static_shared

    src = textwrap.dedent('''
        constexpr int kThreads = 256;
        template <int D>
        __global__ void __launch_bounds__(kThreads) stage(float* y) {
          __shared__ float tile[kThreads][D];
        }
        template <typename T>
        __global__ void __launch_bounds__(kThreads) opaque(float* y) {
          __shared__ T buf[kThreads];
        }
        void launch(float* y, int d, cudaStream_t s) {
          if (d > 48) stage<49><<<1, kThreads, 0, s>>>(y);
          else stage<48><<<1, kThreads, 0, s>>>(y);
          opaque<Widget><<<1, kThreads, 0, s>>>(y);
        }
        ''')
    rep = run_check({"src/repro_torch/csrc/x.cu": src}, only=["PK402"])
    assert len(rep.new) == 1 and "stage<D=49>" in rep.new[0].message
    sizes = static_shared(CudaContext("src/repro_torch/csrc/x.cu", src))
    assert sorted(e["bytes"] for e in sizes["stage"]) == [48 * 1024, 49 * 1024]
    assert sizes["opaque"][0]["unevaluated"] == "type Widget"


def test_launch_bounds_and_warps():
    src = '''
        constexpr int kThreads = 128;
        constexpr int kOddThreads = 100;
        __global__ void __launch_bounds__(kThreads) a(float* y) {}
        void launch(float* y, cudaStream_t s) {
          a<<<1, 256, 0, s>>>(y);
          a<<<1, kThreads, 0, s>>>(y);
        }
        '''
    rep = check_one("src/repro_torch/csrc/x.cu", src, rule="PK401")
    msgs = sorted(f.message for f in rep.new)
    assert len(msgs) == 2
    assert "kOddThreads = 100" in msgs[0]
    assert "256 threads" in msgs[1] and "says 128" in msgs[1]


def test_the_ports_kernels_are_evaluated():
    """Every kernel of csrc/ the launch switches name is found, and the
    shared sizes the card's build phase compares are evaluated for all
    but the struct-typed fold and the branch a switch never takes."""
    import pathlib

    from repro_torch.analysis.context import CudaContext
    from repro_torch.analysis.rules.pk import static_shared

    csrc = pathlib.Path(__file__).resolve().parent.parent / "src/repro_torch/csrc"
    kernels = {}
    for p in sorted(csrc.glob("*.cu")):
        for name, entries in static_shared(CudaContext(p.name, p.read_text())).items():
            kernels[name] = entries
    assert set(kernels) >= {"topk_kernel", "topk_tc_kernel", "topk_split_kernel",
                            "few_kernel", "fold_kernel", "tiled_kernel",
                            "small_m_kernel", "flash_mma_kernel", "split_kv_kernel"}
    tc = {e["args"]: e["bytes"] for e in kernels["topk_tc_kernel"]}
    assert tc[(4, 8)] == 256 * 12 * 8 and tc[(4, 32)] == 128 * 36 * 8
    assert all("unevaluated" in e for e in kernels["fold_kernel"])
    assert all(e["dynamic"] for e in kernels["flash_mma_kernel"])


def test_the_hot_path_syncs_are_answered():
    """Every host sync on the port's hot paths carries a reasoned pragma;
    the MIS flag names ROADMAP item 1."""
    import pathlib

    from repro_torch.analysis.runner import gather_sources

    root = pathlib.Path(__file__).resolve().parent.parent
    rep = run_check(gather_sources(["src/repro_torch"], root=str(root)),
                    only=["HS201", "HS202"])
    assert not rep.new and len(rep.suppressed_pragma) >= 30
    tc = [s for f, s in rep.suppressed_pragma if f.path.endswith("core/tc.py")]
    assert tc and "item 1" in tc[0].reason
