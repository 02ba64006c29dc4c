"""The port's contract checker: the live tree is clean, and each seeded
violation turns exactly its own pass red.

The checker (``src/repro_torch/analysis/``) is loaded the way
``scripts/check_port_contracts.py`` and ``chip_smoke.py`` load it — as a
package of its own, without ``repro_torch/__init__.py`` — so this file
needs no card, no ``nvcc`` and no torch (only the runtime-registry test
imports the port).

Seeded violations are made in a *clone*: the files the passes read,
copied into a tmp tree and mutated there.  Each case asserts the set of
passes that fire and the finding's message, so a pass can neither go
blind nor start flagging the wrong thing.  Every CUDA-side check (the
params-row read, the lane-kind bits, the build key, the sweep
fingerprint, a latency literal, a layout width) has a case that edits
only the C++.
"""
from __future__ import annotations

import importlib.util
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO_ROOT = Path(__file__).resolve().parents[1]
SCRIPT = REPO_ROOT / "scripts" / "check_port_contracts.py"


def _load_script():
    spec = importlib.util.spec_from_file_location("_check_port_contracts",
                                                  SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


analysis = _load_script().load_analysis()
framework = analysis.framework
csrc = analysis.csrc
Repo = framework.Repo

PKG = "src/repro_torch"
TLB_CSRC = f"{PKG}/kernels/tlb_sweep/csrc"
LANE_CUH = f"{TLB_CSRC}/tlb_lane.cuh"
SWEEP_CU = f"{TLB_CSRC}/tlb_sweep.cu"
LANE_PROGRAM = f"{PKG}/core/lane_program.py"


def _clone_files():
    files = [f"{PKG}/_device.py", f"{PKG}/tracing.py",
             f"{PKG}/kernels/_nvcc.py",
             "tests/_torch_helpers.py", "docs/methods.md", "chip_smoke.py",
             framework.SUPPRESSION_FILE]
    files += [f"{PKG}/core/{p.name}"
              for p in sorted((REPO_ROOT / PKG / "core").glob("*.py"))]
    for k in sorted((REPO_ROOT / PKG / "kernels").iterdir()):
        if not (k / "csrc").is_dir():
            continue
        rel = f"{PKG}/kernels/{k.name}"
        files += [f"{rel}/{n}" for n in ("ops.py", "ref.py", "_build.py")]
        files += [f"{rel}/csrc/{p.name}"
                  for p in sorted((k / "csrc").iterdir())]
    files += [f"tests/goldens/{p.name}"
              for p in sorted((REPO_ROOT / "tests" / "goldens")
                              .glob("*.json"))]
    return files


CLONE_FILES = _clone_files()


@pytest.fixture
def clone(tmp_path):
    """The live tree's analysable subset, copied so tests can mutate it."""
    for rel in CLONE_FILES:
        dst = tmp_path / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(REPO_ROOT / rel, dst)
    return tmp_path


def edit(root: Path, rel: str, old: str, new: str):
    p = root / rel
    text = p.read_text()
    assert text.count(old) == 1, f"mutation anchor {old!r} not unique in {rel}"
    p.write_text(text.replace(old, new))


def write(root: Path, rel: str, text: str):
    p = root / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(text)


def errors(findings):
    return [f for f in findings if f.severity == "error"]


def render(findings):
    return "\n".join(f.render() for f in findings)


# ---------------------------------------------------------------------------
# the live tree and the CLI
# ---------------------------------------------------------------------------

def test_live_tree_is_clean():
    active, suppressed = analysis.run_passes(Repo(str(REPO_ROOT)),
                                             analysis.ALL_PASSES)
    assert active == [] and suppressed == [], render(active)


def test_clone_fixture_is_clean(clone):
    active, _ = analysis.run_passes(Repo(str(clone)), analysis.ALL_PASSES)
    assert active == [], render(active)


def test_cli_exits_zero_and_writes_step_summary(tmp_path):
    summary = tmp_path / "summary.md"
    env = dict(os.environ, GITHUB_STEP_SUMMARY=str(summary))
    r = subprocess.run([sys.executable, str(SCRIPT)], capture_output=True,
                       text=True, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "4 pass(es): 0 error(s), 0 warning(s), 0 suppressed" in r.stdout
    assert "## Port contract checker" in summary.read_text()
    r = subprocess.run([sys.executable, str(SCRIPT), "--list"],
                       capture_output=True, text=True)
    assert [line.split(":")[0] for line in r.stdout.splitlines()] == \
        ["kind-dispatch", "plane-layout", "latency-constants", "cache-key"]


BLOCKED = ("torch", "jax", "repro", "repro_torch", "numpy")


def test_cli_runs_without_torch(tmp_path):
    """The script on a Python where ``import torch`` (and jax, numpy, the
    JAX package and the port's package) fails: it still runs clean and
    loads none of them."""
    code = f"""
import runpy, sys
for m in {BLOCKED!r}:
    sys.modules[m] = None
sys.argv = [{str(SCRIPT)!r}]
rc = 0
try:
    runpy.run_path({str(SCRIPT)!r}, run_name="__main__")
except SystemExit as e:
    rc = e.code
loaded = sorted(m for m, v in sys.modules.items()
                if v is not None and m.split(".")[0] in {BLOCKED!r})
print("LOADED", loaded)
sys.exit(rc)
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "LOADED []" in r.stdout
    assert "4 pass(es): 0 error(s)" in r.stdout


def test_registered_kinds_match_runtime_registry():
    simulator = pytest.importorskip("repro_torch.core.simulator")
    assert tuple(analysis.registered_kinds(Repo(str(REPO_ROOT)))) == \
        simulator.KINDS


def test_fingerprint_reachability_follows_every_relative_import():
    """Module-level, function-level and multi-level relative imports are
    all followed (sweep.py reaches _build.py inside run_sweep, and
    _build.py reaches _nvcc.py two levels up)."""
    reached = analysis.pass_cache_key.reached_modules(Repo(str(REPO_ROOT)))
    assert {"core/page_table.py", "core/plane_layout.py", "_device.py",
            "kernels/tlb_sweep/_build.py", "kernels/_nvcc.py"} <= reached
    assert "core/baselines.py" not in reached


def test_cuda_text_reader():
    text = ('#define A 3  // 150\n'
            '#define LONG(X) \\\n  X(1) X(A | 4)\n'
            '/* 200\n   250 */ const char* s = "150";\n'
            "int b = 1'000 + 0x10 + 2.5 + 150u;\n"
            'int f(int x) { if (x) { return x; } return 0; }\n'
            'int g() { return f(1); }\n')
    code = csrc.strip(text)
    assert len(code) == len(text) and code.count("\n") == text.count("\n")
    assert "150\"" not in code and "200" not in code
    defs = csrc.defines(code)
    assert defs["A"].body == "3" and defs["LONG"].params == "X"
    assert (defs["LONG"].line, defs["LONG"].end_line) == (2, 3)
    assert csrc.int_value("(A << 2) | 1u", defs) == 13
    assert csrc.int_value("A + B", defs) is None
    assert [v for v, line in csrc.int_literals(code) if line == 6] == \
        [1000, 16, 150]
    assert csrc.function_body(code, "f")[0] == \
        "{ if (x) { return x; } return 0; }"
    assert csrc.function_body(code, "h") is None
    assert csrc.includes('// #include "a.h"\n#include "b.cuh"\n'
                         '#include <c.h>\n') == [("b.cuh", 2)]


def test_cuda_latency_literal_skips_comments_and_strings(tmp_path):
    write(tmp_path, f"{PKG}/core/simulator.py", "LAT_CTX_SWITCH = 150\n")
    write(tmp_path, SWEEP_CU, '// 150,000 accesses\n'
                              'const char* s = "150";\n'
                              'int a = 150;\n')
    found = analysis.pass_latency.run(Repo(str(tmp_path)))
    assert [(f.file, f.line, f.message) for f in found] == \
        [(SWEEP_CU, 3, "magic number 150 duplicates LAT_CTX_SWITCH")]


def test_chip_smoke_phase0_fails_on_a_violation(clone, capsys):
    """``chip_smoke.py``'s phase 0 runs the checker over its own checkout
    and exits non-zero on an error finding."""
    write(clone, "scripts/check_port_contracts.py", SCRIPT.read_text())
    spec = importlib.util.spec_from_file_location("_chip_smoke_clone",
                                                  clone / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke.contracts_phase()
    assert "4 pass(es): 0 error(s)" in capsys.readouterr().out
    edit(clone, LANE_CUH, "#define L2_W 7", "#define L2_W 8")
    with pytest.raises(SystemExit) as e:
        smoke.contracts_phase()
    assert e.value.code == 1
    out = capsys.readouterr()
    assert "[plane-layout] error: #define L2_W is 8" in out.out
    assert "the contract checker exited 1" in out.err


# ---------------------------------------------------------------------------
# seeded violations: each fires exactly its own pass
# ---------------------------------------------------------------------------

EXTRA_CUH = "#pragma once\n"

# (id, rule, edits, expected message substrings); an edit is (file, old,
# new), or (file, None, text) to write a new file
SEEDS = [
    # -- kind-dispatch, the C++ alone
    ("cuda-flag-read", "kind-dispatch",
     [(LANE_CUH, "q.has_ctlb = TLB_LDG(p + F_HAS_CTLB) == 1;",
       "q.has_ctlb = 0;")],
     ["never reads the params row at F_HAS_CTLB",
      "load_params does not load LaneParams.has_ctlb from F_HAS_CTLB"]),
    ("cuda-feature-bit", "kind-dispatch",
     [(LANE_CUH, "(k.dead ? FT_DEAD : 0)", "0")],
     ["lane_feat never sets FT_DEAD"]),
    ("cuda-kind-of", "kind-dispatch",
     [(LANE_CUH, "k.subr = q.is_subr;\n  k.generic", "k.generic")],
     ["kind 'subregion': kind_of never reads LaneParams.is_subr"]),
    ("cuda-policy-use", "kind-dispatch",
     [(LANE_CUH, "wadd(q.coh_hw ? 0 : LAT_SHOOTDOWN,",
       "wadd(LAT_SHOOTDOWN,")],
     ["policy coh_policy: the kernel never uses LaneParams.coh_hw"]),
    ("cuda-ft-all", "kind-dispatch",
     [(LANE_CUH, "#define FT_ALL 511", "#define FT_ALL 255")],
     ["FT_ALL is not the OR of the FT_* bits (511)"]),
    ("cuda-feat-case", "kind-dispatch",
     [(LANE_CUH, "X(FT_CHAIN | FT_PRED)", "X(FT_CHAIN | FT_PREDICT)")],
     ["TLB_FEAT_CASES entry 'FT_CHAIN | FT_PREDICT' is not built"]),
    ("cuda-param-index", "kind-dispatch",
     [(LANE_CUH, "#define F_COH_HW 16", "#define F_COH_HW 15")],
     ["#define F_COH_HW is 15 but 'coh_hw' is PARAM_KEYS[16]"]),
    # -- kind-dispatch, the Python
    ("lane-dispatch", "kind-dispatch",
     [(LANE_PROGRAM, 'lanes["has_ctlb"][i] = s.kind == "cache-tlb"',
       'lanes["has_ctlb"][i] = s.kind == "cache-tlb-off"')],
     ["kind 'cache-tlb': selector literal 'cache-tlb' missing from "
      "pack_lanes()"]),
    ("cpu-roster", "kind-dispatch",
     [("tests/_torch_helpers.py", "b.cache_tlb_spec(), ", "")],
     ["kind 'cache-tlb': no factory of ['cache_tlb_spec'] is called in "
      "all_kinds()"]),
    ("card-roster", "kind-dispatch",
     [("chip_smoke.py", "b.cache_tlb_spec(), b.dead_protect_spec()]\n\n\n"
       "def _small_dynamic", "b.cache_tlb_spec()]\n\n\ndef _small_dynamic")],
     ["kind 'dead-protect': no factory of ['dead_protect_spec'] is called "
      "in _eleven_specs()"]),
    # -- plane-layout
    ("cuda-width", "plane-layout",
     [(LANE_CUH, "#define L2_W 7", "#define L2_W 8")],
     ["#define L2_W is 8 but the width of l2 is 7"]),
    ("cuda-seg-index", "plane-layout",
     [(LANE_CUH, "#define S_FALL 7", "#define S_FALL 6")],
     ["#define S_FALL is 6 but the index of 'seg_fall' in SEG_KEYS is 7"]),
    ("python-width", "plane-layout",
     [(LANE_PROGRAM, 'l1=packed((L, L1_SETS, L1_WAYS, PLANE_WIDTH["l1"]), '
       '-1),', "l1=packed((L, L1_SETS, L1_WAYS, 4), -1),")],
     ["hardcoded plane/record width 4 in packed() shape"]),
    # -- latency-constants
    ("cuda-latency-literal", "latency-constants",
     [(SWEEP_CU, '#include "tlb_lane.cuh"\n',
       '#include "tlb_lane.cuh"\nstatic const int kRetuned = 200;\n')],
     ["magic number 200 duplicates LAT_SHOOTDOWN"]),
    ("cuda-latency-define", "latency-constants",
     [(LANE_CUH, "#define LAT_WALK 50", "#define LAT_WALK 51")],
     ["#define LAT_WALK is 51 but simulator.py has 50"]),
    ("python-latency-literal", "latency-constants",
     [(LANE_PROGRAM, 'lanes["miss_chain"][i] = miss_chain_cycles(s)',
       'lanes["miss_chain"][i] = miss_chain_cycles(s) + 50 * 0')],
     ["magic number 50 duplicates LAT_WALK"]),
    # -- cache-key
    ("cuda-build-key-and-fingerprint", "cache-key",
     [(SWEEP_CU, '#include "tlb_lane.cuh"\n',
       '#include "tlb_lane.cuh"\n#include "extra.cuh"\n'),
      (f"{TLB_CSRC}/extra.cuh", None, EXTRA_CUH)],
     ["tlb_sweep: csrc/extra.cuh is not in _build.SOURCES",
      'tlb_sweep: #include "extra.cuh" is not in _build.SOURCES',
      "_FINGERPRINT_SOURCES does not name "
      "kernels/tlb_sweep/csrc/extra.cuh"]),
    ("cuda-build-key", "cache-key",
     [(f"{PKG}/kernels/paged_attention/csrc/notes.cuh", None, EXTRA_CUH)],
     ["paged_attention: csrc/notes.cuh is not in _build.SOURCES"]),
    ("python-fingerprint", "cache-key",
     [(f"{PKG}/core/sweep.py", '    "core/page_table.py",\n', "")],
     ["_FINGERPRINT_SOURCES does not name core/page_table.py"]),
    ("run-sweep-knob", "cache-key",
     [(f"{PKG}/core/sweep.py", 'device="cuda") -> SweepResult:',
       'device="cuda", magic: int = 0) -> SweepResult:')],
     ["run_sweep parameter 'magic' is neither folded into cell_key nor "
      "allowlisted"]),
]


@pytest.mark.parametrize("rule,edits,expect", [s[1:] for s in SEEDS],
                         ids=[s[0] for s in SEEDS])
def test_seeded_violation_fires_exactly_its_pass(clone, rule, edits,
                                                 expect):
    for rel, old, new in edits:
        if old is None:
            write(clone, rel, new)
        else:
            edit(clone, rel, old, new)
    active, _ = analysis.run_passes(Repo(str(clone)), analysis.ALL_PASSES)
    found = errors(active)
    assert {f.rule for f in found} == {rule}, render(active)
    for want in expect:
        assert any(want in f.message for f in found), (want, render(found))


def test_every_pass_and_cuda_check_has_a_seed():
    rules = {s[1] for s in SEEDS}
    assert rules == set(analysis.PASS_BY_RULE)
    cuda_only = {s[0] for s in SEEDS
                 if all(rel.endswith((".cu", ".cuh")) for rel, _, _ in s[2])}
    assert {"cuda-flag-read", "cuda-feature-bit", "cuda-width",
            "cuda-latency-literal", "cuda-build-key-and-fingerprint",
            "cuda-build-key"} <= cuda_only


# ---------------------------------------------------------------------------
# suppressions
# ---------------------------------------------------------------------------

LATENCY_FIXTURE = """\
LAT_WALK = 50
LAT_HIT = 1


def miss_chain_cycles():
    return 50 + 1
"""


def test_suppression_silences_matching_finding(tmp_path):
    write(tmp_path, f"{PKG}/core/simulator.py", LATENCY_FIXTURE)
    write(tmp_path, framework.SUPPRESSION_FILE,
          "latency-constants | src/repro_torch/core/*.py | magic number 50 "
          "| seeded for the suppression test\n")
    active, suppressed = analysis.run_passes(Repo(str(tmp_path)),
                                             [analysis.pass_latency])
    assert active == []
    assert [f.line for f in suppressed] == [6]


def test_unused_suppression_warns(tmp_path):
    write(tmp_path, f"{PKG}/core/simulator.py", "LAT_WALK = 50\n")
    write(tmp_path, framework.SUPPRESSION_FILE,
          "latency-constants | nowhere/*.py | magic number 99 | stale\n")
    active, _ = analysis.run_passes(Repo(str(tmp_path)),
                                    [analysis.pass_latency])
    assert [(f.rule, f.severity) for f in active] == \
        [("suppressions", "warning")]
    assert "matches no finding" in active[0].message


def test_malformed_suppression_is_an_error(tmp_path):
    write(tmp_path, f"{PKG}/core/simulator.py", "LAT_WALK = 50\n")
    write(tmp_path, framework.SUPPRESSION_FILE, "only | three | fields\n")
    active, _ = analysis.run_passes(Repo(str(tmp_path)),
                                    [analysis.pass_latency])
    assert [(f.rule, f.severity) for f in active] == \
        [("suppressions", "error")]
    assert "malformed" in active[0].message
