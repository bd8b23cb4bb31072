"""The port's static analyzer (``torcheval_tpu_torch/analysis``) held
against the JAX package's (``torcheval_tpu/analysis``) on the CPU.

- Every fixture the JAX analyzer's own tests lint (``tests/analysis/``)
  goes through the JAX analyzer as written and, translated to the port's
  spellings (``torcheval_tpu`` -> ``torcheval_tpu_torch``, ``jnp`` ->
  ``torch``, ``astype`` -> ``.to``, ``axis=`` -> ``dim=``, a ``jax.jit``
  entry -> a function called from a ``with torch.cuda.graph(g):`` body, a
  ``lax.scan`` body -> the same), through the port's: both must give the
  same (code, line, scope) list, and TPU006-009 the same messages.  TPU004
  is out of scope in the port and is dropped from the JAX side.  The JAX
  tests that lint a real JAX file have their counterparts here as
  mutation tests on the port's own files.
- Torch-only fixtures cover each spelling the port adds.
- The CLI, suppressions, baselines, fingerprints, ``--json`` and
  ``--sarif`` round-trip as the JAX package's do.
- The repo-clean gate: ``main([])`` exits 0 over the port.
"""

import ast
import importlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import unittest
from unittest import mock

import pytest
import torch

from torcheval_tpu.analysis import _core as jax_core
from torcheval_tpu_torch.analysis import hook_entry_points, hook_site_map, main
from torcheval_tpu_torch.analysis._baseline import (
    load_baseline,
    split_by_baseline,
    write_baseline,
)
from torcheval_tpu_torch.analysis._config import BASELINE_PATH
from torcheval_tpu_torch.analysis._core import analyze_files

pytestmark = pytest.mark.analysis

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TESTS = os.path.join(ROOT, "tests", "analysis")
_JAX_MODULES = ("test_rules", "test_concurrency_rules", "test_dataflow_rules", "test_cli")
_CONCURRENCY = ("TPU006", "TPU007", "TPU008", "TPU009")


def _lint_with(analyze, files, rule_codes=None):
    """``files``: {display path: source}; the findings of ``analyze``."""
    with tempfile.TemporaryDirectory() as td:
        entries = []
        for i, (display, src) in enumerate(files.items()):
            path = os.path.join(td, f"f{i}.py")
            with open(path, "w", encoding="utf-8") as f:
                f.write(src)
            entries.append((path, display))
        return analyze(entries, rule_codes=rule_codes).all_findings


def port_lint(files, rule_codes=None):
    return _lint_with(analyze_files, files, rule_codes)


def jax_lint(files, rule_codes=None):
    return _lint_with(jax_core.analyze_files, files, rule_codes)


def new_vs_port_baseline(findings):
    new, _, _ = split_by_baseline(findings, load_baseline(BASELINE_PATH))
    return new


# ----------------------------------------------------------- translation
def translate_path(path):
    return re.sub(r"\btorcheval_tpu\b(?!_torch)", "torcheval_tpu_torch", path)


_DTYPE_STRING = {"float32": "torch.float32", "float64": "torch.float64",
                 "int32": "torch.int32", "int64": "torch.int64"}
_JIT = {"jax.jit", "jit"}


def _jit_entries(tree):
    """(decorator line numbers, def name, params, static params) of every
    jit-decorated def."""
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.FunctionDef):
            continue
        for dec in node.decorator_list:
            static = set()
            if isinstance(dec, ast.Call):
                inner = dec.func
                if ast.unparse(inner) in ("partial", "functools.partial") and dec.args:
                    inner = dec.args[0]
                if ast.unparse(inner) not in _JIT:
                    continue
                for kw in dec.keywords:
                    if kw.arg in ("static_argnames", "static_argnums"):
                        for c in ast.walk(kw.value):
                            if isinstance(c, ast.Constant) and isinstance(c.value, str):
                                static.add(c.value)
                            elif isinstance(c, ast.Constant) and isinstance(c.value, int):
                                static.add(node.args.args[c.value].arg)
            elif ast.unparse(dec) not in _JIT:
                continue
            params = [a.arg for a in node.args.args]
            out.append((range(dec.lineno, dec.end_lineno + 1), node.name, params, static))
    return out


def translate_source(src):
    """The port's spelling of a JAX fixture, line for line: every line of
    the original keeps its number, and a jitted def's capture is appended
    after the last line."""
    try:
        tree = ast.parse(src)
    except SyntaxError:
        return translate_path(src)
    lines = src.split("\n")
    captures = []
    for dec_lines, name, params, static in _jit_entries(tree):
        for ln in dec_lines:
            indent = lines[ln - 1][: len(lines[ln - 1]) - len(lines[ln - 1].lstrip())]
            lines[ln - 1] = f"{indent}# captured below"
        traced = [p for p in params if p not in static and p not in ("self", "cls")]
        binds = ", ".join([f"{p}={p}" for p in traced] + [f"{p}=None" for p in sorted(static)])
        captures += [
            f"def _capture_{name}(g, {', '.join(traced)}):",
            "    with torch.cuda.graph(g):",
            f"        {name}({binds})",
        ]
    out = []
    for line in lines:
        line = translate_path(line)
        line = re.sub(r"TORCHEVAL_TPU_(?!TORCH_)", "TORCHEVAL_TPU_TORCH_", line)
        line = re.sub(r"^(\s*)import jax\.numpy as jnp$", r"\1import torch", line)
        line = re.sub(r"^(\s*)(import jax|from jax import lax)$", r"\1import torch", line)
        m = re.match(r"^(\s*)(.*)\blax\.scan\((\w+), (.*)\)(.*)$", line)
        if m:
            line = f"{m.group(1)}with torch.cuda.graph(g): {m.group(2)}{m.group(3)}({m.group(4)}){m.group(5)}"
        line = re.sub(r"\bjax\.jit\(", "torch.cuda.make_graphed_callables(", line)
        line = re.sub(r"\bjnp\.float64\(([^()]*)\)", r"torch.as_tensor(\1, dtype=torch.float64)", line)
        line = re.sub(r"\bjnp\.float32\(([^()]*)\)", r"torch.tensor(\1)", line)
        line = re.sub(r"\bjnp\.asarray\(", "torch.as_tensor(", line)
        line = re.sub(r"\bjnp\.", "torch.", line)
        line = re.sub(r"(\w+)\.at\[([^\]]*)\]\.add\(", r"\1.index_add(0, \2, ", line)
        line = re.sub(r"\.astype\(", ".to(", line)
        line = re.sub(r"\.to\((['\"])(\w+)\1\)", lambda m: f".to({_DTYPE_STRING[m.group(2)]})", line)
        line = re.sub(r"\baxis=", "dim=", line)
        out.append(line)
    if captures:
        out = out + ([] if out and out[-1] == "" else [""]) + captures + [""]
    return "\n".join(out)


def _comparable(findings, drop=()):
    return [(f.code, f.line, f.scope) for f in findings if f.code not in drop]


# -------------------------------------------------- the JAX fixtures' cases
_LINT_HELPERS = {"run_lint", "_lint", "_codes", "analyze_files"}


def _jax_cases():
    """``module::Class::method`` for every JAX analyzer test that lints
    an inline fixture (tests that lint a real JAX file, the whole tree or
    only drive the CLI are not fixtures)."""
    cases = []
    for name in _JAX_MODULES:
        path = os.path.join(JAX_TESTS, f"{name}.py")
        with open(path, encoding="utf-8") as f:
            text = f.read()
        tree = ast.parse(text)
        for cls in tree.body:
            if not isinstance(cls, ast.ClassDef):
                continue
            for fn in cls.body:
                if not (isinstance(fn, ast.FunctionDef) and fn.name.startswith("test_")):
                    continue
                body = ast.get_source_segment(text, fn)
                calls = {
                    ast.unparse(n.func).split(".")[-1]
                    for n in ast.walk(fn)
                    if isinstance(n, ast.Call)
                }
                if not calls & _LINT_HELPERS:
                    continue
                if "_REPO_ROOT" in body or "_lint_real" in body:
                    continue
                cases.append(f"{name}::{cls.name}::{fn.name}")
    return cases


JAX_CASES = _jax_cases()


def _harvest(case):
    """Run one JAX analyzer test with a recorder on its module's
    ``analyze_files``; returns ([(files, rule_codes)], TestResult)."""
    module_name, cls_name, method = case.split("::")
    module = importlib.import_module(f"tests.analysis.{module_name}")
    recorded = []
    real = module.analyze_files

    def recorder(files, *args, **kwargs):
        snapshot = {}
        for entry in files:
            open_path, display = entry if isinstance(entry, tuple) else (entry, entry)
            with open(open_path, encoding="utf-8") as f:
                snapshot[display] = f.read()
        recorded.append((snapshot, kwargs.get("rule_codes")))
        return real(files, *args, **kwargs)

    result = unittest.TestResult()
    with mock.patch.object(module, "analyze_files", recorder):
        getattr(module, cls_name)(method).run(result)
    return recorded, result


def test_the_jax_fixture_harvest_is_whole():
    # Every JAX test module contributes; a shrinking harvest fails here.
    assert len(JAX_CASES) >= 60
    assert {c.split("::")[0] for c in JAX_CASES} == set(_JAX_MODULES)


@pytest.mark.parametrize("case", JAX_CASES)
def test_jax_fixture_gives_the_same_findings_in_the_port(case):
    recorded, result = _harvest(case)
    assert result.wasSuccessful(), (result.failures, result.errors)
    assert recorded, f"{case} linted no fixture"
    for files, rule_codes in recorded:
        want = jax_lint(files, rule_codes)
        port_codes = None if rule_codes is None else set(rule_codes) - {"TPU004"}
        translated = {translate_path(p): translate_source(s) for p, s in files.items()}
        got = port_lint(translated, port_codes)
        # TPU004 (donation-safety) is out of scope in the port.
        assert _comparable(got) == _comparable(want, drop=("TPU004",)), (
            case, translated, [f.render() for f in got], [f.render() for f in want])
        for g, w in zip(got, [f for f in want if f.code != "TPU004"]):
            if g.code in _CONCURRENCY:
                assert g.message == translate_path(w.message)


def test_translation_keeps_every_line_number():
    src = (
        "import jax\n"
        "import jax.numpy as jnp\n"
        "@jax.jit\n"
        "def f(x, mask):\n"
        "    y = x.astype(jnp.float32) * jnp.float32(0.9)\n"
        "    return jnp.sum(jnp.where(mask > 0, y, 0), axis=1)\n"
    )
    out = translate_source(src).split("\n")
    assert out[:6] == [
        "import torch",
        "import torch",
        "# captured below",
        "def f(x, mask):",
        "    y = x.to(torch.float32) * torch.tensor(0.9)",
        "    return torch.sum(torch.where(mask > 0, y, 0), dim=1)",
    ]
    assert "with torch.cuda.graph(g):" in out[-3] and out[-2] == "        f(x=x, mask=mask)"


# ------------------------------------------------- torch-only fixtures
_PORT_MOD = "torcheval_tpu_torch/somemod.py"


def _codes(src, display=_PORT_MOD):
    return [f.code for f in port_lint({display: src})]


class TestTorchSpellings:
    def test_item_reached_from_a_capture_body(self):
        src = (
            "import torch\n"
            "def helper(x):\n"
            "    return x.item()\n"
            "def step(x):\n"
            "    return helper(x)\n"
            "def capture(g, x):\n"
            "    with torch.cuda.graph(g):\n"
            "        step(x)\n"
        )
        (f,) = port_lint({_PORT_MOD: src})
        assert (f.code, f.line, f.scope, f.symbol) == ("TPU003", 3, "helper", "item")

    @pytest.mark.parametrize("call", ["x.cpu()", "x.numpy()", "x.tolist()", "float(x)",
                                      "torch.cuda.synchronize()", "np.asarray(x)"])
    def test_host_reads_in_a_capture_body(self, call):
        src = (
            "import numpy as np\n"
            "import torch\n"
            "def capture(g, x):\n"
            "    with torch.cuda.graph(g):\n"
            f"        y = {call}\n"
        )
        assert _codes(src) == ["TPU003"]

    def test_capture_begin_end_region(self):
        src = (
            "def capture(g, x):\n"
            "    g.capture_begin()\n"
            "    y = x.item()\n"
            "    g.capture_end()\n"
            "    return x.item()\n"
        )
        findings = port_lint({_PORT_MOD: src})
        assert [(f.code, f.line) for f in findings] == [("TPU003", 3)]

    def test_make_graphed_callables_entry_branches_on_a_tensor(self):
        src = (
            "import torch\n"
            "def f(x):\n"
            "    if x > 0:\n"
            "        return x\n"
            "    return -x\n"
            "g = torch.cuda.make_graphed_callables(f, (torch.zeros(1),))\n"
        )
        (f,) = port_lint({_PORT_MOD: src})
        assert (f.code, f.symbol) == ("TPU003", "branch:x")

    def test_host_values_at_the_capture_call_are_not_tensors(self):
        # Constants, attributes and shape metadata are fixed at capture:
        # branching on them is configuration, not a tensor read.
        src = (
            "import torch\n"
            "def step(x, n, health, mode):\n"
            "    if health:\n"
            "        x = x + 1\n"
            "    if mode == 2:\n"
            "        return x\n"
            "    for _ in range(n):\n"
            "        x = x * 2\n"
            "    return x\n"
            "class R:\n"
            "    def capture(self, g, x):\n"
            "        with torch.cuda.graph(g):\n"
            "            step(x, x.shape[0], self._health, 2)\n"
        )
        assert _codes(src) == []

    def test_wall_clock_in_a_capture_body(self):
        src = (
            "import time\n"
            "import torch\n"
            "def capture(g, x):\n"
            "    with torch.cuda.graph(g):\n"
            "        y = x + time.time()\n"
        )
        assert _codes(src) == ["TPU005"]

    def test_index_add_without_the_mask(self):
        src = (
            "def kernel(hist, idx, x, mask):\n"
            "    return hist.index_add_(0, idx, x)\n"
        )
        assert _codes(src) == ["TPU010"]

    @pytest.mark.parametrize("source", ["x * mask", "torch.where(mask > 0, x, 0)",
                                        "x * mask.to(x.dtype)"])
    def test_masked_scatters_are_clean(self, source):
        src = (
            "import torch\n"
            "from torcheval_tpu_torch.metrics.functional._scatter import at_add\n"
            "def kernel(hist, idx, x, mask):\n"
            f"    a = hist.index_add_(0, idx, {source})\n"
            f"    b = hist.scatter_add_(0, idx, {source})\n"
            f"    c = at_add(8, idx, {source})\n"
            f"    d = torch.bincount(idx, weights={source})\n"
            "    return a, b, c, d\n"
        )
        assert _codes(src) == []

    def test_raw_scatters_fire(self):
        src = (
            "import torch\n"
            "from torcheval_tpu_torch.metrics.functional._scatter import at_add\n"
            "def kernel(hist, idx, x, mask):\n"
            "    b = hist.scatter_add_(0, idx, x)\n"
            "    c = at_add(8, idx, x)\n"
            "    d = torch.bincount(idx)\n"
            "    return b, c, d\n"
        )
        assert _codes(src) == ["TPU010"] * 3

    def test_method_and_function_reductions_with_dim(self):
        src = (
            "import torch\n"
            "def kernel(x, mask):\n"
            "    rows = x.sum(dim=-1) + torch.sum(x, 1) + x.amax(1)\n"
            "    return x.mean()\n"
        )
        findings = port_lint({_PORT_MOD: src})
        assert [(f.code, f.line) for f in findings] == [("TPU010", 4)]

    def test_float64_spellings_in_a_masked_kernel(self):
        src = (
            "import torch\n"
            "def kernel(x, mask):\n"
            "    a = (x * mask).double()\n"
            "    b = (x * mask).to(torch.float64)\n"
            "    c = torch.zeros(3, dtype=torch.double)\n"
            "    return a, b, c\n"
        )
        assert [f.symbol for f in port_lint({_PORT_MOD: src})] == [
            "double()", "to(torch.float64)", "dtype=torch.double"]

    @pytest.mark.parametrize("cast", ["total.float()", "total.to(torch.float32)",
                                      "torch.zeros(3, dtype=torch.float32)"])
    def test_each_sanctioned_float32_cast(self, cast):
        body = (
            "import torch\n"
            "class M:\n"
            "    def __init__(self, total):\n"
            f"        self.total = {cast}\n"
            "    def update(self, x, mask):\n"
            "        f = torch.where(mask.sum() > 0, 0.9, 1.0)\n"
            "        self.total = self.total * f\n"
        )
        assert _codes(body) == []
        assert _codes(body.replace(f"self.total = {cast}", "self.total = total")) == ["TPU012"]

    def test_the_registry_prefix_constant_is_a_flag_read(self):
        src = (
            "import os\n"
            "from torcheval_tpu_torch import _flags\n"
            "RAW = os.environ.get(_flags.PREFIX + 'CM_ROW_CHUNK')\n"
        )
        (f,) = port_lint({_PORT_MOD: src})
        assert (f.code, f.symbol) == ("TPU013", "TORCHEVAL_TPU_TORCH_CM_ROW_CHUNK")

    def test_the_jax_packages_flags_are_flagged_too(self):
        assert _codes("import os\nV = os.environ.get('TORCHEVAL_TPU_TELEMETRY')\n") == ["TPU013"]
        assert _codes("import os\nV = os.environ.get('TORCHEVAL_TPU_TORCH_TELEMETRY')\n") == [
            "TPU013"]
        assert _codes("import os\nV = os.environ.get('TORCHEVAL_TPU_TORCH_X')\n",
                      display="torcheval_tpu_torch/_flags.py") == []

    @pytest.mark.parametrize("line", ["import jax", "import jax.numpy as jnp",
                                      "from jax import lax", "import torcheval_tpu",
                                      "from torcheval_tpu.metrics import MulticlassAUROC",
                                      "import torcheval_tpu.telemetry.events"])
    def test_the_port_boundary(self, line):
        findings = port_lint({_PORT_MOD: f"{line}\n"})
        assert [(f.code, f.line) for f in findings] == [("TPU002", 1)]
        assert "port boundary" in findings[0].message
        lazy = port_lint({_PORT_MOD: f"def f():\n    {line}\n"})
        assert [(f.code, f.line) for f in lazy] == [("TPU002", 2)]
        # Tests import both packages on purpose.
        assert port_lint({"tests/test_x.py": f"{line}\n"}) == []

    def test_the_port_only_pins(self):
        # ops._build is a kernels-layer edge of its own, not ops/__init__.
        src = "from torcheval_tpu_torch.ops import _build\n"
        assert port_lint({"torcheval_tpu_torch/ops/x.py": src}) == []
        up = "from torcheval_tpu_torch import convert\n"
        (f,) = port_lint({"torcheval_tpu_torch/engine/x.py": up})
        assert f.code == "TPU002" and "[tools]" in f.message

    def test_module_names_match_whole_path_components(self):
        from torcheval_tpu_torch.analysis._core import module_name_for

        roots = ("torcheval_tpu_torch",)
        assert module_name_for("torcheval_tpu_torch/ops/x.py", roots) == "torcheval_tpu_torch.ops.x"
        assert module_name_for("torcheval_tpu/ops/x.py", roots) == "torcheval_tpu.ops.x"
        assert module_name_for("a/my_torcheval_tpu_torch/x.py", roots) == "a.my_torcheval_tpu_torch.x"
        assert module_name_for("torcheval_tpu_torch/__init__.py", roots) == "torcheval_tpu_torch"


# ------------------------------------------------ CLI, baseline, reports
_BAD_SRC = (
    "from torcheval_tpu_torch.telemetry import events as _telemetry\n"
    "def f():\n"
    "    _telemetry.emit(1)\n"
)


def run_cli(argv):
    out, err = io.StringIO(), io.StringIO()
    code = main(argv, stdout=out, stderr=err)
    return code, out.getvalue(), err.getvalue()


@pytest.fixture
def bad_file(tmp_path):
    p = tmp_path / "mod.py"
    p.write_text(_BAD_SRC)
    return str(p)


class TestCli:
    @pytest.mark.parametrize("comment,codes", [
        ("  # tpulint: disable=TPU001 -- test fixture", []),
        ("  # tpulint: disable=TPU006 -- wrong code", ["TPU001"]),
        ("  # tpulint: disable=all", []),
    ])
    def test_suppressions(self, comment, codes):
        src = _BAD_SRC.replace("_telemetry.emit(1)", "_telemetry.emit(1)" + comment)
        assert _codes(src) == codes
        above = _BAD_SRC.replace("    _telemetry.emit(1)", "    #" + comment.split("#")[1]
                                 + "\n    _telemetry.emit(1)")
        assert _codes(above) == codes

    def test_baseline_round_trip_and_justifications(self, tmp_path):
        (finding,) = port_lint({_PORT_MOD: _BAD_SRC})
        bl = str(tmp_path / "tpulint.baseline")
        write_baseline(bl, [finding])
        assert set(load_baseline(bl)) == {finding.fingerprint}
        write_baseline(bl, [finding], {finding.fingerprint: "a reason"})
        assert load_baseline(bl)[finding.fingerprint] == "a reason"
        new, old, stale = split_by_baseline([finding], load_baseline(bl))
        assert (new, len(old), stale) == ([], 1, set())
        assert split_by_baseline([], {"TPU001:gone.py:f:emit": ""})[2] == {"TPU001:gone.py:f:emit"}

    def test_fingerprints_match_the_jax_format(self):
        (port,) = port_lint({_PORT_MOD: _BAD_SRC})
        (jax,) = jax_lint({"torcheval_tpu/somemod.py": _BAD_SRC.replace(
            "torcheval_tpu_torch", "torcheval_tpu")})
        assert port.fingerprint == translate_path(jax.fingerprint)
        (shifted,) = port_lint({_PORT_MOD: "\n\n\n" + _BAD_SRC})
        assert shifted.fingerprint == port.fingerprint

    def test_exit_codes(self, bad_file, tmp_path):
        clean = tmp_path / "clean.py"
        clean.write_text("x = 1\n")
        assert run_cli([str(clean)])[0] == 0
        code, out, _ = run_cli([bad_file, "--baseline", ""])
        assert code == 1 and "TPU001" in out
        code, _, err = run_cli(["/nonexistent/nowhere.py"])
        assert code == 2 and "cannot read" in err
        assert run_cli(["--json", "--sarif"])[0] == 2

    @pytest.mark.parametrize("flag", ["--select", "--ignore"])
    def test_tpu004_is_an_unknown_code(self, flag):
        code, _, err = run_cli([flag, "TPU004"])
        assert code == 2 and "TPU004" in err

    def test_list_rules_says_why_tpu004_is_out_of_scope(self):
        code, out, _ = run_cli(["--list-rules"])
        assert code == 0
        for n in (1, 2, 3, 5, 6, 7, 8, 9, 10, 11, 12, 13):
            assert f"TPU{n:03d}" in out
        (line,) = [ln for ln in out.splitlines() if ln.startswith("TPU004")]
        assert "out of scope" in line and "deletes" in line

    def test_select_and_ignore(self, bad_file):
        code, out, _ = run_cli([bad_file, "--baseline", "", "--json", "--select",
                                "TPU006,TPU007,TPU008,TPU009"])
        assert code == 0 and json.loads(out)["new"] == []
        assert run_cli([bad_file, "--baseline", "", "--ignore", "TPU001"])[0] == 0

    def test_json_and_sarif_match_the_jax_reports(self, bad_file, tmp_path):
        jax_file = tmp_path / "jax_mod.py"
        jax_file.write_text(_BAD_SRC.replace("torcheval_tpu_torch", "torcheval_tpu"))
        from torcheval_tpu.analysis import main as jax_main

        for fmt in ("--json", "--sarif"):
            port_out, jax_out = io.StringIO(), io.StringIO()
            assert main([bad_file, "--baseline", "", fmt], stdout=port_out) == 1
            assert jax_main([str(jax_file), "--baseline", "", fmt], stdout=jax_out) == 1
            port_doc = json.loads(port_out.getvalue().replace(bad_file, "F"))
            jax_doc = json.loads(jax_out.getvalue().replace(str(jax_file), "F"))
            if fmt == "--sarif":
                # The rule tables differ by TPU004 and by the rules' words.
                for doc in (port_doc, jax_doc):
                    doc["runs"][0]["tool"]["driver"].pop("rules")
                    for r in doc["runs"][0]["results"]:
                        r["message"]["text"] = ""
            else:
                for doc in (port_doc, jax_doc):
                    for f in doc["new"]:
                        f["message"] = ""
            assert port_doc == jax_doc

    def test_sarif_marks_grandfathered_as_suppressed(self, bad_file, tmp_path):
        bl = str(tmp_path / "tpulint.baseline")
        with open(bl, "w") as f:
            f.write("# tpulint baseline\n")
        assert run_cli([bad_file, "--baseline", bl, "--write-baseline"])[0] == 0
        code, out, _ = run_cli([bad_file, "--baseline", bl, "--sarif"])
        assert code == 0
        (result,) = json.loads(out)["runs"][0]["results"]
        assert result["suppressions"][0]["kind"] == "external"

    def test_help_names_the_port_and_its_scoped_out_files(self):
        with pytest.raises(SystemExit) as exc:
            run_cli(["--help"])
        assert exc.value.code == 0


# -------------------------------------------------------- the real tree
@pytest.fixture(scope="module")
def tree_run():
    """One whole-tree run of the CLI, shared by the tests that read it."""
    return run_cli(["--json"])


def test_the_port_is_clean_against_its_baseline(tree_run):
    code, out, err = tree_run
    payload = json.loads(out)
    assert code == 0, (payload["new"], err)
    assert payload["stale_baseline"] == []
    assert payload["files_checked"] > 150


def test_every_baseline_line_and_suppression_carries_a_reason():
    with open(BASELINE_PATH, encoding="utf-8") as f:
        entries = [ln for ln in f if ln.strip() and not ln.startswith("#")]
    assert entries
    for ln in entries:
        fp, sep, why = ln.partition("#")
        assert sep and why.strip() and "TODO" not in why, ln
    pattern = re.compile(r"#\s*tpulint:\s*disable=([A-Z0-9,]+)(.*)$")
    for base, _dirs, files in os.walk(os.path.join(ROOT, "torcheval_tpu_torch")):
        if os.path.basename(base) == "analysis" or "/analysis/" in base:
            continue
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(base, name), encoding="utf-8") as f:
                    for ln in f:
                        m = pattern.search(ln)
                        if m:
                            assert re.match(r"\s*--\s*\S", m.group(2)), ln


def test_suppressions_carried_from_jax_keep_their_code_and_words():
    pattern = re.compile(r"#\s*tpulint:\s*disable=.*$")

    def comments(root):
        out = {}
        for base, _dirs, files in os.walk(os.path.join(ROOT, root)):
            if "analysis" in base.split(os.sep):
                continue
            for name in files:
                if name.endswith(".py"):
                    rel = os.path.relpath(os.path.join(base, name), os.path.join(ROOT, root))
                    with open(os.path.join(base, name), encoding="utf-8") as f:
                        out[rel] = [m.group(0) for m in map(pattern.search, f) if m]
        return out

    jax, port = comments("torcheval_tpu"), comments("torcheval_tpu_torch")
    for rel in ("serve/cluster.py", "serve/service.py", "serve/metering.py",
                "resilience/faults.py", "telemetry/flightrec.py", "native/edit_distance.py"):
        assert port[rel] == jax[rel], rel
    # Every port suppression outside those files repeats one of JAX's.
    every_jax = {c for cs in jax.values() for c in cs}
    assert {c for cs in port.values() for c in cs} <= every_jax


# ----------------------------------------- mutations of real port sites
def _real(path):
    with open(os.path.join(ROOT, path), encoding="utf-8") as f:
        return f.read()


def _drop_decay_cast(src):
    lines = src.splitlines(keepends=True)
    start = next(i for i, ln in enumerate(lines) if "for name in self._decayed:" in ln)
    end = next(i for i, ln in enumerate(lines)
               if "getattr(metric, name).to(torch.float32)" in ln) + 1
    return "".join(lines[:start] + lines[end:])


_MUTATIONS = {
    "TPU001 guard removed in parallel/_compile_cache.py": (
        "torcheval_tpu_torch/parallel/_compile_cache.py", "TPU001",
        lambda s: s.replace("if self._events and _telemetry.ENABLED:", "if self._events:", 1)),
    "TPU001 a profiler range opened without its ANNOTATE branch in ops/auc.py": (
        "torcheval_tpu_torch/ops/auc.py", "TPU001",
        lambda s: s.replace(
            "        if _telemetry.ANNOTATE:\n            with _telemetry.span(\"compute.sort\"):",
            "        if True:\n            with _telemetry.span(\"compute.sort\"):", 1)),
    "TPU001 member spans outside their SPANS branch in metrics/collection.py": (
        "torcheval_tpu_torch/metrics/collection.py", "TPU001",
        lambda s: s.replace("spans = _telemetry.SPANS", "spans = True", 1)),
    "TPU002 a module-level import of jax": (
        "torcheval_tpu_torch/metrics/metric.py", "TPU002",
        lambda s: s + "\nimport jax\n"),
    "TPU006 a lock removed in resilience/membership.py": (
        "torcheval_tpu_torch/resilience/membership.py", "TPU006",
        lambda s: s.replace("with self._lock:", "if True:", 1)),
    "TPU007 a barrier wait under the mailbox condition": (
        "torcheval_tpu_torch/distributed.py", "TPU007",
        lambda s: s.replace(
            "            self._world._mail[(dst, self._rank, tag)] = payload\n",
            "            self._world._mail[(dst, self._rank, tag)] = payload\n"
            "            self._world._barrier.wait()\n", 1)),
    "TPU008 the prefetch thread un-daemonized and never joined": (
        "torcheval_tpu_torch/engine/prefetch.py", "TPU008",
        lambda s: "".join(ln for ln in s.replace("daemon=True", "daemon=False")
                          .splitlines(keepends=True) if "self._thread.join" not in ln)),
    "TPU009 excise's check hoisted out of its lock": (
        "torcheval_tpu_torch/resilience/membership.py", "TPU009",
        lambda s: s.replace(
            "        with self._lock:\n"
            "            if rank in self._dead or rank == self.rank:\n"
            "                return False\n",
            "        if rank in self._dead or rank == self.rank:\n"
            "            return False\n"
            "        with self._lock:\n", 1)),
    "TPU010 the accuracy kernel drops its mask": (
        "torcheval_tpu_torch/metrics/functional/classification/accuracy.py", "TPU010",
        lambda s: s.replace("correct = correct * mask.to(correct.dtype)", "pass", 1)),
    "TPU011 Decayed loses its pad-step gate": (
        "torcheval_tpu_torch/monitor/decay.py", "TPU011",
        lambda s: s.replace("factor = torch.where(mask.sum() > 0, self._decay, 1.0)",
                            "factor = self._decay * 1.0", 1)),
    "TPU012 Decayed loses its int-state cast": (
        "torcheval_tpu_torch/monitor/decay.py", "TPU012", _drop_decay_cast),
    "TPU013 the raw CM_ROW_CHUNK read comes back": (
        "torcheval_tpu_torch/routing_autotune.py", "TPU013",
        lambda s: s.replace('raw = _flags.raw("CM_ROW_CHUNK")',
                            'raw = os.environ.get(_flags.PREFIX + "CM_ROW_CHUNK")', 1)),
}


@pytest.mark.parametrize("label", sorted(_MUTATIONS))
def test_a_mutated_port_site_gives_a_new_finding(label):
    path, code, mutate = _MUTATIONS[label]
    src = _real(path)
    mutated = mutate(src)
    assert mutated != src, f"{label}: the mutation found nothing to change"
    assert [f.code for f in new_vs_port_baseline(port_lint({path: src}))] == []
    new = [f for f in new_vs_port_baseline(port_lint({path: mutated})) if f.code == code]
    assert new, f"{label}: went undetected"


# ------------------------------------------------- path load and hook map
def test_the_path_loaded_analyzer_imports_neither_torch_nor_jax():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import chip_smoke\n"
        f"m = chip_smoke.load_analysis_by_path({ROOT!r})\n"
        "rc = m.main(['--list-rules'])\n"
        "leaked = [n for n in ('torch', 'jax', 'torcheval_tpu', 'torcheval_tpu_torch')"
        " if n in sys.modules]\n"
        "print('LEAKED', leaked)\n"
        "sys.exit(rc or bool(leaked))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout and "TPU013" in proc.stdout


def test_hook_site_map_covers_the_hook_families():
    sites = hook_site_map()
    for name in ("faults.fire", "health.inspect", "perfscope.profile_program",
                 "monitor.publish", "trace.activate", "flightrec.trigger", "record_sync"):
        assert name in sites, name
    for locs in sites.values():
        for loc in locs:
            path, _, line = loc.rpartition(":")
            assert line.isdigit() and path.startswith("torcheval_tpu_torch/"), loc
            assert os.path.exists(os.path.join(ROOT, path)), loc
    names = hook_entry_points()
    assert names == sorted(sites)


def test_the_hook_map_check_runs_on_the_cpu_path():
    """Phase 72's check with CPU tensors: with every bus off the headline
    metric, an engine block, a serve dispatch and a WER update call no
    hook of the static map; with the event bus on, ``emit`` fires."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    from torcheval_tpu_torch.engine import Evaluator
    from torcheval_tpu_torch.metrics import (
        MetricCollection,
        MulticlassAccuracy,
        MulticlassAUROC,
        MulticlassF1Score,
        WordErrorRate,
    )
    from torcheval_tpu_torch.serve import EvalService
    from torcheval_tpu_torch.telemetry import events as bus

    rng = torch.Generator().manual_seed(0)
    x, y = torch.rand(64, 10, generator=rng), torch.randint(0, 10, (64,), generator=rng)

    def suite():
        return {"acc": MulticlassAccuracy(num_classes=10, device="cpu"),
                "f1": MulticlassF1Score(num_classes=10, average="macro", device="cpu")}

    def paths():
        auroc = MulticlassAUROC(num_classes=10, device="cpu")
        auroc.update(x, y)
        auroc.compute()
        ev = Evaluator(MetricCollection(suite(), bucket=True), block_size=2)
        ev.run([(x, y), (x[:40], y[:40])])
        svc = EvalService(group_width=2)
        svc.open("t", suite())
        svc.submit("t", x, y)
        svc.pump()
        svc.close("t")
        wer = WordErrorRate(device="cpu")
        wer.update(["a b c", "d e"], ["a b", "d e f"])
        wer.compute()

    names = sorted(set(hook_entry_points()) | {"emit"})
    off, on = {}, {}
    with chip_smoke.buses_off(), chip_smoke.counting_hooks(names, off):
        paths()
    assert off == {}
    with chip_smoke.buses_off(), chip_smoke.counting_hooks(names, on):
        bus.enable()
        try:
            paths()
        finally:
            bus.disable()
            bus.clear()
    assert on.get("emit", 0) >= 1, on
    with pytest.raises(LookupError):
        with chip_smoke.counting_hooks(["health.no_such_hook"], {}):
            pass


def test_excludes_match_below_the_repo_root(tmp_path):
    # A checkout unpacked under an excluded directory name (an A/B run's
    # ``_chip_archive/<commit>/``) still walks its own tree, and that
    # tree's own ``_chip_archive/`` stays out.
    from torcheval_tpu_torch.analysis._config import DEFAULT_EXCLUDES
    from torcheval_tpu_torch.analysis._core import iter_python_files

    repo = tmp_path / "_chip_archive" / "commit"
    (repo / "torcheval_tpu_torch").mkdir(parents=True)
    (repo / "_chip_archive" / "older").mkdir(parents=True)
    (repo / "torcheval_tpu_torch" / "a.py").write_text("x = 1\n")
    (repo / "_chip_archive" / "older" / "b.py").write_text("x = 1\n")
    files, missing = iter_python_files([str(repo)], DEFAULT_EXCLUDES, root=str(repo))
    assert files == [str(repo / "torcheval_tpu_torch" / "a.py")] and missing == []
