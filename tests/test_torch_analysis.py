"""Tests for repro_torch.analysis, the port's contract linter and interface
checker; the counterpart of tests/test_analysis.py.

* **fixtures**: a bad and a good source string per rule, each pinned to
  its zone by a ``# repolint: zone=`` directive; bad fires exactly its
  rule, good is clean, and the CLI exit codes gate accordingly.
* **the reference**: on the reference's own fixtures of the rules that
  carry over unchanged (CLK001-CLK003, TRC001, PRG001) the port's linter
  gives exactly the reference's ``(rule, line)`` findings.
* **self-check**: the live ``src/repro_torch`` tree lints clean, and
  mutations of live modules (a wall clock in the serving engine, an
  unclassified public op) are caught.
* **interface**: the matrix is clean on the live ops on the CPU, each of
  ABS001/ABS002 fires on a deliberately broken case, and ``check_launch``
  fires ABS003/ABS004 on synthetic launches; the launch checks themselves
  need the card (``cuda`` marker).
"""
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro import analysis as ref_analysis  # noqa: E402
from repro_torch.analysis import abstract, cli, walker, zones  # noqa: E402
from repro_torch.analysis.report import (Finding, sort_findings,  # noqa: E402
                                         summarize)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: CPU results must not depend on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REF_FIXTURES = Path(__file__).parent / "fixtures" / "lint"
ROOT = Path(__file__).resolve().parents[1]

# rule -> (bad source, good source).  DSP001 has one bad source a clause.
FIXTURES = {
    "CLK001": ('''# repolint: zone=serve
import time


def latency(start):
    return time.monotonic() - start
''', '''# repolint: zone=serve
import time


class Engine:
    def __init__(self, clock=time.monotonic):
        self._clock = clock

    def latency(self, start):
        return self._clock() - start
'''),
    "CLK002": ('''# repolint: zone=train
import time


def expire(entries, now=0.0):
    cutoff = time.monotonic() - 60.0
    return [e for e in entries if e > cutoff]
''', '''# repolint: zone=train


def expire(entries, now=0.0):
    return [e for e in entries if e > now - 60.0]
'''),
    "CLK003": ('''# repolint: zone=launch
import time


def step_time(fn):
    t0 = time.time()
    fn()
    return time.time() - t0
''', '''# repolint: zone=launch
import time


def step_time(fn):
    t0 = time.monotonic()
    fn()
    return time.monotonic() - t0
'''),
    "TRC001": ('''# repolint: zone=kernels
import functools


@functools.lru_cache(maxsize=None)
def _table(n, device):
    return (n, device)
''', '''# repolint: zone=kernels
import functools


@functools.lru_cache(maxsize=None)
def _table(n: int, device: str, chunk: int | None):
    return (n, device, chunk)
'''),
    "VJP001": ('''# repolint: zone=kernels.ops
from repro_torch.kernels import knn as _knn


def knn_blocks(queries, window, wmask, *, k: int, chunk: int | None = None):
    return _knn.knn_blocks(queries, window, wmask, k=k)
''', '''# repolint: zone=kernels.ops
from repro_torch.kernels import gather as _ga
from repro_torch.kernels import knn as _knn
from repro_torch.kernels.vjp import Gathering, IndexProducer


def _index_producer(fn, arrays):
    return IndexProducer.apply(fn, *arrays)


def knn_blocks(queries, window, wmask, *, k: int, chunk: int | None = None):
    return _index_producer(lambda q, w, m: _knn.knn_blocks(q, w, m, k=k),
                           (queries, window, wmask))


def gather_blocks(feats, idx, *, chunk: int | None = None):
    return Gathering.apply(_ga.gather_blocks, _ga.scatter_add_blocks,
                           feats, idx)
'''),
    "DSP002": ('''# repolint: zone=serve
import torch


def filler(n):
    return torch.zeros((n, 3), device="cpu")
''', '''# repolint: zone=serve
import torch


def filler(n, device="cpu"):
    return torch.zeros((n, 3), device=device)
'''),
    "PRG001": ('''# repolint: zone=train
import time


def stamp():
    return time.monotonic()  # repolint: disable=CLK003
''', '''# repolint: zone=train
import time


def stamp():
    # Read by other processes, so the wall clock is the right domain.
    return time.time()  # repolint: disable=CLK003
'''),
}

_OPS_HEAD = '''# repolint: zone=kernels.ops
import os

from repro_torch.kernels import fps as _fps
from repro_torch.kernels.vjp import IndexProducer


def _index_producer(fn, arrays):
    return IndexProducer.apply(fn, *arrays)
'''

_KNN_HEAD = '''# repolint: zone=kernels
from repro_torch.kernels import _build
from repro_torch.kernels.common import on_card


def knn_blocks(queries, window, wmask, *, k):
    if not on_card(queries, window, wmask):
        return knn_plain(queries, window, wmask, k=k)
    idx, d2 = outputs(queries, k)
    try:
        err = _build.library().fc_knn_blocks(queries, window, wmask, idx, d2)
'''

DSP001_BAD = {
    "impl": _OPS_HEAD + '''

def fps_blocks(coords, mask, *, k: int, impl=None, chunk: int | None = None):
    return _index_producer(lambda c, m: _fps.fps_blocks(c, m, k=k),
                           (coords, mask))
''',
    "environment": _OPS_HEAD + '''

def fps_blocks(coords, mask, *, k: int, chunk: int | None = None):
    if os.environ.get("REPRO_POINT_IMPL") == "plain":
        coords = coords.cpu()
    return _index_producer(lambda c, m: _fps.fps_blocks(c, m, k=k),
                           (coords, mask))
''',
    "fallback": _KNN_HEAD + '''    except OSError:
        return knn_plain(queries, window, wmask, k=k)
    knn_blocks.launches += 1
    return idx, d2
''',
    "no on_card": '''# repolint: zone=kernels
from repro_torch.kernels import _build


def fps_blocks(coords, mask, *, k):
    if not coords.is_cuda:
        return fps_plain(coords, mask, k)
    _build.library().fc_fps_warp_blocks(coords, mask, k)
    fps_blocks.launches += 1
''',
}

DSP001_GOOD = _KNN_HEAD + '''    except OSError as e:
        raise RuntimeError("the kernel library did not load") from e
    knn_blocks.launches += 1
    return idx, d2
'''

BAD = [(rule, src) for rule, (src, _) in FIXTURES.items()] + \
    [("DSP001", src) for src in DSP001_BAD.values()]
BAD_IDS = list(FIXTURES) + [f"DSP001-{k}" for k in DSP001_BAD]
GOOD = [good for _, good in FIXTURES.values()] + [DSP001_GOOD]
GOOD_IDS = list(FIXTURES) + ["DSP001"]


def rules_of(findings):
    return sorted({f.rule for f in findings})


# ---------------------------------------------------------------- fixtures

@pytest.mark.parametrize("rule,src", BAD, ids=BAD_IDS)
def test_bad_fixture_fires_exactly_its_rule(rule, src):
    findings = walker.lint_source(src, "fixture.py")
    assert rules_of(findings) == [rule], [f.format() for f in findings]
    assert all(f.path == "fixture.py" and f.line >= 1 for f in findings)


@pytest.mark.parametrize("src", GOOD, ids=GOOD_IDS)
def test_good_fixture_is_clean(src):
    findings = walker.lint_source(src, "fixture.py")
    assert findings == [], [f.format() for f in findings]


def test_dsp002_spares_the_device_module():
    src = 'import torch\n\nCARD = torch.zeros(1, device="cuda")\n'
    assert walker.lint_source(src, "src/repro_torch/device.py") == []
    assert rules_of(walker.lint_source(
        src, "src/repro_torch/serve/engine.py")) == ["DSP002"]


@pytest.mark.parametrize("rule,src", BAD, ids=BAD_IDS)
def test_cli_fails_on_bad_fixture(rule, src, tmp_path, capsys):
    path = tmp_path / "bad.py"
    path.write_text(src)
    # --strict so the warning-severity CLK003 fixture gates too.
    assert cli.main([str(path), "--strict"]) == 1
    out = capsys.readouterr().out
    assert rule in out and "bad.py" in out


@pytest.mark.parametrize("src", GOOD, ids=GOOD_IDS)
def test_cli_passes_on_good_fixture(src, tmp_path):
    path = tmp_path / "good.py"
    path.write_text(src)
    assert cli.main([str(path), "--strict"]) == 0


def test_warnings_gate_only_under_strict(tmp_path):
    path = tmp_path / "clk003.py"
    path.write_text(FIXTURES["CLK003"][0])
    assert cli.main([str(path)]) == 0          # CLK003 is a warning
    assert cli.main([str(path), "--strict"]) == 1


def test_rules_flag_narrows_the_run(tmp_path):
    path = tmp_path / "clk001.py"
    path.write_text(FIXTURES["CLK001"][0])
    assert cli.main([str(path), "--rules", "CLK001"]) == 1
    assert cli.main([str(path), "--rules", "TRC001"]) == 0


def test_list_rules(capsys):
    assert cli.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in ("CLK001", "TRC001", "VJP001", "DSP001", "DSP002", "PRG001",
                 "ABS001", "ABS002", "ABS003", "ABS004"):
        assert rule in out
    assert "TRC002" not in out and "TRC003" not in out


def test_tree_run_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tree run would use it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([])
    assert cli.main(["--no-abstract", "--strict"]) == 0


def test_cli_tree_run_on_the_cpu_is_clean(capsys):
    assert cli.main(["--strict", "--device", "cpu"]) == 0
    assert capsys.readouterr().out == ""


# -------------------------------------------------------- the reference

REF_CARRIED = ["clk001_bad", "clk001_good", "clk002_bad", "clk002_good",
               "clk003_bad", "clk003_good", "trc001_bad", "trc001_good",
               "pragma_ok", "pragma_unused"]


@pytest.mark.parametrize("name", REF_CARRIED)
def test_reference_fixtures_give_the_reference_findings(name):
    text = (REF_FIXTURES / f"{name}.py").read_text()
    want = sorted((f.rule, f.line)
                  for f in ref_analysis.lint_source(text, f"{name}.py"))
    got = sorted((f.rule, f.line)
                 for f in walker.lint_source(text, f"{name}.py"))
    assert got == want
    assert bool(want) == name.endswith(("_bad", "_unused"))


# -------------------------------------------------------------- suppression

def test_pragma_suppresses_only_its_line_and_rule():
    text = FIXTURES["PRG001"][1]
    assert walker.lint_source(text, "p.py") == []
    # The same pragma does not excuse a different rule id ...
    swapped = text.replace("disable=CLK003", "disable=TRC001")
    assert rules_of(walker.lint_source(swapped, "p.py")) == ["CLK003",
                                                             "PRG001"]
    # ... nor the same rule on another line.
    moved = text.replace("    return time.time()  # repolint: disable=CLK003",
                         "    # repolint: disable=CLK003\n"
                         "    return time.time()")
    findings = walker.lint_source(moved, "p.py")
    assert rules_of(findings) == ["CLK003", "PRG001"]
    assert {f.rule: f.line for f in findings} == {"PRG001": 7, "CLK003": 8}


def test_pragma_in_docstring_is_not_a_pragma():
    text = ('# repolint: zone=train\n'
            '"""Docs may quote `# repolint: disable=CLK003` freely."""\n'
            "X = 1\n")
    assert walker.lint_source(text, "doc.py") == []


def test_unused_pragma_fires_prg001():
    findings = walker.lint_source(FIXTURES["PRG001"][0], "p.py")
    assert [(f.rule, f.line) for f in findings] == [("PRG001", 6)]


# ----------------------------------------------------------- zones / report

def test_zone_of_port_paths():
    assert zones.zone_of("src/repro_torch/serve/engine.py") == "serve"
    assert zones.zone_of("src/repro_torch/kernels/ops.py") == "kernels.ops"
    assert zones.zone_of("src/repro_torch/kernels/knn.py") == "kernels"
    assert zones.zone_of("src/repro_torch/dist/compression.py") == "dist"
    assert zones.zone_of("src/repro_torch/analysis/rules.py") == "analysis"
    assert zones.zone_of("src/repro_torch/device.py") == "other"
    # The JAX package is not the port's: its files are "other" here.
    assert zones.zone_of("src/repro/serve/engine.py") == "other"
    assert zones.zone_of("src/repro/kernels/ops.py") == "other"
    assert zones.zone_of("f.py", "# repolint: zone=scene") == "scene"


def test_every_rule_has_zones_severity_and_doc():
    assert set(zones.RULE_ZONES) == {"CLK001", "CLK002", "CLK003", "TRC001",
                                     "VJP001", "DSP001", "DSP002", "PRG001"}
    assert set(zones.RULE_ZONES) <= set(zones.RULE_DOC)
    assert zones.RULE_SEVERITY["CLK003"] == "warn"
    assert {s for r, s in zones.RULE_SEVERITY.items()
            if r != "CLK003"} == {"error"}
    assert zones.RULE_ZONES["DSP002"].isdisjoint({"kernels", "kernels.ops"})


def test_finding_format_and_sort():
    a = Finding(path="b.py", line=3, rule="CLK001", severity="error",
                message="m")
    b = Finding(path="a.py", line=9, rule="CLK003", severity="warn",
                message="m")
    assert a.format() == "b.py:3 CLK001 error m"
    assert sort_findings([a, b])[0].path == "a.py"
    assert "1 error" in summarize([a, b])


# ------------------------------------------------------ live-tree self-check

def test_live_tree_lints_clean():
    findings = walker.lint_tree()
    assert findings == [], "\n".join(f.format() for f in findings)
    assert len(walker.default_tree()) > 40


def test_mutation_reintroducing_wall_clock_is_caught():
    """A wall-clock read in the serving engine outside its justified
    ``warm`` must trip CLK001."""
    rel = "src/repro_torch/serve/engine.py"
    clean = (ROOT / rel).read_text()
    assert walker.lint_source(clean, rel) == []
    mutated = clean + ("\n\ndef _leaky_latency(start):\n"
                       "    return time.monotonic() - start\n")
    assert rules_of(walker.lint_source(mutated, rel)) == ["CLK001"]


def test_mutation_adding_an_unclassified_op_is_caught():
    rel = "src/repro_torch/kernels/ops.py"
    clean = (ROOT / rel).read_text()
    assert walker.lint_source(clean, rel) == []
    mutated = clean + ("\n\ndef scaled_blocks(x, *, chunk: int | None = "
                       "None):\n"
                       "    return _chunked(lambda a: 2 * a, (x,), chunk)\n")
    findings = walker.lint_source(mutated, rel)
    assert [f.rule for f in findings] == ["VJP001"]
    assert "scaled_blocks" in findings[0].message


# ------------------------------------------------------------ interface layer

def test_abstract_matrix_is_clean_on_live_ops():
    findings = abstract.run_interface_checks(matrix=(abstract.MATRIX[0],))
    assert findings == [], "\n".join(f.format() for f in findings)


def _bogus(call, oracle):
    return abstract.OpCase(
        name="bogus", wrapper=abstract.check_case,
        make_inputs=lambda d, dev: (torch.zeros((4, 8), device=dev),),
        call=call, oracle=oracle)


def test_abstract_catches_a_chunk_parity_break():
    # The chunked path drops rows: ABS001 alone.
    case = _bogus(lambda inp, chunk, d: inp[0] if chunk is None
                  else inp[0][:2], lambda inp, d: inp[0])
    assert rules_of(abstract.check_case(case, {})) == ["ABS001"]


def test_abstract_catches_an_oracle_mismatch():
    # The plain version says (4, 3) where the op gives (4, 8): ABS002 alone.
    case = _bogus(lambda inp, chunk, d: inp[0] * 2,
                  lambda inp, d: inp[0][:, :3])
    assert rules_of(abstract.check_case(case, {})) == ["ABS002"]


def test_abstract_reports_a_failing_call_as_abs001():
    def call(inp, chunk, d):
        raise ValueError("refused")

    findings = abstract.check_case(_bogus(call, lambda inp, d: inp[0]), {})
    assert rules_of(findings) == ["ABS001"] and len(findings) == 2
    assert "refused" in findings[0].message


LIMITS = {"max_grid": (2 ** 31 - 1, 65535, 65535), "smem_optin": 232448,
          "warp": 32}
ATTRS = {"num_regs": 40, "local_bytes": 0, "static_smem": 8192,
         "max_threads": 1024, "ctas_per_sm": 4}


def launch(**kw):
    return dict(dict(kernel="k", grid=(10204, 1, 1), threads=256,
                     smem=24708), **kw)


def test_check_launch_passes_a_launch_that_fits():
    assert abstract.check_launch(launch(), ATTRS, LIMITS) == []


@pytest.mark.parametrize("config,attrs,rules", [
    (launch(threads=96), dict(ATTRS, max_threads=64), ["ABS003"]),
    (launch(threads=100), ATTRS, ["ABS003"]),
    (launch(grid=(0, 1, 1)), ATTRS, ["ABS003"]),
    (launch(grid=(8, 70000, 1)), ATTRS, ["ABS003"]),
    (launch(smem=232448 - 8192 + 4), ATTRS, ["ABS004"]),
    (launch(), dict(ATTRS, local_bytes=16), ["ABS004"]),
    (launch(threads=1100, smem=300000), ATTRS, ["ABS003", "ABS004"]),
], ids=["above-max-threads", "not-whole-warps", "empty-grid", "grid-y",
        "smem-above-optin", "spills", "both"])
def test_check_launch_fires(config, attrs, rules):
    findings = abstract.check_launch(dict(config, source="k.cu", line=7),
                                     attrs, LIMITS)
    assert rules_of(findings) == rules
    assert all((f.path, f.line) == ("k.cu", 7) for f in findings)


def test_every_launcher_is_declared_in_the_library_signatures():
    from repro_torch.kernels import _build

    for family in abstract.LAUNCHERS:
        assert f"fc_{family}_geometry" in _build.SIGNATURES
        assert f"fc_{family}_attributes" in _build.SIGNATURES
    families = {f if f != "fps" else "fps_warp"
                for f, _ in abstract.PATH_SHAPES}
    assert families | {"fps_cta", "fps_wide"} == set(abstract.LAUNCHERS)


@pytest.mark.cuda
def test_interface_and_launch_checks_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the launch checks query the "
                    "built kernels")
    assert abstract.run_matrix_checks(device="cuda") == []
    findings, rows = abstract.run_launch_checks()
    assert findings == [], "\n".join(f.format() for f in findings)
    assert set(rows) == set(abstract.all_variants())
    assert all(r["local_bytes"] == 0 and r["min_ctas_per_sm"] >= 1
               for r in rows.values())
