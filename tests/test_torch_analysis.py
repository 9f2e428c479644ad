"""The port's static analyzer, ``repro_torch.analysis``, on the CPU.

Per torch rule: a bad fixture that fires that rule alone, on exactly the
lines marked ``# SINK``; a good fixture that comes back clean; the bad
fixture with a justified ``# veltair: ignore[<rule>]`` above each hit,
which comes back clean and counted suppressed; and the bad fixture with
the *reference's* rule id in those comments, which stays flagged (the
two gates' suppressions never silence each other).  The fixtures are
source strings written to ``tmp_path``: under ``src/`` the reference's
gate would scan them.

Then the rule catalog, the CLI contract (``python -m
repro_torch.analysis`` exits 0 over the port, 1 on a violation, 2 on a
usage error, ``--json`` records), the port's hot slice (its aliases
resolved: ``step_once``, ``verify_drafts``, ``verify_call`` and the four
kernel wrappers are in it), and parity: the port's call graph over
``src/repro`` has every edge the reference's graph has there.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro.analysis import astutil as ref_astutil  # noqa: E402
from repro.analysis import runner as ref_runner  # noqa: E402
from repro.analysis.base import AnalysisContext as RefContext  # noqa: E402
from repro_torch.analysis import NO_COUNTERPART, all_rules, run  # noqa: E402
from repro_torch.analysis import astutil, runner  # noqa: E402
from repro_torch.analysis.base import AnalysisContext  # noqa: E402
from repro_torch.analysis.rules_hotpath import hot_slice  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"

# the slice a verbatim copy of the reference's analyzer reaches from the
# port's roots: it misses every call made through a name the port binds
# by assignment
VERBATIM_SLICE = 194


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the test runner's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HOTPATH_BAD = '''
import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class QuantumHandle:
    block: torch.Tensor
    n_left: np.ndarray


class Helper:
    def __init__(self):
        self.buf = torch.zeros(4, device="cuda")
        self.n = int(self.buf.sum())  # SINK

    def work(self):
        return self.buf.sum().item()  # SINK


class Other:
    def work(self):
        return 0


Aide = Helper


class TorchServingEngine:
    def __init__(self):
        self.helper = Aide()
        self.stream = torch.cuda.Stream()

    def begin_quantum(self, k: int, x: torch.Tensor):
        y = torch.ones(3, device="cuda")
        a = y.max().item()  # SINK
        b = y.cpu()  # SINK
        c = y.tolist()  # SINK
        d = y.numpy()  # SINK
        e = y.to("cpu")  # SINK
        f = x.to(device="cpu")  # SINK
        g = np.asarray(y)  # SINK
        h = int(x.sum())  # SINK
        if y.any():  # SINK
            pass
        while x.max() > 0:  # SINK
            break
        ok = not y  # SINK
        both = a and y  # SINK
        torch.cuda.synchronize()  # SINK
        self.stream.synchronize()  # SINK
        first = torch.argmax(y)
        first = float(first)  # SINK
        spare = Aide()
        return (a, b, c, d, e, f, g, h, ok, both, first, spare,
                self.helper.work(), self.step())

    def step_once(self):
        return bool(torch.ones(1, device="cuda").sum())  # SINK

    step = step_once

    def finish_quantum(self, handle: QuantumHandle):
        return bool(handle.block[0])  # SINK
'''

HOTPATH_GOOD = '''
import numpy as np
import torch


class TorchServingEngine:
    def __init__(self, device):
        self.dev = torch.zeros(8, dtype=torch.int64, device=device)
        self.slot_pos = np.zeros(4, np.int64)

    def begin_quantum(self, k: int, x: torch.Tensor):
        n = x.shape[0] + x.numel() + x.size(0) + x.dim() + x.ndim
        n += x.stride(0) + x.element_size() + self.dev.shape[0]
        if x.is_cuda and x.requires_grad and x.is_contiguous():
            n += 1
        if x is None or x.dtype == torch.bfloat16 or x.device.type == "cpu":
            n += 1
        dev = torch.device("cuda")
        gen = torch.Generator(dev)
        stream = torch.cuda.current_stream()
        if torch.is_grad_enabled():
            n += 1
        pos = int(self.slot_pos[0])
        budget = float(np.sum(self.slot_pos))
        y = (x * 2).to(dev)
        # veltair: ignore[torch-host-sync] the one sync of a quantum
        block = y.cpu()
        return n, gen, stream, pos, budget, block, int(block[0])
'''

RETRACE_BAD = '''
import torch


class Engine:
    def step(self, vc, entry, reqs, k_raw, d):
        vc.quantum(entry, k_raw, 4)  # SINK
        vc.spec_quantum(entry, len(reqs), d, 4)  # SINK
        vc.verify_call(entry, k_raw + 1, d, 4)  # SINK
        rows = torch.zeros(len(reqs), 4)  # SINK
        full = torch.full((len(reqs), 2), 0)  # SINK
        ids = torch.arange(len(reqs))  # SINK
        return rows, full, ids
'''

RETRACE_GOOD = '''
import torch

QUANTUM_BUCKETS = (1, 2, 4, 8)


def _next_pow2(n):
    return 1 << (max(n, 1) - 1).bit_length()


class Engine:
    def step(self, vc, entry, reqs, d, n):
        for bucket in QUANTUM_BUCKETS:
            vc.quantum(entry, bucket, 4)
        k = _next_pow2(n)
        vc.spec_quantum(entry, k, d, 4)
        vc.verify_call(entry, 8, d, 4)
        vc.quantum(entry, min(k, QUANTUM_BUCKETS[-1]), 4)
        rows = torch.zeros(_next_pow2(len(reqs)), 4)
        full = torch.full((4, 2), len(reqs))
        return rows, full
'''

PAGING_BAD = '''
import dataclasses


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    dtype: object = None
    axes: tuple = ()


def _kv_leaves(b, t):
    return {"k": ParamSpec((b, t, 2, 8), None, ("batch", "seq", "kv", "hd"))}


def stale_cache_leaves(b, t):
    return {"k": ParamSpec((b, t, 8), None, ("batch", "seq", "hd"))}  # SINK


def extra_cache_spec_table(b):  # SINK
    return {}


class TorchModel:
    def cache_specs(self, b, t):
        return _kv_leaves(b, t)
'''

PAGING_GOOD = '''
import dataclasses


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    dtype: object = None
    axes: tuple = ()


class TorchModel:
    def cache_specs(self, b, t):
        return self._kind_cache(b, t)

    def _kind_cache(self, b, t):
        return {"k": ParamSpec((b, t, 8), None, ("batch", "seq", "hd"))}

    def paged_cache_specs(self, b, t):
        return self.cache_specs(b, t)
'''

TILES_BAD = '''
from repro_torch.kernels import dispatch


def switch_level(tiles):
    dispatch.set_tile_overrides("matmul", tiles)  # SINK
    dispatch._TILE_OVERRIDES.update(tiles)  # SINK
    dispatch._LADDER = None  # SINK
    dispatch._CONTEXT_STACK.append(tiles)  # SINK
'''

TILES_GOOD = '''
from repro_torch.kernels import dispatch


def switch_level(tiles, levels):
    dispatch.install_tile_overrides(tiles)
    dispatch.install_ladder(levels)
    with dispatch.tile_context(tiles):
        return dispatch.active_ladder()
'''

# rule id -> (bad, good, the reference's id for the same hazard)
FIXTURES = {
    "torch-host-sync": (HOTPATH_BAD, HOTPATH_GOOD, "host-sync-in-hot-path"),
    "torch-retrace-hazard": (RETRACE_BAD, RETRACE_GOOD, "retrace-hazard"),
    "torch-paged-leaf-coverage": (PAGING_BAD, PAGING_GOOD,
                                  "paged-leaf-coverage"),
    "torch-tile-table-atomicity": (TILES_BAD, TILES_GOOD,
                                   "tile-table-atomicity"),
}
RULE_IDS = sorted(FIXTURES)


def _write(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(textwrap.dedent(text).lstrip("\n"))
    return path


def _sink_lines(path):
    return {i for i, line in enumerate(path.read_text().splitlines(), 1)
            if line.rstrip().endswith("# SINK")}


def _with_comments(path, lines, rule_id, out):
    """``path`` with ``# veltair: ignore[rule_id] ...`` above each line."""
    text = path.read_text().splitlines()
    for ln in sorted(lines, reverse=True):
        indent = len(text[ln - 1]) - len(text[ln - 1].lstrip())
        text.insert(ln - 1, " " * indent
                    + f"# veltair: ignore[{rule_id}] fixture test")
    out.write_text("\n".join(text) + "\n")
    return out


@pytest.mark.parametrize("rule_id", RULE_IDS)
def test_bad_fixture_fires_only_its_rule_on_its_lines(rule_id, tmp_path):
    bad = _write(tmp_path, "bad.py", FIXTURES[rule_id][0])
    report = run([str(bad)])
    assert {v.rule_id for v in report.violations} == {rule_id}
    assert {v.line for v in report.violations} == _sink_lines(bad), \
        [v.format() for v in report.violations]


@pytest.mark.parametrize("rule_id", RULE_IDS)
def test_good_fixture_is_clean(rule_id, tmp_path):
    good = _write(tmp_path, "good.py", FIXTURES[rule_id][1])
    report = run([str(good)])
    assert report.ok, [v.format() for v in report.violations]
    assert all(v.justified for v in report.suppressed)


@pytest.mark.parametrize("rule_id", RULE_IDS)
def test_bad_fixture_suppressed_in_place(rule_id, tmp_path):
    bad = _write(tmp_path, "bad.py", FIXTURES[rule_id][0])
    report = run([str(bad)])
    quiet = _with_comments(bad, {v.line for v in report.violations},
                           rule_id, tmp_path / "quiet.py")
    suppressed = run([str(quiet)])
    assert suppressed.ok, [v.format() for v in suppressed.violations]
    assert len(suppressed.suppressed) == len(report.violations)
    assert all(v.justified for v in suppressed.suppressed)


@pytest.mark.parametrize("rule_id", RULE_IDS)
def test_reference_rule_id_does_not_silence_the_port_rule(rule_id,
                                                          tmp_path):
    """``models/model.py`` carries ``ignore[paged-leaf-coverage]`` for the
    reference's gate: such a comment must not hide the port's finding."""
    bad = _write(tmp_path, "bad.py", FIXTURES[rule_id][0])
    report = run([str(bad)])
    ref_quiet = _with_comments(bad, {v.line for v in report.violations},
                               FIXTURES[rule_id][2], tmp_path / "ref.py")
    again = run([str(ref_quiet)])
    assert len(again.violations) == len(report.violations)
    assert not again.suppressed


def test_host_sync_follows_the_port_aliases(tmp_path):
    """The hits in ``step_once`` (reached only through ``step =
    step_once``), ``Helper.__init__`` (only through ``Aide = Helper``)
    and ``Helper.work`` (``self.helper = Aide()``, where a second
    ``work`` makes the bare name ambiguous) need the widened graph."""
    bad = _write(tmp_path, "bad.py", HOTPATH_BAD)
    where = {v.message.rsplit("(", 1)[-1].rstrip(")")
             for v in run([str(bad)]).violations}
    assert {"TorchServingEngine.step_once", "Helper.__init__",
            "Helper.work", "TorchServingEngine.finish_quantum"} <= where


def test_good_hot_path_suppression_is_counted_and_justified(tmp_path):
    good = _write(tmp_path, "good.py", HOTPATH_GOOD)
    report = run([str(good)])
    assert report.ok
    assert [(v.rule_id, v.justified) for v in report.suppressed] == \
        [("torch-host-sync", True)]


def test_unjustified_suppression_is_reported_as_such(tmp_path):
    f = _write(tmp_path, "m.py", '''
        import torch
        class TorchServingEngine:
            def begin_quantum(self, k):
                x = torch.zeros((2,), device="cuda")
                return int(x.sum())  # veltair: ignore[torch-host-sync]
        ''')
    report = run([str(f)])
    assert report.ok and len(report.suppressed) == 1
    assert not report.suppressed[0].justified


def test_syntax_rule_flags_and_resists_suppression(tmp_path):
    bad = _write(tmp_path, "broken.py",
                 "# veltair: ignore[syntax] nope\ndef broken(:\n")
    report = run([str(bad)])
    assert [v.rule_id for v in report.violations] == ["syntax"]


def test_rule_catalog():
    assert set(all_rules()) == {"syntax", *RULE_IDS}
    # the reference's donation rule has no counterpart, and says why
    assert set(NO_COUNTERPART) == {"use-after-donation"}
    assert "in place" in NO_COUNTERPART["use-after-donation"]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                           *args], capture_output=True, text=True,
                          cwd=ROOT, env=env, timeout=300)


def test_cli_is_clean_over_the_port():
    proc = _cli()                     # the default path is the package
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert " 0 violation(s)" in proc.stdout
    assert "no justification" not in proc.stdout


def test_cli_json_exit_codes_and_catalog(tmp_path):
    bad = _write(tmp_path, "bad.py", RETRACE_BAD)
    good = _write(tmp_path, "good.py", RETRACE_GOOD)
    proc = _cli("--json", str(bad))
    assert proc.returncode == 1, proc.stderr
    data = json.loads(proc.stdout)
    assert data["ok"] is False
    rec = data["violations"][0]
    assert {"file", "line", "col", "rule", "message"} <= set(rec)
    assert rec["rule"] == "torch-retrace-hazard"
    proc = _cli("--json", str(good))
    assert proc.returncode == 0 and json.loads(proc.stdout)["ok"] is True
    proc = _cli("--rules", "syntax", str(bad))
    assert proc.returncode == 0
    proc = _cli("--rules", "no-such-rule", str(bad))
    assert proc.returncode == 2 and "unknown rule" in proc.stderr
    proc = _cli(str(tmp_path / "missing.py"))
    assert proc.returncode == 2 and "no such path" in proc.stderr
    proc = _cli("--no-such-flag")
    assert proc.returncode == 2
    proc = _cli("--list-rules")
    assert proc.returncode == 0
    assert "torch-host-sync" in proc.stdout
    assert "use-after-donation" in proc.stdout


# ---------------------------------------------------------------------------
# the port itself
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def port_ctx():
    files = [astutil.load_file(p, runner.module_name(p))
             for p in runner.iter_python_files([str(PORT)])]
    return AnalysisContext(files)


def test_port_gate_suppressions_are_the_sanctioned_sites():
    report = run([str(PORT)])
    assert report.ok, [v.format() for v in report.violations]
    assert all(v.justified for v in report.suppressed), \
        [v.format() for v in report.suppressed if not v.justified]
    where = {(pathlib.Path(v.path).name,
              v.message.rsplit("(", 1)[-1].rstrip(")"))
             for v in report.suppressed}
    assert where == {
        ("engine.py", "StepInputs.push"),            # event wait, pinned row
        ("engine.py", "TorchServingEngine.admit_request"),
        ("engine.py", "TorchServingEngine.prefill_step"),
        ("engine.py", "TorchServingEngine.finish_quantum"),
        ("layers.py", "embed"),                      # a CPU scalar
    }


def test_port_hot_slice_holds_the_aliased_paths_and_kernels(port_ctx):
    hot = hot_slice(port_ctx)
    for suffix in ("TorchServingEngine.step_once",
                   "TorchModel.verify_drafts",
                   "TorchVersionCache.verify_call",
                   "block_matmul.block_matmul_2d",
                   "flash_attention.flash_attention",
                   "flash_attention_paged.flash_attention_paged",
                   "ssd_scan.ssd_scan"):
        mod, _, name = suffix.rpartition(".")
        hits = [q for q in port_ctx.graph.find(name) if q in hot
                and (q.split(":")[1].startswith(mod + ".")
                     or q.split(":")[0].endswith("." + mod))]
        assert hits, suffix
    assert len(hot) > VERBATIM_SLICE
    # nothing of the analyzer itself is on the serving path
    assert not [q for q in hot if q.startswith("repro_torch.analysis")]


def test_call_graph_has_every_reference_edge():
    paths = [str(ROOT / "src" / "repro")]
    ref = RefContext([ref_astutil.load_file(p, ref_runner.module_name(p))
                      for p in ref_runner.iter_python_files(paths)]).graph
    port = AnalysisContext([astutil.load_file(p, runner.module_name(p))
                            for p in runner.iter_python_files(paths)]).graph
    assert set(port.functions) == set(ref.functions)
    missing = sorted((src, dst) for src, dsts in ref.edges.items()
                     for dst in dsts if dst not in port.edges[src])
    assert not missing, missing[:20]
    assert sum(map(len, ref.edges.values())) > 600
