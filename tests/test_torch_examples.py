"""The port's examples (``repro_torch.examples``) against the JAX
package's (``examples/*.py``, each loaded by path) on the CPU.

* ``adaptive_compilation_demo``: the printed lines equal, and the port's
  tile overrides cleared after the run (each level's clamped tile
  installed on the way);
* ``tpu_pod_serving`` and ``multi_tenant_serving``'s simulator table:
  every policy's ``qos_rate`` at every offered load equal (the reference's
  read off its ``Simulator.run`` results);
* ``quickstart``: on the reference's own reduced gemma-2b weights
  (``init(PRNGKey(0))``, bridged), every request's tokens equal to the
  reference's, the speculative pass identical, with equal ``spec_stats``;
* ``multi_tenant_serving.online_engine_demo``: the ``compare_metrics``
  rows (simulator beside engine, virtual time) equal, NaN-aware;
* ``train_lm``: five steps from the reference loop's initial state,
  bridged, within TRAJECTORY_RTOL of the reference's losses;
* every ``main()`` without ``--device cpu`` raises here (no card).
"""
import importlib
import importlib.util
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.training.train_loop as ref_train_loop  # noqa: E402
from repro.configs import get_reduced_config as jax_reduced_config  # noqa: E402
from repro.configs.paper_suite import WORKLOAD_CLASSES as REF_CLASSES  # noqa: E402
from repro.configs.paper_suite import paper_models as ref_paper_models  # noqa: E402
from repro.core import cost_model as ref_cm  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.serving import build_paper_plans as ref_build_paper_plans  # noqa: E402
from repro_torch.bridge import params_from_numpy, \
    train_state_from_numpy  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.configs.paper_suite import WORKLOAD_CLASSES, \
    paper_models  # noqa: E402
from repro_torch.core import cost_model as cm  # noqa: E402
from repro_torch.examples import adaptive_compilation_demo, \
    multi_tenant_serving, quickstart, tpu_pod_serving, train_lm  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.serving import build_paper_plans  # noqa: E402
import repro_torch.training.train_loop as port_train_loop  # noqa: E402
from test_torch_core import same  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "adaptive_compilation_demo", "tpu_pod_serving",
            "train_lm", "multi_tenant_serving")
# the loss over five whole steps against the reference's, as
# ``test_torch_training.test_loss_trajectory_follows_reference`` holds it
TRAJECTORY_RTOL = 5e-3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's small eager ops: as fast
    alone, and the test runner's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference(name: str):
    """``examples/<name>.py`` of the JAX package as a fresh module."""
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _RecordingSimulator:
    """Stands in for a reference example's ``Simulator``: runs the real
    one and records each run's ``qos_rate`` in order."""

    def __init__(self, real, rates: list):
        self.real, self.rates = real, rates

    def __call__(self, *args, **kw):
        sim = self.real(*args, **kw)
        run = sim.run

        def recorded(wl):
            m = run(wl)
            self.rates.append(m.qos_rate)
            return m
        sim.run = recorded
        return sim


def _bridged_gemma():
    params = build_model(jax_reduced_config("gemma-2b")).init(
        jax.random.PRNGKey(0))
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                             device="cpu")


def test_adaptive_compilation_demo_prints_the_reference_lines(capsys):
    _reference("adaptive_compilation_demo").main()
    want = capsys.readouterr().out
    out = adaptive_compilation_demo.main(["--device", "cpu"])
    assert capsys.readouterr().out == want
    assert len(out["overrides"]) == len(adaptive_compilation_demo.LEVELS)
    for sel, tiles in zip(out["selected"], out["overrides"]):
        bm, bk, bn = sel["tile"]
        assert tiles == {"bm": min(bm, 256), "bk": min(bk, 512),
                         "bn": min(bn, 256)}
    assert dispatch.tile_overrides("matmul") == {}


def test_tpu_pod_serving_rates_equal_the_reference():
    ref = _reference("tpu_pod_serving")
    rates: list = []
    ref.Simulator = _RecordingSimulator(ref.Simulator, rates)
    ref.main()
    out = tpu_pod_serving.main(["--device", "cpu"])
    got = [r for label in out["rates"] for r in out["rates"][label]]
    assert len(got) == 9
    assert got == rates


def test_multi_tenant_policy_table_equals_the_reference():
    ref = _reference("multi_tenant_serving")
    rates: list = []
    ref.Simulator = _RecordingSimulator(ref.Simulator, rates)
    models = list(REF_CLASSES["mix"])
    assert list(WORKLOAD_CLASSES["mix"]) == models
    rpm, pm = ref_paper_models(), paper_models()
    ref.sim_policy_table(ref_cm.CPU_3990X,
                         ref_build_paper_plans(models, ref_cm.CPU_3990X),
                         models, [1.0 / rpm[m].qos_ms for m in models])
    table = multi_tenant_serving.policy_table(
        cm.CPU_3990X, build_paper_plans(models, cm.CPU_3990X), models,
        [1.0 / pm[m].qos_ms for m in models])
    got = [r for label in table for r in table[label]]
    assert len(got) == 18
    assert got == rates


def test_quickstart_serves_the_reference_tokens():
    ref = _reference("quickstart")
    served = []
    serve = ref.serve

    def recorded(engine, requests):
        served.append((engine, requests))
        return serve(engine, requests)
    ref.serve = recorded
    ref.main()
    (_, want), (spec_engine, spec_want) = served
    out = quickstart.quickstart_passes(get_reduced_config("gemma-2b"),
                                       _bridged_gemma(), "cpu")
    assert [r.output for r in out["requests"]] == [r.output for r in want]
    assert [r.output for r in out["spec_requests"]] == \
        [r.output for r in spec_want]
    assert out["identical"]
    assert out["spec_stats"] == spec_engine.spec_stats
    assert out["tokens"] == len(want) * (quickstart.MAX_NEW + 1)


def test_online_engine_demo_rows_equal_the_reference():
    ref = _reference("multi_tenant_serving")
    rows = []
    compare = ref.compare_metrics

    def recorded(a, b):
        rows.append(compare(a, b))
        return rows[-1]
    ref.compare_metrics = recorded
    ref.online_engine_demo(ref_cm.CPU_3990X)
    out = multi_tenant_serving.online_engine_demo(
        cm.CPU_3990X, get_reduced_config("gemma-2b"), _bridged_gemma(),
        "cpu")
    assert len(rows) == 1
    assert same(out["rows"], rows[0])
    assert out["level_switches"] > 0


def test_train_lm_follows_the_reference(monkeypatch):
    states = []
    init = ref_train_loop.init_train_state

    def recorded(*args, **kw):
        state = init(*args, **kw)
        # a copy now: the reference's step donates the state's buffers
        states.append(jax.tree_util.tree_map(np.array, state))
        return state
    monkeypatch.setattr(ref_train_loop, "init_train_state", recorded)
    ref = _reference("train_lm")
    losses = []
    loop = ref.train_loop

    def recorded_loop(*args, **kw):
        losses.append(loop(*args, **kw)["losses"])
        return {"losses": losses[-1]}
    ref.train_loop = recorded_loop
    monkeypatch.setattr(sys, "argv", ["train_lm.py", "--steps", "5"])
    ref.main()
    bridged = train_state_from_numpy(states[0], device="cpu")
    monkeypatch.setattr(port_train_loop, "make_train_state",
                        lambda *args, **kw: bridged)
    out = train_lm.main(["--steps", "5", "--device", "cpu"])
    got, want = out["losses"], losses[0]
    assert [s for s, _ in got] == [s for s, _ in want] == [0, 4]
    np.testing.assert_allclose([l for _, l in got], [l for _, l in want],
                               rtol=TRAJECTORY_RTOL)
    assert got[-1][1] < got[0][1]
    assert int(out["state"]["step"]) == 5


@pytest.mark.parametrize("name", EXAMPLES)
def test_main_runs_on_the_card_by_default(name):
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        mod.main([])
