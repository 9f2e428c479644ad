"""The port's online runtime on a speculative engine against the JAX
package's, in virtual time: reduced gemma-2b with speculative quanta
(``speculative=True``, draft depth 4) under the SLO scheduler, whose
slack arithmetic reads the engine's ``expected_accept_per_step``, with
and without an ``AdmissionController``, through the parity check of
``tests/test_torch_runtime.py`` (identical schedule and level traces,
counter sources, records, metrics and engine counters; streams parting
only at reference near-ties).  A file of its own so that the test
runner's workers serve it beside the other runtime cases; the FIFO
schedules, which size no quantum by it, stay out for the suite's time.

The workload decodes 10 new tokens a request (the other cases decode 6):
the requests' own histories then recur, so the drafter drafts and verify
quanta run in both schedules, and the SLO scheduler reads a live
``expected_accept_per_step``.  The speculative counters and
the acceptance estimate must equal the JAX engine's.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_core import shared_executables  # noqa: E402
from test_torch_runtime import _clean_dispatch, \
    check_serve_matches_reference, models, plans  # noqa: E402,F401

CASES = {"gemma-2b-spec": ("gemma-2b", {"speculative": True})}
WORKLOAD = {"max_new_tokens": 10}


@pytest.mark.parametrize("schedule", ["slo", "slo-admission"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_virtual_time_serve_matches_reference(models, plans, case,
                                              schedule):
    runs = check_serve_matches_reference(models, plans, case, schedule,
                                         CASES, WORKLOAD)
    je, te = runs["jax"][0].engine, runs["torch"][0].engine
    assert te.spec_quanta > 0
    assert te.spec_stats == je.spec_stats
    assert te.expected_accept_per_step() == je.expected_accept_per_step()


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's small eager ops: as fast
    alone, and the test runner's workers share the cores (with a thread
    per core in each worker, the suite's runs took tens of times their
    solo time)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _shared_executables():
    """The JAX engines of this module share their compiled executables
    (``test_torch_core.SharedXla``): each case builds new engines, which
    would compile the same modules again."""
    yield from shared_executables()
