"""The correctness check, on the CPU at reduced sizes: the reference is
the program's model, a sound run passes, the fp8 control reads gaps
well above the program's, and a run whose timed path is broken
underneath comes out not correct, once for each fault a served cell can
have (one chip: no exchange between chips to leave out)."""
from __future__ import annotations

import json
import time

import bench_tiny
import numpy as np
import pytest
import torch

from veltair_bench import (cells, correct, harness, references, traffic,
                           weights)
from veltair_bench.system import System, port_config

# between the tiny cell's readings on the CPU: the program's widest gap
# 0.0053 at most over six seeds, the fp8 control's 0.020 at least
LIMIT = 0.012


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hw():
    from repro_torch.core import cost_model as cm
    return cm.H100_SXM


def _execute(prepare=None, seed=2**31 + 11):
    cell = bench_tiny.tiny_cell(limit=LIMIT)
    return harness.execute(cell, seed, 0.5, False, "cpu",
                           time.perf_counter(), hw=_hw(), prepare=prepare)


@pytest.mark.parametrize("model", ["starcoder2-3b", "mamba2-780m"])
def test_reference_is_the_programs_model(model):
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    spec = next(t for t in bench_tiny.tiny_cell().config["tenants"]
                if t["model"] == model)
    ref = references.load(spec["reference"])
    cfg = port_config(get_config(spec["port_config"]),
                      ref.port_fields(spec["config"]))
    params = weights.make(ref.layout(spec["config"]), 5, "cpu")
    toks = torch.randint(0, 256, (40,),
                         generator=torch.Generator().manual_seed(3))
    with torch.no_grad(), references.exact_fp32():
        prog = Model(cfg).full_logits(params, {"tokens": toks[None]})[0][0]
        want = ref.logits(params, toks, list(range(40)), spec["config"],
                          references.matmul_fp32)
        ctl = ref.logits(params, toks, list(range(40)), spec["config"],
                         references.matmul_fp8)
    err = (prog - want).abs().max().item()
    assert err < 0.03                    # bf16 rounding of the program
    assert (ctl - want).abs().max().item() > 3 * err


def test_sound_run_is_correct():
    result, checks, _, _, _ = _execute()
    assert result["correct"] and result["failed"] == 0
    assert set(checks) == {"failed_requests", "logit_gap.starcoder2-3b",
                           "logit_gap.mamba2-780m"}


def test_control_reads_wider_gaps_than_the_program():
    cell = bench_tiny.tiny_cell(limit=LIMIT)
    system = System(cell.config, 21, "cpu", hw=_hw())
    vocab = [(t.name, t.config["vocab_size"]) for t in system.tenants]
    reqs = traffic.generate(cell.traffic, vocab, 21, 0.5)
    system.serve(reqs, 21)
    system.free()
    for t in system.tenants:
        g = correct.gaps(t, correct.sample(reqs, t.name, 21), "cpu",
                         control=True)
        assert g["served"] <= LIMIT and g["control"] > 3 * g["served"], g


def test_the_control_in_the_programs_place_is_not_correct():
    cell = bench_tiny.tiny_cell(limit=LIMIT)
    system = System(cell.config, 23, "cpu", hw=_hw())
    vocab = [(t.name, t.config["vocab_size"]) for t in system.tenants]
    reqs = traffic.generate(cell.traffic, vocab, 23, 0.5)
    system.serve(reqs, 23)
    system.free()
    assert correct.passed(correct.check(system.tenants, reqs, 23, "cpu"))
    ctl = correct.check(system.tenants, reqs, 23, "cpu", control=True)
    assert not correct.passed(ctl), ctl


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      cells.benchmark()["workloads"]])
def test_committed_limits_part_the_chip_readings(workload):
    """Each tenant's limit in the configuration file lies above every
    sound run's reading on the card and below every control's, and the
    control, judged at those limits in the program's place, failed."""
    path = cells.HERE / "readings" / f"check.{workload}.json"
    got = json.loads(path.read_text())
    rows = got["rows"]
    assert len({r["seed"] for r in rows}) >= 12
    assert all(r["passed"] for r in rows)
    controls = [r for r in rows if "control_passed" in r]
    assert len(controls) >= 3
    assert not any(r["control_passed"] for r in controls)
    for t in cells.load(workload).config["tenants"]:
        limit = t["logit_gap_limit"]
        assert max(r[t["model"]]["served"] for r in rows) < limit
        assert min(r[t["model"]]["control"] for r in controls) > limit


def _token_altered(system):
    """The first token of every row's quantum block is changed on the
    device before the engine reads it."""
    for t in system.cluster:
        fin, vocab = t.engine.finish_quantum, t.engine.cfg.vocab_size

        def bad(handle, _fin=fin, _v=vocab):
            if handle is not None:
                handle.block[0] = (handle.block[0] + 1) % _v
            return _fin(handle)
        t.engine.finish_quantum = bad


def _state_unchanged(system):
    """A decode quantum leaves the cache (KV rows, SSM state) as it found
    it."""
    for t in system.cluster:
        eng = t.engine
        begin, fin = eng.begin_quantum, eng.finish_quantum
        saved = {}

        def b(k, *a, _begin=begin, _eng=eng, _saved=saved, **kw):
            _saved["cache"] = [x.clone()
                               for _, x in weights.leaves(_eng.cache)]
            return _begin(k, *a, **kw)

        def f(handle, _fin=fin, _eng=eng, _saved=saved):
            out = _fin(handle)
            if handle is not None:
                for (_, x), old in zip(weights.leaves(_eng.cache),
                                       _saved["cache"]):
                    x.copy_(old)
            return out
        eng.begin_quantum, eng.finish_quantum = b, f


def _half_batch_lost(system):
    """Half of the batch's rows lose their inputs in every decode quantum
    (they decode from token 0): the rows of one parity, alternating from
    quantum to quantum, so that every row is hit whatever its slot."""
    for t in system.cluster:
        inputs = t.engine._inputs
        push = inputs.push
        count = [0]

        def p(tokens, *a, _push=push, _count=count, **kw):
            if "n_left" in kw:
                tokens = np.array(tokens)
                tokens[_count[0] % 2::2] = 0
                _count[0] += 1
            return _push(tokens, *a, **kw)
        inputs.push = p


@pytest.mark.parametrize("fault", [_token_altered, _state_unchanged,
                                   _half_batch_lost])
def test_a_broken_timed_path_is_not_correct(fault):
    result, checks, _, _, _ = _execute(prepare=fault)
    assert not result["correct"], checks
