"""The roofline and model-FLOP counts against hand-computed values at one
shape of each kernel, at the configurations' published widths."""
from __future__ import annotations

import numpy as np
import pytest

from veltair_bench import cells, harness, references, roofline
from veltair_bench.calls import Chunk, Quantum
from veltair_bench.system import Served, Tenant

COLO = cells.load("colo.batch").config["tenants"]
SC2 = COLO[0]["config"]
MB2 = COLO[1]["config"]
sc2 = references.load("starcoder2")
mb2 = references.load("mamba2")


def test_b1_at_a_decode_step():
    # 16 rows through starcoder2-3b's up projection, 3072 -> 12288
    flops, nbytes = roofline.matmul(16, 3072, 12288)
    assert flops == 2 * 16 * 3072 * 12288 == 1_207_959_552
    assert nbytes == 2 * (16 * 3072 + 3072 * 12288 + 16 * 12288)
    # bytes bind: 75.98 MB at 3.35 TB/s
    assert roofline.least_s(flops, nbytes) == pytest.approx(
        75_988_992 / 3.35e12)


def test_b2_at_a_chunk_and_a_decode_step():
    # a 16-row chunk from position 100: rows attend 101..116 keys
    work = sc2.kernel_work(SC2, ("chunk", 16, 100))
    f, b = work["b2"][0]
    assert f == 4 * 24 * 128 * sum(range(101, 117))
    assert b == 2 * (2 * 16 * 24 * 128 + 2 * 116 * 2 * 128)
    assert len(work["b2"]) == 30 and len(work["b1"]) == 60
    # a decode step: each row its own sequence of kv_lens[i] keys
    f, b = sc2.kernel_work(SC2, ("decode", [1, 300]))["b2"][0]
    assert f == 4 * 24 * 128 * 301
    assert b == 2 * (2 * 2 * 24 * 128 + 2 * 301 * 2 * 128)


def test_b4_at_a_chunk():
    f, b = mb2.kernel_work(MB2, ("chunk", 16, 0))["b4"][0]
    h, p, n = 48, 64, 128
    assert f == h * (16 * 17 // 2 * (2 * n + 2 * p) + 4 * 16 * p * n)
    assert b == 16 * (h * (2 * p * 2 + 4) + 2 * n * 2) + h * 4 \
        + h * p * n * 4 * 2
    assert len(mb2.kernel_work(MB2, ("chunk", 16, 0))["b4"]) == 48
    assert mb2.kernel_work(MB2, ("chunk", 1, 5)) == {}
    assert mb2.kernel_work(MB2, ("decode", [3, 4])) == {}


def test_model_flops_of_a_token():
    per_layer = 2 * (2 * 3072 * 3072 + 2 * 3072 * 256 + 2 * 3072 * 12288)
    assert sc2.token_flops(SC2, 0) == 30 * (per_layer + 4 * 24 * 128)
    assert sc2.head_flops(SC2) == 2 * 3072 * 49152
    proj = 2 * 1536 * (2 * 3072 + 2 * 128 + 48) + 2 * 3072 * 1536
    conv = 2 * 4 * (3072 + 256)
    assert mb2.token_flops(MB2, 7) == 48 * (proj + conv + 4 * 48 * 64 * 128)


def _run(quanta, chunks, reqs=()):
    served = Served(reqs=list(reqs), t_open=0.0, t_close=2.0, ticks=1,
                    inside_s=0.0, held_s=0.0, chunks=chunks, quanta=quanta,
                    tokens={}, syncs={})
    t = Tenant("starcoder2-3b", sc2, SC2, None, {})
    return harness.Run(cells.load("colo.batch"), [t], served, {}, None)


def test_least_time_and_mfu_over_dispatches():
    # one traced 2-step quantum over 2 slots, row 0 live for 1 step from
    # position 10, row 1 frozen at 4; one traced 2-row chunk from 0
    q = Quantum("starcoder2-3b", 2, np.array([10, 4]), np.array([1, 0]),
                True)
    c = Chunk("starcoder2-3b", 2, 0, 2, True)
    run = _run([q], [c])
    least, launches = run.kernel_least("b2")
    assert launches == 3 * 30
    steps = [[11, 5], [12, 5]]          # step j: pos + min(j, n_left) + 1
    want = sum(roofline.least_s(*roofline.attention(
        [[x] for x in kv], 24, 2, 128)) for kv in steps) * 30
    want += roofline.least_s(*roofline.attention([[1, 2]], 24, 2, 128)) * 30
    assert least == pytest.approx(want)
    # model FLOPs: the chunk's tokens at 0 and 1, row 0's token at 10
    flops = run.model_flops()
    assert flops == pytest.approx(sc2.token_flops(SC2, 0)
                                  + sc2.token_flops(SC2, 1)
                                  + sc2.token_flops(SC2, 10))
