"""The port's dry-run on the CPU: one subprocess traces the reference
test's cell (``mamba2-780m`` x ``decode_32k``), gemma-2b's
``decode_32k`` and a skipped cell over a fake world of 256 ranks
(``launch.mesh.init_fake_world``), as ``python -m
repro_torch.launch.dryrun`` would, each call through ``dryrun.main``.

The records carry the reference's keys; the traced cells are ``ok`` on
256 devices with FLOPs; the arguments' local bytes equal the
reference's ``device_bytes`` over its own specs (params under the
params rules, inputs and cache under the activation rules, on a fake
16 x 16 mesh); gemma-2b's FLOPs are within 5% of the closed form
``2 N B + 4 B T H D L`` (every weight once a token, the plain
attention's two products over the whole cache); the skipped cell's
reason is the reference's ``shape_applicable`` reason.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import shape_applicable as ref_shape_applicable  # noqa: E402
from repro.dist import sharding as ref_shd  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models.frontends import input_specs as ref_input_specs  # noqa: E402
from repro.models.params import ParamSpec as RefParamSpec  # noqa: E402
from repro.models.params import param_count as ref_param_count  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELLS = (("mamba2-780m", "decode_32k"), ("gemma-2b", "decode_32k"),
         ("gemma-2b", "long_500k"))
CODE = (
    "import sys\n"
    "from repro_torch.launch import dryrun\n"
    "for arch, shape in {cells!r}:\n"
    "    dryrun.main(['--arch', arch, '--shape', shape, '--out', "
    "sys.argv[1]])\n")


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "cells.jsonl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-c", CODE.format(cells=CELLS), str(out)],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [(r["arch"], r["shape"]) for r in recs] == list(CELLS)
    return {(r["arch"], r["shape"]): r for r in recs}


class FakeMesh:
    shape = {"data": 16, "model": 16}


def _reference_argument_bytes(arch: str, shape_name: str) -> int:
    cfg, shape = ref_get_config(arch), REF_SHAPES[shape_name]
    model = ref_build_model(cfg)
    rules = ref_shd.make_rules("serve")
    total = 0
    for specs, table in ((model.param_specs(), rules.params),
                         (ref_input_specs(cfg, shape), rules.acts),
                         (model.cache_specs(shape.global_batch,
                                            shape.seq_len), rules.acts)):
        pspecs = jax.tree_util.tree_map(
            lambda s: ref_shd.pspec_for(s.shape, s.axes, table, FakeMesh()),
            specs, is_leaf=lambda x: isinstance(x, RefParamSpec))
        total += ref_shd.device_bytes(pspecs, specs, FakeMesh())
    return total


@pytest.mark.parametrize("cell", CELLS[:2])
def test_traced_cell_is_ok_on_256_devices(records, cell):
    rec = records[cell]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["n_devices"] == 256 and rec["mesh"] == "16x16"
    assert rec["mode"] == "decode"
    assert rec["cost"]["flops"] > 0
    assert rec["trace_s"] >= 0 and rec["wall_s"] >= rec["trace_s"]
    assert "lower_s" not in rec and "temp_size_in_bytes" not in rec["memory"]
    coll = rec["collectives"]
    assert set(coll["counts"]) == {"all-gather", "all-reduce",
                                   "reduce-scatter", "all-to-all",
                                   "collective-permute"}
    assert sum(coll["counts"].values()) > 0
    assert coll["link_bytes_per_dev"] > 0


@pytest.mark.parametrize("cell", CELLS[:2])
def test_argument_bytes_are_the_reference_device_bytes(records, cell):
    mem = records[cell]["memory"]
    assert mem["argument_size_in_bytes"] == _reference_argument_bytes(*cell)
    assert mem["output_size_in_bytes"] > 0


def test_gemma_decode_flops_match_the_closed_form(records):
    cfg, shape = ref_get_config("gemma-2b"), REF_SHAPES["decode_32k"]
    n = ref_param_count(ref_build_model(cfg).param_specs())
    b, t = shape.global_batch, shape.seq_len
    closed = 2 * n * b + 4 * b * t * cfg.num_heads * cfg.head_dim * \
        cfg.num_layers
    flops = records[("gemma-2b", "decode_32k")]["cost"]["flops"]
    assert abs(flops / closed - 1.0) < 0.05, (flops, closed)


def test_skipped_cell_has_the_reference_reason(records):
    rec = records[("gemma-2b", "long_500k")]
    ok, reason = ref_shape_applicable(ref_get_config("gemma-2b"),
                                      REF_SHAPES["long_500k"])
    assert not ok
    assert rec == {"arch": "gemma-2b", "shape": "long_500k",
                   "mesh": "16x16", "mode": "decode", "status": "skipped",
                   "reason": reason}
