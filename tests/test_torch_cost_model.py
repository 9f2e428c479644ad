"""The port's H100 hardware model and GPU version space, and its copies of
the reference's layer profiles and LM plans.

* ``H100_SXM``'s SM-unit version space yields only tiles the port's
  ``block_matmul`` kernel is built for, clipped as the kernel clips
  them, at every layer of the three co-located tenants;
* the CPU and TPU spaces, the layer profiles (``lm_layers``,
  ``model_flops``), ``get_shape`` and ``make_plan`` give the reference's
  values exactly, and ``cluster_plan`` / ``lm_plan`` the reference's plans
  field for field (NaN-aware: ``test_torch_core.same``);
* an engine given version sets selects the reference engine's tiles at
  every level; ``hardware_spec_for`` names no spec for the CPU.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as r_get_config  # noqa: E402
from repro.configs import get_reduced_config as jax_reduced_config  # noqa: E402
from repro.configs import get_shape as r_get_shape  # noqa: E402
from repro.configs import paper_suite as r_suite  # noqa: E402
from repro.core import cost_model as r_cm  # noqa: E402
from repro.core import profiles as r_prof  # noqa: E402
from repro.core import schedule_space as r_ss  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models.model import make_plan as r_make_plan  # noqa: E402
from repro.serving import engine as jax_engine  # noqa: E402
from repro.serving import tenants as r_ten  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config, get_reduced_config  # noqa: E402
from repro_torch.configs import get_shape, paper_suite  # noqa: E402
from repro_torch.core import cost_model as t_cm  # noqa: E402
from repro_torch.core import profiles as t_prof  # noqa: E402
from repro_torch.core import schedule_space as t_ss  # noqa: E402
from repro_torch.kernels import block_matmul  # noqa: E402
from repro_torch.models.model import make_plan  # noqa: E402
from repro_torch.serving import engine as torch_engine  # noqa: E402
from repro_torch.serving import tenants as t_ten  # noqa: E402
from test_torch_core import same  # noqa: E402

TENANTS = ("gemma-2b", "starcoder2-3b", "mamba2-780m")
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def test_sm_tile_choices_are_the_kernels():
    assert t_ss.SM_BM_CHOICES == block_matmul.BM_CHOICES
    assert t_ss.SM_BN_CHOICES == block_matmul.BN_CHOICES
    assert t_ss.SM_BK_CHOICES == block_matmul.BK_CHOICES


def test_h100_spec_is_the_cards():
    hw = t_cm.H100_SXM
    assert (hw.unit, hw.n_units) == ("sm", 132) == ("sm", block_matmul.SMS)
    assert hw.flops_per_unit * hw.n_units == pytest.approx(989e12)
    assert hw.private_cache_bytes == 232_448
    assert hw.cache_shared and hw.shared_bw == 3.35e12 and hw.link_bw == 0
    tpu = t_cm.TPU_V5E_POD
    assert (hw.eff_base, hw.eff_slope, hw.eff_min, hw.eff_max) == \
        (tpu.eff_base, tpu.eff_slope, tpu.eff_min, tpu.eff_max)
    assert 0 < hw.realloc_overhead_s < 1e-3
    assert 0 < hw.serial_overhead_s < 1e-4
    with pytest.raises(ValueError):
        t_cm.hardware_spec_for("cpu")


@pytest.mark.parametrize("arch", TENANTS)
def test_sm_space_yields_only_built_tiles(arch):
    hw = t_cm.H100_SXM
    for shape in SHAPES:
        for layer in t_prof.lm_layers(get_config(arch), get_shape(shape)):
            vs = t_ss.enumerate_versions(layer, hw)
            assert vs
            for v in vs:
                assert v.bm in block_matmul.BM_CHOICES
                assert v.bn in block_matmul.BN_CHOICES
                assert v.bk in block_matmul.BK_CHOICES
                assert v.unroll == 1
                assert v.tile_bytes <= hw.private_cache_bytes
                # the tile is one the kernel would run at this shape
                assert block_matmul.effective_tiles(
                    layer.m, layer.k, layer.n, v.bm, v.bk, v.bn) == \
                    (v.bm, v.bk, v.bn)
    plan = t_ten.cluster_plan(arch, hw)
    assert plan.qos_s > 0
    for vset in plan.version_sets:
        for i in range(t_cm.NUM_LEVELS):
            v = vset.select(t_cm.level_interference(t_cm.grid_point(i)))
            assert (v.bm, v.bk, v.bn) in {
                (m, k, n) for m in block_matmul.BM_CHOICES
                for k in block_matmul.BK_CHOICES
                for n in block_matmul.BN_CHOICES}


def test_sm_space_clips_like_the_kernel():
    """A 4 x 40 x 24 problem: bm clips to the least built tile (16, not
    ``min(t, dim)`` = 4), bk to 64, bn to 32."""
    layer = t_cm.GemmLayer(name="small", m=4, k=40, n=24, itemsize=2)
    tiles = {(v.bm, v.bk, v.bn)
             for v in t_ss.enumerate_versions(layer, t_cm.H100_SXM)}
    assert tiles == {(16, 32, 32), (16, 64, 32)}


def _lm_layer_pairs():
    for arch in TENANTS:
        for shape in SHAPES:
            yield (r_prof.lm_layers(r_get_config(arch), r_get_shape(shape)),
                   t_prof.lm_layers(get_config(arch), get_shape(shape)))


def test_profiles_shapes_and_plans_match_reference():
    for name in SHAPES:
        assert dataclasses.asdict(get_shape(name)) == \
            dataclasses.asdict(r_get_shape(name))
    with pytest.raises(KeyError):
        get_shape("decode_1m")
    for arch in TENANTS:
        cfg, rcfg = get_config(arch), r_get_config(arch)
        assert dataclasses.asdict(make_plan(cfg)) == \
            dataclasses.asdict(r_make_plan(rcfg))
        assert t_prof.lm_layer_kinds(cfg) == r_prof.lm_layer_kinds(rcfg)
        for shape in SHAPES:
            assert t_prof.model_flops(cfg, get_shape(shape)) == \
                r_prof.model_flops(rcfg, r_get_shape(shape))
            for kind in ("dense", "ssm"):
                if (kind == "ssm") == (cfg.ssm is not None):
                    assert t_prof._layer_flops(cfg, 128, 4096, kind) == \
                        r_prof._layer_flops(rcfg, 128, 4096, kind)
    for rl, tl in _lm_layer_pairs():
        assert same(tl, rl)


@pytest.mark.parametrize("hw_name", ["cpu", "tpu"])
def test_cpu_and_tpu_spaces_match_reference(hw_name):
    rhw, thw = ((r_cm.CPU_3990X, t_cm.CPU_3990X) if hw_name == "cpu"
                else (r_cm.TPU_V5E_POD, t_cm.TPU_V5E_POD))
    pairs = [(list(r_suite.paper_models()[m].layers),
              list(paper_suite.paper_models()[m].layers))
             for m in sorted(r_suite.paper_models())]
    pairs += list(_lm_layer_pairs())
    n = 0
    for rls, tls in pairs:
        for rl, tl in zip(rls, tls):
            assert same(t_ss.enumerate_versions(tl, thw),
                        r_ss.enumerate_versions(rl, rhw))
            n += 1
    assert n > 100


@pytest.mark.parametrize("arch", TENANTS)
def test_cluster_and_lm_plans_match_reference(arch):
    assert same(t_ten.cluster_plan(arch, t_cm.CPU_3990X),
                r_ten.cluster_plan(arch, r_cm.CPU_3990X))
    assert same(t_ten.cluster_plan(arch, t_cm.TPU_V5E_POD, qos_scale=2.0),
                r_ten.cluster_plan(arch, r_cm.TPU_V5E_POD, qos_scale=2.0))
    spec = [(arch, "decode_32k", 50.0)]
    t_plans = t_ten.lm_serving_plans(spec)
    assert same(t_plans, r_ten.lm_serving_plans(spec))
    assert same(t_ten.engine_version_sets(t_plans),
                r_ten.engine_version_sets(r_ten.lm_serving_plans(spec)))


# the configs registered with the dense-residual MoE: their layer kinds
# (``moe_arctic``; dense at MHA and at G 16), profiles and plans
LATE_ARCHS = ("arctic-480b", "minicpm-2b", "llama3-405b")


@pytest.mark.parametrize("arch", LATE_ARCHS)
def test_late_configs_plans_match_reference(arch):
    cfg, rcfg = get_config(arch), r_get_config(arch)
    assert dataclasses.asdict(make_plan(cfg)) == \
        dataclasses.asdict(r_make_plan(rcfg))
    assert t_prof.lm_layer_kinds(cfg) == r_prof.lm_layer_kinds(rcfg)
    assert same(t_ten.cluster_plan(arch, t_cm.CPU_3990X),
                r_ten.cluster_plan(arch, r_cm.CPU_3990X))
    spec = [(arch, "decode_32k", 50.0)]
    t_plans = t_ten.lm_serving_plans(spec)
    assert same(t_plans, r_ten.lm_serving_plans(spec))
    assert same(t_ten.engine_version_sets(t_plans),
                r_ten.engine_version_sets(r_ten.lm_serving_plans(spec)))


def test_engine_selects_the_reference_engines_tiles():
    """Both engines over their package's CPU plan: the dominant layer's
    table gives the same ``{"matmul": ...}`` tiles at every level; the
    port's CPU engine takes tiles its kernel is not built for (the plain
    version ignores them), runs on no stream, and reports the reference's
    speculative-counter keys."""
    arch = "gemma-2b"
    jcfg = jax_reduced_config(arch)
    jparams = build_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    rplan = r_ten.cluster_plan(arch, r_cm.CPU_3990X)
    tplan = t_ten.cluster_plan(arch, t_cm.CPU_3990X)
    je = jax_engine.ServingEngine(jcfg, jparams, batch_slots=2, max_len=32,
                                  version_sets=rplan.version_sets)
    te = torch_engine.ServingEngine(get_reduced_config(arch), tparams,
                                    batch_slots=2, max_len=32, device="cpu",
                                    version_sets=tplan.version_sets)
    levels = [t_cm.grid_point(i) for i in range(t_cm.NUM_LEVELS)]
    levels += [0.0, 0.33, 0.71, 1.0]
    seen = set()
    for lv in levels:
        got = te.tiles_for_level(lv)
        assert got == je.tiles_for_level(lv)
        assert got == te.set_interference_level(lv)
        seen.add(str(got))
    assert len(seen) > 1
    assert any(v.bk not in block_matmul.BK_CHOICES
               for v in te._tile_source.versions)
    assert te.stream is None
    assert te.spec_stats.keys() == je.spec_stats.keys()
    assert all(v == 0 for v in te.spec_stats.values())


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


# the frontend configs (vlm and audio families, planned as dense blocks):
# their layer kinds, profiles and plans
FRONTEND_ARCHS = ("qwen2-vl-2b", "musicgen-large")


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_frontend_configs_plans_match_reference(arch):
    test_late_configs_plans_match_reference(arch)
    assert t_prof.lm_layer_kinds(get_config(arch)) == \
        ["dense"] * get_config(arch).num_layers
