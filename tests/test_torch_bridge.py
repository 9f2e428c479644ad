"""The port's package boundary: parameter/cache tree parity with the JAX
package, the numpy bridge, import isolation, the device rule of its entry
points, and the static gate's view of the reference once the port sits
beside it in ``src/``."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_reduced_config as jax_reduced_config  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models.params import ParamSpec as JaxParamSpec  # noqa: E402
from repro.models.params import _path_str  # noqa: E402
from repro_torch.bridge import (cache_from_numpy, cache_to_numpy,  # noqa: E402
                                params_from_numpy)
from repro_torch.configs import get_config, get_reduced_config  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import (init_params, path_str,  # noqa: E402
                                       std_of, tree_leaves_with_path)
from repro_torch.serving.engine import ServingEngine  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
DTYPE_NAMES = {jnp.bfloat16: "bfloat16", jnp.float32: "float32"}


def _jax_spec_table(specs):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JaxParamSpec))
    return {_path_str(p): (tuple(s.shape), jnp.dtype(s.dtype).name,
                           tuple(s.axes), s.init)
            for p, s in flat}


def _torch_spec_table(specs):
    return {path_str(p): (tuple(s.shape), str(s.dtype).split(".")[-1],
                          tuple(s.axes), s.init)
            for p, s in tree_leaves_with_path(specs)}


@pytest.mark.parametrize("arch", ["gemma-2b", "starcoder2-3b",
                                  "mamba2-780m"])
@pytest.mark.parametrize("reduced", [True, False])
def test_param_and_cache_specs_match_reference(arch, reduced):
    """Paths, shapes, dtypes, axes and initializers, at full width too
    (specs only; nothing is allocated)."""
    jcfg = (jax_reduced_config if reduced else jax_get_config)(arch)
    tcfg = (get_reduced_config if reduced else get_config)(arch)
    jmodel, tmodel = build_model(jcfg), Model(tcfg)
    assert _torch_spec_table(tmodel.param_specs()) == \
        _jax_spec_table(jmodel.param_specs())
    assert _torch_spec_table(tmodel.cache_specs(3, 64)) == \
        _jax_spec_table(jmodel.cache_specs(3, 64))


def test_bridge_round_trip_is_exact():
    jmodel = build_model(jax_reduced_config("gemma-2b"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    np_tree = jax.tree_util.tree_map(np.asarray, jparams)
    tparams = params_from_numpy(np_tree, device="cpu")
    flat, _ = jax.tree_util.tree_flatten_with_path(jparams)
    back = dict((path_str(p), t) for p, t in tree_leaves_with_path(tparams))
    assert set(back) == {_path_str(p) for p, _ in flat}
    for p, leaf in flat:
        t = back[_path_str(p)]
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype).split(".")[-1] == jnp.dtype(leaf.dtype).name
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(leaf, np.float32))
    # a bf16 KV cache crosses both ways unchanged
    jcache = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.random.default_rng(0).standard_normal(
            a.shape), jnp.bfloat16), jmodel.init_cache(2, 8))
    tcache = cache_from_numpy(jax.tree_util.tree_map(np.asarray, jcache),
                              device="cpu")
    assert tcache["blocks"]["dense"]["k"].dtype == torch.bfloat16
    out = cache_to_numpy(tcache)
    np.testing.assert_array_equal(
        out["blocks"]["dense"]["v"],
        np.asarray(jcache["blocks"]["dense"]["v"], np.float32))


def test_bridge_asks_its_caller_for_a_device():
    """The port runs on the card unless its caller asks for the CPU, so
    the bridge has no default device."""
    tree = {"w": np.zeros((2, 3), np.float32)}
    for fn in (params_from_numpy, cache_from_numpy):
        with pytest.raises(TypeError):
            fn(tree)
    assert params_from_numpy(tree, device="cpu")["w"].device.type == "cpu"


def test_init_params_follows_the_reference_distribution():
    tmodel = Model(get_reduced_config("gemma-2b"))
    specs = tmodel.param_specs()
    a = init_params(specs, torch.Generator().manual_seed(3), "cpu")
    b = init_params(specs, torch.Generator().manual_seed(3), "cpu")
    spec_of = dict((path_str(p), s) for p, s in tree_leaves_with_path(specs))
    for p, leaf in tree_leaves_with_path(a):
        spec = spec_of[path_str(p)]
        other = b
        for key in p:
            other = other[key]
        assert torch.equal(leaf, other), "same seed, same tree"
        assert leaf.dtype == spec.dtype and tuple(leaf.shape) == spec.shape
        if spec.init == "ones":
            assert torch.all(leaf == 1)
        elif spec.init == "zeros":
            assert torch.all(leaf == 0)
        else:
            std = leaf.float().std().item()
            assert abs(std / std_of(spec) - 1.0) < 0.1, (p, std)
    assert std_of(spec_of["embed/embedding"]) == 0.02
    # stacked layers: fan-in excludes the leading layer axis
    assert std_of(spec_of["blocks/dense/mlp/w_down"]) == 256 ** -0.5


def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'repro.')) or m == 'repro')\n"
        "assert not bad, bad\n"
        "new = ('repro_torch.serving.cluster', 'repro_torch.serving.tenants', "
        "'repro_torch.core.profiles', 'repro_torch.configs', "
        "'repro_torch.analysis.callgraph', 'repro_torch.launch.serve', "
        "'repro_torch.examples.quickstart', "
        "'repro_torch.examples.adaptive_compilation_demo', "
        "'repro_torch.examples.tpu_pod_serving', "
        "'repro_torch.examples.train_lm', "
        "'repro_torch.examples.multi_tenant_serving')\n"
        "assert all(m in sys.modules for m in new), new\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 30       # every module was imported


def test_engine_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    cfg = get_reduced_config("gemma-2b")
    tmodel = Model(cfg)
    params = tmodel.init(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(cfg, params, batch_slots=1, max_len=16)
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(cfg, params, batch_slots=1, max_len=16,
                      device="cuda")
    eng = ServingEngine(cfg, params, batch_slots=1, max_len=16, device="cpu")
    assert eng.device.type == "cpu"


def _reference_hot_slice(path):
    from repro.analysis import astutil
    from repro.analysis.base import AnalysisContext
    from repro.analysis.rules_hotpath import HOT_ROOTS
    from repro.analysis.runner import iter_python_files, module_name
    files = [astutil.load_file(p, module_name(p))
             for p in iter_python_files([str(path)])]
    graph = AnalysisContext(files).graph
    ref_dir = (ROOT / "src" / "repro").resolve()
    ref = {q for q, info in graph.functions.items()
           if ref_dir in pathlib.Path(info.sf.path).resolve().parents}
    roots = [q for s in HOT_ROOTS for q in graph.find(s) if q in ref]
    return {q for q in graph.reachable(roots) if q in ref}


def test_reference_hot_path_slice_unchanged_by_the_port():
    """The static gate scans all of ``src/``: the port's classes and
    methods must not make the reference's call graph resolve
    differently (a shrunken slice would audit less of the reference)."""
    alone = _reference_hot_slice(ROOT / "src" / "repro")
    together = _reference_hot_slice(ROOT / "src")
    assert len(alone) > 100
    assert together == alone, (sorted(alone - together),
                               sorted(together - alone))


def test_bridge_round_trip_carries_the_ssm_leaves():
    """The fp32 leaves of the Mamba-2 mixer (conv_w, conv_b, A_log,
    dt_bias, D, the gated norm's scale) cross as fp32, the bf16
    projections as bf16, every value exact; the fp32 SSD state and the
    bf16 conv state of a cache cross both ways unchanged."""
    jmodel = build_model(jax_reduced_config("mamba2-780m"))
    jparams = jmodel.init(jax.random.PRNGKey(2))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    flat, _ = jax.tree_util.tree_flatten_with_path(jparams)
    back = dict((path_str(p), t) for p, t in tree_leaves_with_path(tparams))
    assert set(back) == {_path_str(p) for p, _ in flat}
    fp32 = {"conv_w", "conv_b", "A_log", "dt_bias", "D", "scale"}
    for p, leaf in flat:
        t = back[_path_str(p)]
        name = _path_str(p).rsplit("/", 1)[-1]
        assert t.dtype == (torch.float32 if name in fp32 else
                           torch.bfloat16), _path_str(p)
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(leaf, np.float32))
    rng = np.random.default_rng(0)
    jcache = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype),
        jmodel.init_cache(2, 8))
    tcache = cache_from_numpy(jax.tree_util.tree_map(np.asarray, jcache),
                              device="cpu")
    assert tcache["blocks"]["ssm"]["ssd"].dtype == torch.float32
    assert tcache["blocks"]["ssm"]["conv"].dtype == torch.bfloat16
    out = cache_to_numpy(tcache)
    for name in ("conv", "ssd"):
        np.testing.assert_array_equal(
            out["blocks"]["ssm"][name],
            np.asarray(jcache["blocks"]["ssm"][name], np.float32))


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
