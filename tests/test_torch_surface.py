"""The port's package surface against the JAX package on the CPU.

``repro_torch.serving``, ``.models`` and ``.core`` export the reference
packages' ``__all__`` (``core`` adds the card's ``H100_SXM``), each
reference name bound to the port's object; the functions the port
lacked until its surface was filled in (``all_cells``,
``qos_inverse_weights``, ``pca_variance``, ``abstract_params``,
``abstract_inputs``, ``build_model``, ``LadderSpec``) agree with the
reference's on the same inputs; and ``launch.serve.main`` serves the
reference's prompt recipe on the CPU, token for token as an engine
built directly on the same weights, and refuses to run off the card
unless asked for the CPU.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as ref_core  # noqa: E402
import repro.models as ref_models  # noqa: E402
import repro.serving as ref_serving  # noqa: E402
from repro.configs import all_cells as ref_all_cells  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import get_shape as ref_get_shape  # noqa: E402
from repro.core import cost_model as ref_cm  # noqa: E402
from repro.core.multiversion import LadderSpec as RefLadderSpec  # noqa: E402
from repro.serving.request import qos_inverse_weights as ref_qos  # noqa: E402
import repro_torch.core as core  # noqa: E402
import repro_torch.models as models  # noqa: E402
import repro_torch.serving as serving  # noqa: E402
from repro_torch.configs import all_cells, get_config, get_reduced_config, \
    get_shape  # noqa: E402
from repro_torch.core.multiversion import LadderSpec  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.params import path_str, \
    tree_leaves_with_path  # noqa: E402
from repro_torch.serving.engine import Request, \
    TorchServingEngine  # noqa: E402

# names the port exports beyond the reference's
EXTRA = {"core": {"H100_SXM"}, "models": set(), "serving": set()}
PACKAGES = {"core": (core, ref_core), "models": (models, ref_models),
            "serving": (serving, ref_serving)}
# abstract trees: a dense, an MoE, an ssm, a hybrid and a frontend config
ARCHS = ["gemma-2b", "deepseek-v2-lite-16b", "mamba2-780m",
         "recurrentgemma-2b", "qwen2-vl-2b", "llama3-405b"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the test runner's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


@pytest.mark.parametrize("name", sorted(PACKAGES))
def test_exports_are_the_references(name):
    port, ref = PACKAGES[name]
    assert set(port.__all__) == set(ref.__all__) | EXTRA[name]
    assert len(port.__all__) == len(set(port.__all__))
    for export in port.__all__:
        obj = getattr(port, export)
        mod = getattr(obj, "__module__", None)
        assert mod is None or not mod.startswith("repro."), (export, mod)


def test_exports_bind_the_port_objects():
    assert serving.ServingEngine is TorchServingEngine
    assert type(models.build_model(get_config("gemma-2b"))) is models.Model
    assert models.Model.__name__ == "TorchModel"
    assert isinstance(core.H100_SXM, core.HardwareSpec)
    assert serving.TRASH_PAGE == ref_serving.TRASH_PAGE
    assert serving.QUANTUM_BUCKETS == ref_serving.QUANTUM_BUCKETS
    assert serving.PREFILL_CHUNK_LEN == ref_serving.PREFILL_CHUNK_LEN
    assert core.CPU_3990X.name == ref_core.CPU_3990X.name
    assert core.TPU_V5E_POD.name == ref_core.TPU_V5E_POD.name


@pytest.mark.parametrize("include_skipped", [False, True])
def test_all_cells_are_the_references(include_skipped):
    port = list(all_cells(include_skipped))
    assert port == list(ref_all_cells(include_skipped))
    assert all(ok for _, _, ok, _ in port) != include_skipped
    assert len(port) == 40 or not include_skipped


def test_qos_inverse_weights_and_pca_variance_agree():
    qos = {"resnet50": 15.0, "googlenet": 10.0, "bert": 50.0, "ssd": 7.5}
    np.testing.assert_allclose(serving.qos_inverse_weights(qos),
                               ref_qos(qos), rtol=0, atol=1e-6)
    rng = np.random.default_rng(0)
    counters = rng.standard_normal((64, 6)) @ rng.standard_normal((6, 6))
    got = core.pca_variance(counters)
    want = ref_core.pca_variance(counters)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert abs(got.sum() - 1.0) < 1e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_are_the_references_on_meta(arch):
    """Full configs: on the meta device nothing is allocated (llama3-405b
    is 810 GB of bf16)."""
    specs = models.build_model(get_config(arch)).param_specs()
    tree = models.abstract_params(specs)
    ref_tree = ref_models.abstract_params(
        ref_models.build_model(ref_get_config(arch)).param_specs())
    ref = {"/".join(str(getattr(k, "key", k)) for k in path):
           (tuple(leaf.shape), jnp.dtype(leaf.dtype).name)
           for path, leaf in jax.tree_util.tree_flatten_with_path(
               ref_tree)[0]}
    got = {}
    for path, leaf in tree_leaves_with_path(tree):
        assert leaf.device.type == "meta"
        got[path_str(path)] = (tuple(leaf.shape), _dtype_name(leaf.dtype))
    assert got == ref
    assert models.param_count(specs) == sum(
        int(np.prod(s)) for s, _ in ref.values())


@pytest.mark.parametrize("arch,shape", [
    ("gemma-2b", "decode_32k"), ("gemma-2b", "train_4k"),
    ("qwen2-vl-2b", "prefill_32k"), ("qwen2-vl-2b", "train_4k"),
    ("musicgen-large", "decode_32k")])
def test_abstract_inputs_are_the_references_on_meta(arch, shape):
    got = models.abstract_inputs(get_config(arch), get_shape(shape))
    want = ref_models.abstract_inputs(ref_get_config(arch),
                                      ref_get_shape(shape))
    assert set(got) == set(want)
    for name, leaf in got.items():
        assert leaf.device.type == "meta"
        assert tuple(leaf.shape) == tuple(want[name].shape)
        assert _dtype_name(leaf.dtype) == jnp.dtype(want[name].dtype).name


def test_build_model_is_one_model_per_config():
    cfg = get_config("gemma-2b")
    assert models.build_model(cfg) is models.build_model(cfg)
    assert isinstance(models.build_model(cfg), models.Model)


def test_ladder_spec_json_is_the_references():
    levels = [{"matmul": {"bm": 128 >> (i // 4), "bk": 64,
                          "bn": 128 >> (i // 4)}}
              for i in range(ref_cm.NUM_LEVELS)]
    ref = RefLadderSpec(name="t", hw="h100_sxm", levels=levels,
                        scores=[1.0] * len(levels))
    port = LadderSpec.from_json(ref.to_json())
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert json.loads(port.to_json()) == json.loads(ref.to_json())
    assert port.tile_tables() == ref.tile_tables()
    for lvl in (0.0, 0.35, 1.0):
        assert port.tiles_for_level(lvl) == ref.tiles_for_level(lvl)
    bad = LadderSpec(name="t", hw="h", levels=levels[::-1])
    with pytest.raises(ValueError, match="ordering"):
        bad.validate()
    with pytest.raises(ValueError, match="ordering"):
        RefLadderSpec(name="t", hw="h", levels=levels[::-1]).validate()


def _recipe_prompts(vocab, n, prompt_len):
    """The reference ``launch.serve``'s prompts (src/repro/launch/serve.py)."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, prompt_len).astype(np.int32)
            for _ in range(n)]


def test_launch_serve_main_on_the_cpu(capsys):
    argv = ["--arch", "gemma-2b", "--reduced", "--requests", "5",
            "--prompt-len", "6", "--max-new", "4", "--slots", "2",
            "--device", "cpu"]
    out = serve.main(argv)
    line = capsys.readouterr().out.strip().splitlines()[0]
    assert line.startswith("[serve] gemma-2b-reduced: 5/5 requests, ")
    assert line.endswith(" tok/s) on cpu")
    done = sorted(out["requests"], key=lambda r: r.rid)
    assert [r.rid for r in done] == list(range(5))
    cfg = get_reduced_config("gemma-2b")
    prompts = _recipe_prompts(cfg.vocab_size, 5, 6)
    for r, p in zip(done, prompts):
        np.testing.assert_array_equal(r.prompt, p)
        assert r.done
    assert out["tokens"] == sum(len(r.output) for r in done)
    # the same weights and prompts through an engine built here
    params = models.Model(cfg).init(torch.Generator("cpu").manual_seed(0),
                                    "cpu")
    eng = TorchServingEngine(cfg, params, batch_slots=2,
                             max_len=6 + 4 + 2, device="cpu")
    direct = eng.run_to_completion([Request(rid=i, prompt=p,
                                            max_new_tokens=4)
                                    for i, p in enumerate(prompts)])
    assert {r.rid: r.output for r in direct} == \
        {r.rid: r.output for r in done}


def test_launch_serve_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "gemma-2b", "--reduced"])
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "gemma-2b", "--reduced", "--device", "cuda"])
