"""The port's serving engine on the moe family (reduced deepseek-v2-lite-16b:
``pro_0`` and two ``moe_ds`` blocks, 4 experts top-2, the JAX parameters
bridged over; ``batch_slots`` 2, ``MAX_LEN`` 64) against the JAX
package's engine on the CPU, with staggered admissions, mid-quantum
completions and level switches (the reference's speculative test
schedule).

  * the JAX engine compiles without XLA's excess precision here (its
    version cache's ``jax.jit`` swapped for one that passes the compiler
    option), as the port rounds: a dense serve and a paged speculative
    serve then give the JAX engine's streams exactly, with equal
    counters, page counters and ``spec_stats``;
  * the port's paged streams equal its dense ones, and its speculative
    streams equal its plain ones (verifies with rollbacks ran);
  * on the MoE-free clone (every layer ``ds_dense0``, the reference's
    ``_mla_only``) the MLA cache machinery is held strictly: paged equals
    dense, monolithic equals chunked, and a rollback-only speculative
    serve (unigram drafts of depth 3) equals the plain serve;
  * no build and no miss after ``warmup()``, with ``ReplayOnCPU`` standing
    in for CUDA graphs; each replay adds the launches its capture
    recorded: ``block_matmul`` 3 per dense MLP and 3 per shared-expert MLP
    a forward pass (9 here, 81 at full width), once per verify (no
    restore pass: every leaf pages), B2 and B3 never (MLA runs in plain
    ops).  Capacity MoE depends on the chunk schedule, so deepseek proper
    is compared only at equal chunking.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_reduced_config as jax_reduced_config  # noqa: E402
from repro.serving import engine as jax_engine  # noqa: E402
from repro.serving import version_cache as jax_version_cache  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.core import cost_model as cm  # noqa: E402
from repro_torch.kernels import block_matmul as bm  # noqa: E402
from repro_torch.kernels import dispatch, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_attention_paged as fap  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving import engine as torch_engine  # noqa: E402
from test_torch_deepseek import reference_params  # noqa: E402
from test_torch_graphs import ReplayOnCPU  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
MAX_LEN = 64
PROMPT_LENS = (10, 13, 15)
N_NEW = (40, 36, 20)
LEVELS = (0.0, 1.0, 0.3)
PAGED = {"page_size": 8, "n_pages": 24}
EXACT = {"xla_allow_excess_precision": False}


class _ExactLowered:
    def __init__(self, lowered):
        self._lowered = lowered

    def compile(self):
        return self._lowered.compile(compiler_options=EXACT)


class _ExactJit:
    """``jax.jit`` whose executables compile without excess precision:
    ``.lower(...).compile()`` as the version cache calls it, or a call,
    compiled once per argument signature."""

    def __init__(self, fn, **kw):
        self._jit = jax.jit(fn, **kw)
        self._exe: dict = {}

    def lower(self, *args):
        return _ExactLowered(self._jit.lower(*args))

    def __call__(self, *args):
        leaves, tree = jax.tree_util.tree_flatten(args)
        key = (tree, tuple((getattr(a, "shape", None),
                            str(getattr(a, "dtype", type(a))))
                           for a in leaves))
        if key not in self._exe:
            self._exe[key] = self._jit.lower(*args).compile(
                compiler_options=EXACT)
        return self._exe[key](*args)


class _ExactJax:
    """The ``jax`` module as the JAX version cache sees it here."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def jit(fn, **kw):
        return _ExactJit(fn, **kw)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's small eager ops: as fast
    alone, and the test runner's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _exact_jax_engine():
    saved = jax_version_cache.jax
    jax_version_cache.jax = _ExactJax()
    yield
    jax_version_cache.jax = saved


@pytest.fixture(autouse=True)
def _clean_dispatch():
    yield
    dispatch.clear_tile_overrides()
    dispatch.install_ladder(None)


def mla_only(cfg):
    return dataclasses.replace(cfg, name=cfg.name + "-mla-only",
                               first_dense_layers=cfg.num_layers)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_reduced_config(ARCH)
    _, jparams, tparams = reference_params()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n in PROMPT_LENS]
    clone = mla_only(get_reduced_config(ARCH))
    clone_params = Model(clone).init(torch.Generator().manual_seed(0), "cpu")
    return {"jax": (jcfg, jparams), "torch": (get_reduced_config(ARCH),
                                              tparams),
            "clone": (clone, clone_params), "prompts": prompts}


def _engine(models, side, **kw):
    cfg, params = models[side]
    if side == "jax":
        return jax_engine.ServingEngine(cfg, params, batch_slots=2,
                                        max_len=MAX_LEN, **kw)
    return torch_engine.ServingEngine(cfg, params, batch_slots=2,
                                      max_len=MAX_LEN, device="cpu", **kw)


def _serve(models, side, *, k=4, engine=None, **kw):
    eng = engine if engine is not None else _engine(models, side, **kw)
    mod = jax_engine if side == "jax" else torch_engine
    reqs = [mod.Request(rid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(models["prompts"], N_NEW))]
    pending = list(reqs)
    for i in range(400):
        if all(r.done for r in reqs):
            break
        if pending and i % 3 == 0 and eng.admit_request(pending[0],
                                                        drain=True):
            pending.pop(0)
        eng.set_interference_level(LEVELS[i % len(LEVELS)])
        eng.step_quantum(k)
    assert all(r.done for r in reqs), "the schedule drains every request"
    return eng, [list(r.output) for r in reqs]


# the serves held against the JAX engine: a dense engine, and a paged
# speculative one (its page counters and its spec_stats at once)
KINDS = {"dense": {}, "paged spec": {**PAGED, "speculative": True}}


@pytest.fixture(scope="module")
def runs(models):
    out = {(side, kind): _serve(models, side, **kw)
           for side in ("torch", "jax") for kind, kw in KINDS.items()}
    out["torch", "paged"] = _serve(models, "torch", **PAGED)
    out["torch", "spec"] = _serve(models, "torch", speculative=True)
    out["clone", "dense"] = _serve(models, "clone")
    return out


COUNTERS = ("host_syncs", "tokens_decoded", "prefill_chunks",
            "prefill_tokens", "prefill_pad_tokens", "quantum_calls")


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_streams_and_counters_equal_jax(runs, kind):
    (te, got), (je, want) = runs["torch", kind], runs["jax", kind]
    assert got == want
    for attr in COUNTERS:
        assert getattr(te, attr) == getattr(je, attr), attr
    if kind == "paged spec":
        assert te.page_stats == je.page_stats
        assert te.peak_cache_tokens == je.peak_cache_tokens
        assert te.pool.used_pages == 0 and te.pool.committed == 0
        assert te.spec_stats == je.spec_stats
        assert te.spec_quanta > 0


@pytest.mark.parametrize("kind", ["paged", "spec", "paged spec"])
def test_paged_and_spec_streams_equal_dense(runs, kind):
    eng, got = runs["torch", kind]
    assert got == runs["torch", "dense"][1]
    if "spec" in kind:
        assert eng.spec_quanta > 0 and eng.tokens_drafted > 0
        assert eng.tokens_accepted > 0 and eng.spec_rollbacks > 0


@pytest.mark.parametrize("kind", ["paged", "monolithic", "rollback only"])
def test_mla_clone_streams_equal_dense(models, runs, kind):
    """The MLA cache family held strictly on the MoE-free clone."""
    kw = {"paged": PAGED, "monolithic": {"chunked_prefill": False},
          "rollback only": {"speculative": True, "spec_ngram": 1,
                            "spec_depth": 3}}[kind]
    eng, got = _serve(models, "clone", **kw)
    plain, want = runs["clone", "dense"]
    assert got == want
    assert plain.prefill_pad_tokens > 0
    if kind == "monolithic":
        assert eng.prefill_chunks == 0
    if kind == "paged":
        assert eng.pool.used_pages == 0 and eng.pool.committed == 0
    if kind == "rollback only":
        assert eng.spec_quanta > 0 and eng.spec_rollbacks > 0


def _counting(monkeypatch):
    """Count B1, B2 and B3 calls on the CPU as their wrappers count
    launches on the card."""
    for mod, name, counter in ((ops, "block_matmul", bm.LAUNCHES),
                               (ops, "flash_attention", fa.LAUNCHES),
                               (ops, "flash_attention_paged",
                                fap.LAUNCHES)):
        real = getattr(mod, name)

        def counted(*a, _real=real, _counter=counter, **kw):
            _counter[("counted",)] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(mod, name, counted)


def moe_b1_per_pass(cfg) -> int:
    """B1 launches of one forward pass: the dense prologue's MLP and each
    moe_ds block's shared-expert MLP, three GEMMs each."""
    return 3 * cfg.first_dense_layers + 3 * (
        cfg.num_layers - cfg.first_dense_layers)


@pytest.mark.parametrize("kind", ["dense", "paged spec"])
def test_no_build_after_warmup_and_exact_launches(models, monkeypatch, kind):
    _counting(monkeypatch)
    counters = (bm.LAUNCHES, fa.LAUNCHES, fap.LAUNCHES)
    saved = [dict(c) for c in counters]
    cfg = models["torch"][0]
    per_pass = moe_b1_per_pass(cfg)
    assert moe_b1_per_pass(dataclasses.replace(
        cfg, num_layers=27, first_dense_layers=1)) == 81
    kw = {"dense": {}, "paged spec": {**PAGED, "speculative": True}}[kind]
    try:
        eng = _engine(models, "torch", **kw)
        eng.version_cache.graphs = ReplayOnCPU()
        eng.warmup(levels=[cm.grid_point(i) for i in (0, 9)])
        vc = eng.version_cache
        traces, misses = vc.traces, vc.misses
        kinds = set()
        for i, p in enumerate(models["prompts"][:2]):
            for c in counters:
                c.clear()
            eng.admit_request(torch_engine.Request(
                rid=i, prompt=p, max_new_tokens=24), drain=True)
            chunks = -(-len(p) // eng.prefill_chunk_len)
            assert sum(bm.LAUNCHES.values()) == per_pass * chunks
            assert sum(fa.LAUNCHES.values()) == 0
            assert sum(fap.LAUNCHES.values()) == 0
        step = 0
        while eng.active_slots:
            eng.set_interference_level(cm.grid_point((0, 9)[step % 2]))
            b1 = sum(bm.LAUNCHES.values())
            handle = eng.begin_quantum(4)
            eng.finish_quantum(handle)
            kinds.add(handle.kind)
            want = per_pass if handle.kind == "spec" \
                else per_pass * handle.bucket
            assert sum(bm.LAUNCHES.values()) - b1 == want, handle.kind
            assert sum(fa.LAUNCHES.values()) == 0
            assert sum(fap.LAUNCHES.values()) == 0
            step += 1
            assert step < 400
        assert vc.traces == traces and vc.misses == misses
        assert ("spec" in kinds) == (kind == "paged spec")
    finally:
        for c, s in zip(counters, saved):
            c.clear()
            c.update(s)
