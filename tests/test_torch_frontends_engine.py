"""The port's serving engine on the frontend configs (reduced qwen2-vl-2b:
M-RoPE, 4 heads over 2 KV heads; reduced musicgen-large: sinusoidal
positions, the plain gelu MLP with biases, layernorm), served with token
prompts as the reference's engine serves them, against the JAX package's
engine on the CPU: the JAX initializer's weights bridged over,
``batch_slots`` 2, ``MAX_LEN`` 64, the deepseek engine test's schedule
(staggered admissions, mid-quantum completions, level switches, 4-step
quanta).

  * the JAX engine compiles without XLA's excess precision (its version
    cache's ``jax.jit`` swapped), as the port rounds: dense, paged, speculative and paged
    speculative serves give its streams, parting only at a reference
    near-tie (two tokens within ``CLEAR_MARGIN`` at the top of the JAX
    model's logits, the hybrid engine test's rule: with more than one KV
    head the port's plain attention and the reference's round apart, so
    their logits differ by bf16 ulps; with one they agree bit for bit),
    and its counters and page counters exactly; a
    speculative serve gives its counters and ``spec_stats`` where its
    streams equal the JAX engine's (a parted stream drafts other
    tokens); the port's paged and speculative streams equal its dense
    ones;
  * no build and no miss after ``warmup()``, with ``ReplayOnCPU``
    standing in for CUDA graphs; each replay adds the launches its
    capture recorded: ``block_matmul`` 3 a layer a forward pass on
    qwen2-vl-2b's gated MLP and 2 on musicgen-large's plain one,
    ``flash_attention`` once a layer per prefill chunk,
    ``flash_attention_paged`` once a layer per paged decode step and per
    verify (no restore pass: every leaf pages).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_reduced_config as jax_reduced_config  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.serving import version_cache as jax_version_cache  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.core import cost_model as cm  # noqa: E402
from repro_torch.kernels import block_matmul as bm  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_attention_paged as fap  # noqa: E402
from repro_torch.serving import engine as torch_engine  # noqa: E402
from test_torch_deepseek_engine import _counting, _engine, _ExactJax, \
    _serve  # noqa: E402
from test_torch_graphs import ReplayOnCPU  # noqa: E402

ARCHS = ("qwen2-vl-2b", "musicgen-large")
PROMPT_LENS = (10, 13, 15)
PAGED = {"page_size": 8, "n_pages": 24}
KINDS = {"dense": {}, "paged": PAGED, "spec": {"speculative": True},
         "paged spec": {**PAGED, "speculative": True}}
CLEAR_MARGIN = 2e-2
MAX_LEN = 64
COUNTERS = ("host_syncs", "tokens_decoded", "prefill_chunks",
            "prefill_tokens", "prefill_pad_tokens", "quantum_calls")


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


def _sides(arch):
    jcfg = jax_reduced_config(arch)
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n in PROMPT_LENS]
    return {"jax": (jcfg, jparams), "torch": (get_reduced_config(arch),
                                              tparams),
            "prompts": prompts, "model": jmodel}


def parts_only_at_reference_near_ties(side, got, want):
    """``got`` equals ``want`` stream by stream, or parts where the JAX
    model's logits (a prefill of the prompt and the agreed tokens) have
    their top two within CLEAR_MARGIN and both streams' tokens among
    them.  Returns the number of partings."""
    jmodel, jparams = side["model"], side["jax"][1]
    parted = 0
    for rid, (stream, ref) in enumerate(zip(got, want)):
        if stream == ref:
            continue
        parted += 1
        t = next(i for i, (a, b) in enumerate(zip(stream, ref)) if a != b)
        toks = np.concatenate([side["prompts"][rid],
                               np.asarray(stream[:t], np.int32)])
        logits, _ = jmodel.prefill(jparams,
                                   {"tokens": jnp.asarray(toks)[None]},
                                   jmodel.init_cache(1, MAX_LEN))
        top = np.asarray(logits, np.float32)[0]
        srt = np.sort(top)
        assert srt[-1] - srt[-2] < CLEAR_MARGIN, (rid, t, srt[-2:])
        for tok in (stream[t], ref[t]):
            assert top[tok] >= srt[-1] - CLEAR_MARGIN, (rid, t, tok)
    return parted


@pytest.fixture(scope="module")
def sides():
    return {arch: _sides(arch) for arch in ARCHS}


@pytest.fixture(scope="module")
def runs(sides):
    return {(arch, side, kind): _serve(sides[arch], side, **kw)
            for arch in ARCHS for side in ("torch", "jax")
            for kind, kw in KINDS.items()}


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_streams_and_counters_equal_jax(sides, runs, arch, kind):
    (te, got), (je, want) = runs[arch, "torch", kind], runs[arch, "jax", kind]
    parted = parts_only_at_reference_near_ties(sides[arch], got, want)
    if not ("spec" in kind and parted):
        # a parted speculative stream drafts other tokens: its verifies,
        # and so its quanta and syncs, are its own
        for attr in COUNTERS:
            assert getattr(te, attr) == getattr(je, attr), attr
    if "paged" in kind:
        assert te.page_stats == je.page_stats
        assert te.peak_cache_tokens == je.peak_cache_tokens
        assert te.pool.used_pages == 0 and te.pool.committed == 0
        assert te.page_stats["peak_used"] > 0
    if "spec" in kind:
        if not parted:
            assert te.spec_stats == je.spec_stats
        assert te.spec_quanta > 0 and te.tokens_drafted > 0


@pytest.mark.parametrize("kind", ["paged", "spec", "paged spec"])
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_and_spec_streams_equal_dense(runs, arch, kind):
    assert runs[arch, "torch", kind][1] == runs[arch, "torch", "dense"][1]


@pytest.mark.parametrize("arch", ARCHS)
def test_no_build_after_warmup_and_exact_launches(sides, arch, monkeypatch):
    """A paged speculative engine under ``ReplayOnCPU``: nothing built
    after ``warmup()``; each forward pass launches B1 once per GEMM of
    each layer's MLP, B2 once a layer per prefill chunk, B3 once a layer
    per decode step and per verify."""
    _counting(monkeypatch)
    counters = (bm.LAUNCHES, fa.LAUNCHES, fap.LAUNCHES)
    saved = [dict(c) for c in counters]
    cfg = sides[arch]["torch"][0]
    n = cfg.num_layers
    gemms = 3 if cfg.activation in ("swiglu", "geglu") else 2
    try:
        eng = _engine(sides[arch], "torch", **PAGED, speculative=True)
        eng.version_cache.graphs = ReplayOnCPU()
        eng.warmup(levels=[cm.grid_point(i) for i in (0, 9)])
        vc = eng.version_cache
        traces, misses = vc.traces, vc.misses
        kinds = set()
        for i, p in enumerate(sides[arch]["prompts"][:2]):
            for c in counters:
                c.clear()
            eng.admit_request(torch_engine.Request(
                rid=i, prompt=p, max_new_tokens=24), drain=True)
            chunks = -(-len(p) // eng.prefill_chunk_len)
            assert sum(bm.LAUNCHES.values()) == gemms * n * chunks
            assert sum(fa.LAUNCHES.values()) == n * chunks
            assert sum(fap.LAUNCHES.values()) == 0
        step = 0
        while eng.active_slots:
            eng.set_interference_level(cm.grid_point((0, 9)[step % 2]))
            before = [sum(c.values()) for c in counters]
            handle = eng.begin_quantum(4)
            eng.finish_quantum(handle)
            kinds.add(handle.kind)
            passes = 1 if handle.kind == "spec" else handle.bucket
            got = [sum(c.values()) - b for c, b in zip(counters, before)]
            assert got == [gemms * n * passes, 0, n * passes], handle.kind
            step += 1
            assert step < 400
        assert vc.traces == traces and vc.misses == misses
        assert "spec" in kinds
    finally:
        for c, s in zip(counters, saved):
            c.clear()
            c.update(s)
