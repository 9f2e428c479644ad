"""The port's CUDA kernels on the card (skipped without one).

The hand-written kernels have no CPU mode, so these tests need an NVIDIA
GPU.  This file imports nothing of JAX, so it runs on a machine that has
PyTorch for CUDA and no JAX:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the kernels and their plain versions both accumulate in fp32
and round the output to bf16 once; they differ only in summation order,
so at most a rounding flip of the bf16 output (2e-2 relative and
absolute covers one bf16 ulp at the values drawn here).  The SSD scan's
fp32 state differs in summation order (the kernel's cumsum of dt*a is a
warp-level prefix sum) and in its fp32 operands entering tensor-core
products as bf16 hi + lo (~2^-17 relative): 1e-3 of its largest entry.  The paged
attention kernel is held at the same 2e-2 against its plain version
(gather, then dense attention).  The whole model
compares logits after three residual layers of bf16 activations at 5e-2.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.core import cost_model as cm  # noqa: E402
from repro_torch.kernels import block_matmul as bm  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_attention_paged as fap  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.kernels.ref import attention_ref, matmul_ref, \
    paged_attention_ref, ssd_ref  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.engine import (H100_LEVEL_TILES, Request,  # noqa: E402
                                        ServingEngine)

KERNEL_TOL = 2e-2
STATE_TOL = 1e-3
LOGIT_TOL = 5e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode (chip_smoke.py runs them at full width)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("level", range(len(H100_LEVEL_TILES)))
def test_block_matmul_kernel_matches_plain(cuda_device, level):
    g = torch.Generator(device=cuda_device).manual_seed(level)
    tiles = H100_LEVEL_TILES[level]["matmul"]
    for m, k, n in ((4, 256, 512), (37, 300, 129), (16, 2048, 96),
                    (1, 8, 8)):
        x = torch.randn(m, k, generator=g, device=cuda_device).bfloat16()
        w = (torch.randn(k, n, generator=g, device=cuda_device)
             * k ** -0.5).bfloat16()
        before = bm.launch_count()
        got = bm.block_matmul_2d(x, w, **tiles)
        assert bm.launch_count() == before + 1
        torch.testing.assert_close(got.float(), matmul_ref(x, w).float(),
                                   rtol=KERNEL_TOL, atol=KERNEL_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("level", range(len(H100_LEVEL_TILES)))
def test_flash_attention_kernel_matches_plain(cuda_device, level):
    g = torch.Generator(device=cuda_device).manual_seed(level)
    tiles = H100_LEVEL_TILES[level]["attention"]
    # MQA at gemma-2b's head_dim; GQA at head_dim 128 over a cache length
    # that is no multiple of any block
    for s, t, kh, d in ((5, 64, 1, 256), (7, 70, 2, 128)):
        q = torch.randn(3, s, 8, d, generator=g,
                        device=cuda_device).bfloat16()
        kk = torch.randn(3, t, kh, d, generator=g,
                         device=cuda_device).bfloat16()
        v = torch.randn(3, t, kh, d, generator=g,
                        device=cuda_device).bfloat16()
        off = torch.tensor([0, 20, t - s], device=cuda_device)
        # the last row's kv_valid_len of 0 leaves every key masked: 0 out
        kvl = torch.tensor([s, 20 + s, 0], device=cuda_device)
        for window, softcap in ((None, None), (16, 30.0)):
            got = fa.flash_attention(q, kk, v, offset=off, kv_valid_len=kvl,
                                     window=window, softcap=softcap, **tiles)
            want = attention_ref(q, kk, v, offset=off, kv_valid_len=kvl,
                                 window=window, softcap=softcap)
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=KERNEL_TOL, atol=KERNEL_TOL)
            assert torch.all(got[2] == 0)


# (m, k, n, split at level 0): the down projection split across a cluster
# of 8, a K of 259 tiles that 8 blocks cannot share evenly, products
# with too few K tiles to split (4 and 1 tiles) and ones split in two
SPLIT_GEMMS = [(4, 16384, 2048, 8), (4, 16576, 2048, 8), (4, 256, 512, 1),
               (1, 2048, 16384, 2), (300, 512, 256, 2), (300, 64, 64, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,split", SPLIT_GEMMS)
def test_block_matmul_split_k_is_right_and_deterministic(cuda_device, m, k,
                                                         n, split):
    g = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    tiles = H100_LEVEL_TILES[0]["matmul"]
    assert bm.launch_geometry(m, k, n, **tiles)[1] == split
    x = torch.randn(m, k, generator=g, device=cuda_device).bfloat16()
    w = (torch.randn(k, n, generator=g, device=cuda_device)
         * k ** -0.5).bfloat16()
    before = bm.launch_count()
    got = bm.block_matmul_2d(x, w, **tiles)
    again = bm.block_matmul_2d(x, w, **tiles)
    assert bm.launch_count() == before + 2
    torch.testing.assert_close(got.float(), matmul_ref(x, w).float(),
                               rtol=KERNEL_TOL, atol=KERNEL_TOL)
    assert torch.equal(got, again)


# (B, S, KH, offsets, kv_valid, D, T, tiles): gemma-2b's 8 query heads at
# D 256 over a 512-slot cache under levels 0 and 9 (tiles None): decode
# rows at 0 and 511, GQA, the 16-token chunk.  Then narrow heads whose
# accumulator fewer than 8 warps hold (D 32 at 32 rows, D 64 at 16), where
# each rank's partial is packed by the threads that hold it
ATTENTION_SPLIT_CASES = [
    (4, 1, 1, [0, 100, 300, 511], [1, 101, 301, 512], 256, 512, None),
    (4, 1, 2, [0, 100, 300, 511], [1, 101, 301, 512], 256, 512, None),
    (1, 16, 1, [240], [256], 256, 512, None),
    (2, 16, 2, [0, 240], [16, 256], 256, 512, None),
    (1, 4, 1, [124], [128], 32, 128, dict(bq=32, bkv=16)),
    (2, 2, 1, [90, 126], [92, 128], 64, 128, dict(bq=16, bkv=16)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,kh,offsets,kv_valid,d,t,tiles",
                         ATTENTION_SPLIT_CASES)
def test_flash_attention_split_kv_is_right_and_deterministic(
        cuda_device, b, s, kh, offsets, kv_valid, d, t, tiles):
    g = torch.Generator(device=cuda_device).manual_seed(b * 16 + s + kh + d)
    q = torch.randn(b, s, 8, d, generator=g, device=cuda_device).bfloat16()
    kk = torch.randn(b, t, kh, d, generator=g, device=cuda_device).bfloat16()
    v = torch.randn(b, t, kh, d, generator=g, device=cuda_device).bfloat16()
    off = torch.tensor(offsets, device=cuda_device)
    kvl = torch.tensor(kv_valid, device=cuda_device)
    levels = (0, len(H100_LEVEL_TILES) - 1)
    for tl in [tiles] if tiles else \
            [H100_LEVEL_TILES[lv]["attention"] for lv in levels]:
        assert fa.launch_geometry(b, s, 8, kh, t, **tl)[1] > 1
        got = fa.flash_attention(q, kk, v, offset=off, kv_valid_len=kvl,
                                 **tl)
        again = fa.flash_attention(q, kk, v, offset=off, kv_valid_len=kvl,
                                   **tl)
        want = attention_ref(q, kk, v, offset=off, kv_valid_len=kvl)
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=KERNEL_TOL, atol=KERNEL_TOL)
        assert torch.equal(got, again)


@pytest.mark.cuda
def test_kernels_report_the_shared_memory_the_wrappers_expect(cuda_device):
    # B1's layout lives in its CUDA source alone: every tile the level
    # table gives the serve's GEMMs fits the card (the ring exceeds 48 KB,
    # so the kernel raises its dynamic limit)
    for level in H100_LEVEL_TILES:
        for m, k, n in ((4, 2048, 16384), (16, 16384, 2048)):
            tile = bm.effective_tiles(m, k, n, **level["matmul"])
            assert 0 < bm.smem_bytes(*tile) <= fa.MAX_SMEM_BYTES
    assert bm.smem_bytes(8, 64, 128) == -1
    # B2's wrapper refuses blocks by its own count: it must be the kernel's
    for d in fa.HEAD_DIMS:
        for bkv in fa.BKV_CHOICES:
            for bq in range(1, fa.MAX_ROWS + 1):
                assert fa.kernel_smem_bytes(bq, bkv, d) == \
                    fa.smem_bytes(bq, bkv, d)
    assert fa.kernel_smem_bytes(fa.MAX_ROWS + 1, 64, 256) == -1
    assert fa.kernel_smem_bytes(16, 64, 48) == -1


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_cannot_take(cuda_device):
    x = torch.zeros(300, 64, device=cuda_device, dtype=torch.bfloat16)
    w = torch.zeros(64, 64, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="tile"):
        bm.block_matmul_2d(x, w, bm=256)
    with pytest.raises(TypeError):
        bm.block_matmul_2d(x.float(), w.float())
    q = torch.zeros(1, 128, 8, 256, device=cuda_device, dtype=torch.bfloat16)
    kv = torch.zeros(1, 128, 1, 256, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="shared"):
        fa.flash_attention(q, kv, kv, offset=0, kv_valid_len=128, bq=128,
                           bkv=128)
    # more than 64 flattened query rows a block; a head_dim not built;
    # a base that is not 16-byte aligned
    with pytest.raises(ValueError, match="built for"):
        fa.flash_attention(q[..., :128].contiguous(),
                           kv[..., :128].contiguous(),
                           kv[..., :128].contiguous(), offset=0,
                           kv_valid_len=128, bq=128, bkv=16)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q[..., :48].contiguous(), kv[..., :48].contiguous(),
                           kv[..., :48].contiguous(), offset=0,
                           kv_valid_len=128)
    flat = torch.zeros(1 + 128 * 8 * 256, device=cuda_device,
                       dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention(flat[1:].view(1, 128, 8, 256), kv, kv, offset=0,
                           kv_valid_len=128)


@pytest.mark.cuda
def test_engine_on_the_card_goes_through_the_kernels(cuda_device):
    cfg = get_reduced_config("gemma-2b")
    params = Model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    prompt = np.arange(1, 12, dtype=np.int32) * 7 % cfg.vocab_size
    toks = torch.from_numpy(prompt.astype(np.int64))[None]
    model = Model(cfg)
    cpu_logits, _ = model.prefill(params, {"tokens": toks},
                                  model.init_cache(1, 32, "cpu"))
    engine = ServingEngine(cfg, params, batch_slots=2, max_len=32)
    assert engine.device.type == "cuda"
    card_logits, _ = model.prefill(engine.params,
                                   {"tokens": toks.to(cuda_device)},
                                   model.init_cache(1, 32, cuda_device))
    torch.testing.assert_close(card_logits.cpu(), cpu_logits,
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    engine.warmup()
    bm.LAUNCHES.clear()
    fa.LAUNCHES.clear()
    reqs = [Request(rid=i, prompt=prompt[:n], max_new_tokens=6)
            for i, n in enumerate((3, 11, 5))]
    engine.run_to_completion(reqs)
    assert all(r.done and len(r.output) == 7 for r in reqs)
    assert bm.launch_count() > 0 and fa.launch_count() > 0


def _ssd_inputs(g, dev, bsz, l, h, p, n, with_init):
    x = torch.randn(bsz, l, h, p, generator=g, device=dev).bfloat16()
    dt = torch.nn.functional.softplus(
        torch.randn(bsz, l, h, generator=g, device=dev) - 1.0)
    a = -torch.rand(h, generator=g, device=dev) * 2.0 - 0.1
    b = torch.randn(bsz, l, h, n, generator=g, device=dev).bfloat16()
    c = torch.randn(bsz, l, h, n, generator=g, device=dev).bfloat16()
    h0 = (torch.randn(bsz, h, p, n, generator=g, device=dev)
          if with_init else None)
    return x, dt, a, b, c, h0


# (B, L, H, P, N, chunk, initial state): the serve's chunks at mamba2-780m
# widths, a monolithic prompt of three chunks with a ragged tail, and
# ragged small shapes (P and N no multiple of 16, L no multiple of Q)
SSD_CASES = [(1, 16, 48, 64, 128, 256, True), (1, 2, 48, 64, 128, 256, True),
             (1, 600, 48, 64, 128, 256, False),
             (1, 600, 48, 64, 128, 256, True),
             (4, 16, 48, 64, 128, 256, True),
             (2, 37, 3, 20, 7, 16, True), (3, 5, 2, 33, 130, 4, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,l,h,p,n,chunk,with_init", SSD_CASES)
def test_ssd_scan_kernel_matches_plain(cuda_device, bsz, l, h, p, n, chunk,
                                       with_init):
    g = torch.Generator(device=cuda_device).manual_seed(l + h)
    x, dt, a, b, c, h0 = _ssd_inputs(g, cuda_device, bsz, l, h, p, n,
                                     with_init)
    before = ssd.launch_count()
    y, state = ssd.ssd_scan(x, dt, a, b, c, chunk_size=chunk,
                            initial_state=h0)
    torch.cuda.synchronize()
    assert ssd.launch_count() == before + 1
    want_y, want_s = ssd_ref(x, dt, a, b, c, chunk_size=chunk,
                             initial_state=h0)
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    torch.testing.assert_close(y.float(), want_y.float(), rtol=KERNEL_TOL,
                               atol=KERNEL_TOL)
    torch.testing.assert_close(
        state, want_s, rtol=0,
        atol=STATE_TOL * want_s.abs().max().item())


@pytest.mark.cuda
def test_ssd_scan_wrapper_refuses_what_the_kernel_cannot_take(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x, dt, a, b, c, h0 = _ssd_inputs(g, cuda_device, 1, 8, 2, 64, 128, True)
    with pytest.raises(TypeError):
        ssd.ssd_scan(x.float(), dt, a, b, c)
    with pytest.raises(ValueError, match="contiguous"):
        ssd.ssd_scan(x, dt, a, b.transpose(2, 3).contiguous().transpose(
            2, 3), c)
    # B and C per group: the groups must divide the heads
    with pytest.raises(ValueError, match="ssd_scan"):
        ssd.ssd_scan(x, dt, a, b.repeat(1, 1, 3, 1)[:, :, :3].contiguous(),
                     c.repeat(1, 1, 3, 1)[:, :, :3].contiguous())
    with pytest.raises(ValueError, match="shared"):
        ssd.ssd_scan(*(t.repeat(1, 64, 1, 1) if t.ndim == 4 else
                       t.repeat(1, 64, 1) if t.ndim == 3 else t
                       for t in (x, dt, a, b, c)), chunk_size=512)


# (B, L, H, G, P, N, chunk): the serve's chunk and the 600-token prompt at
# mamba2-780m's widths with one group, as the model passes B and C, and per
# head (G = H); a head_dim of 6 column blocks, ragged P and N
SSD_SPLIT_CASES = [(1, 16, 48, 1, 64, 128, 256), (1, 16, 48, 48, 64, 128, 256),
                   (1, 600, 48, 1, 64, 128, 256), (4, 16, 48, 1, 64, 128, 256),
                   (2, 37, 4, 2, 96, 64, 16), (2, 23, 3, 1, 20, 7, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,l,h,g,p,n,chunk", SSD_SPLIT_CASES)
def test_ssd_scan_split_and_groups_are_right_and_deterministic(
        cuda_device, bsz, l, h, g, p, n, chunk):
    gen = torch.Generator(device=cuda_device).manual_seed(l + h + g)
    x, dt, a, _, _, h0 = _ssd_inputs(gen, cuda_device, bsz, l, h, p, n, True)
    b = torch.randn(bsz, l, g, n, generator=gen,
                    device=cuda_device).bfloat16()
    c = torch.randn(bsz, l, g, n, generator=gen,
                    device=cuda_device).bfloat16()
    assert ssd.launch_geometry(bsz, h, p) == (-(-p // 16), bsz * h *
                                              -(-p // 16))
    kw = dict(chunk_size=chunk, initial_state=h0)
    before = ssd.launch_count()
    y, state = ssd.ssd_scan(x, dt, a, b, c, **kw)
    y2, state2 = ssd.ssd_scan(x, dt, a, b, c, **kw)
    torch.cuda.synchronize()
    assert ssd.launch_count() == before + 2
    assert torch.equal(y, y2) and torch.equal(state, state2)
    # against the plain version on the per-head copies
    rep = h // g
    want_y, want_s = ssd_ref(x, dt, a, b.repeat_interleave(rep, dim=2),
                             c.repeat_interleave(rep, dim=2), **kw)
    torch.testing.assert_close(y.float(), want_y.float(), rtol=KERNEL_TOL,
                               atol=KERNEL_TOL)
    torch.testing.assert_close(
        state, want_s, rtol=0,
        atol=STATE_TOL * want_s.abs().max().item())


@pytest.mark.cuda
def test_paged_and_ssd_kernels_report_the_shared_memory_the_wrappers_expect(
        cuda_device):
    # the wrappers refuse calls by their own counts: they must be the
    # kernels'
    for d in fa.HEAD_DIMS:
        for rows in (1, 8, 16, 24, 32, 64, 128):
            for n_slot in (1, 32, 33, 4096):
                assert fap.kernel_smem_bytes(rows, d, n_slot) == \
                    fap.smem_bytes(rows, d, n_slot)
    assert fap.kernel_smem_bytes(8, 48, 32) == -1
    for q in (1, 2, 15, 16, 17, 64, 100, 256, 512):
        for n in (1, 7, 8, 64, 128, 130):
            assert ssd.kernel_smem_bytes(q, n) == ssd.smem_bytes(q, n)
    assert ssd.kernel_smem_bytes(256, 128) <= fa.MAX_SMEM_BYTES


@pytest.mark.cuda
def test_mamba2_engine_on_the_card_goes_through_ssd_scan(cuda_device):
    cfg = get_reduced_config("mamba2-780m")
    params = Model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    prompt = np.arange(1, 40, dtype=np.int32) * 7 % cfg.vocab_size
    toks = torch.from_numpy(prompt.astype(np.int64))[None]
    model = Model(cfg)
    cpu_logits, _ = model.prefill(params, {"tokens": toks},
                                  model.init_cache(1, 64, "cpu"))
    engine = ServingEngine(cfg, params, batch_slots=2, max_len=64)
    card_logits, _ = model.prefill(engine.params,
                                   {"tokens": toks.to(cuda_device)},
                                   model.init_cache(1, 64, cuda_device))
    torch.testing.assert_close(card_logits.cpu(), cpu_logits,
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    engine.warmup()
    ssd.LAUNCHES.clear()
    reqs = [Request(rid=i, prompt=prompt[:n], max_new_tokens=6)
            for i, n in enumerate((3, 39, 17))]
    engine.run_to_completion(reqs)
    assert all(r.done and len(r.output) == 7 for r in reqs)
    # chunks of two or more tokens: 3 -> (4); 39 -> (16, 16, 8);
    # 17 -> (16, 1), whose 1-token tail runs the decode step
    assert ssd.launch_count() == cfg.num_layers * 5


def _paged_inputs(g, dev, b, kh, ps, kvl, d=256, h=8, t=512):
    """bf16 q and pools of garbage (~1e3) with each row's valid keys on
    shuffled pages; row 0's pages past its first point at the trash
    page."""
    n_slot = t // ps
    n_pages = b * n_slot + 1
    kp = (torch.randn(n_pages, ps, kh, d, generator=g, device=dev)
          * 1e3).bfloat16()
    vp = (torch.randn(n_pages, ps, kh, d, generator=g, device=dev)
          * 1e3).bfloat16()
    table = (torch.randperm(n_pages - 1, generator=g, device=dev) + 1)[
        :b * n_slot].reshape(b, n_slot).int()
    table[0, 1:] = 0
    for i, n in enumerate(kvl):
        for j in range(-(-n // ps)):
            rows = min(ps, n - j * ps)
            ph = int(table[i, j])
            kp[ph, :rows] = torch.randn(rows, kh, d, generator=g,
                                        device=dev).bfloat16()
            vp[ph, :rows] = torch.randn(rows, kh, d, generator=g,
                                        device=dev).bfloat16()
    q = torch.randn(b, 1, h, d, generator=g, device=dev).bfloat16()
    return q, kp, vp, table


# (page size, kv heads, window, softcap)
PAGED_CUDA_CASES = [(8, 1, None, None), (16, 1, None, None),
                    (32, 2, None, None), (16, 2, 64, None),
                    (8, 1, None, 50.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("ps,kh,window,softcap", PAGED_CUDA_CASES)
def test_flash_attention_paged_kernel_matches_plain(cuda_device, ps, kh,
                                                    window, softcap):
    g = torch.Generator(device=cuda_device).manual_seed(ps + kh)
    kvl = [1, 37, 300, 512]
    q, kp, vp, table = _paged_inputs(g, cuda_device, 4, kh, ps, kvl)
    kvl_t = torch.tensor(kvl, dtype=torch.int32, device=cuda_device)
    before = fap.launch_count()
    got = fap.flash_attention_paged(q, kp, vp, table, offset=kvl_t - 1,
                                    kv_valid_len=kvl_t, window=window,
                                    softcap=softcap)
    torch.cuda.synchronize()
    assert fap.launch_count() == before + 1
    want = paged_attention_ref(q, kp, vp, table, offset=kvl_t - 1,
                               kv_valid_len=kvl_t, window=window,
                               softcap=softcap)
    torch.testing.assert_close(got.float(), want.float(), rtol=KERNEL_TOL,
                               atol=KERNEL_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("ps,kh,d,h", [(16, 1, 256, 8), (8, 2, 128, 24),
                                       (32, 1, 64, 8)])
def test_flash_attention_paged_split_is_right_and_deterministic(
        cuda_device, ps, kh, d, h):
    # the largest split launch_geometry gives (8 blocks a cluster); row 0
    # sees no key and must write 0
    g = torch.Generator(device=cuda_device).manual_seed(ps + d)
    kvl = [0, 37, 300, 512]
    q, kp, vp, table = _paged_inputs(g, cuda_device, 4, kh, ps, kvl, d=d,
                                     h=h)
    assert fap.launch_geometry(4, 1, h, kh, ps, table.shape[1])[0] == \
        fa.MAX_SPLIT
    kvl_t = torch.tensor(kvl, dtype=torch.int32, device=cuda_device)
    kw = dict(offset=kvl_t - 1, kv_valid_len=kvl_t)
    before = fap.launch_count()
    got = fap.flash_attention_paged(q, kp, vp, table, **kw)
    again = fap.flash_attention_paged(q, kp, vp, table, **kw)
    assert fap.launch_count() == before + 2
    want = paged_attention_ref(q, kp, vp, table, **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=KERNEL_TOL,
                               atol=KERNEL_TOL)
    assert torch.equal(got, again)
    assert torch.all(got[0] == 0)


@pytest.mark.cuda
def test_flash_attention_paged_wrapper_refuses_what_the_kernel_cannot_take(
        cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, kp, vp, table = _paged_inputs(g, cuda_device, 2, 1, 16, [3, 20])
    with pytest.raises(TypeError):
        fap.flash_attention_paged(q, kp, vp, table.long(), offset=0,
                                  kv_valid_len=1)
    # head dims the kernel is not built for: one below 16-byte loads, one
    # a multiple of 8 outside (32, 64, 128, 256)
    for d in (36, 48):
        with pytest.raises(ValueError, match="head_dim"):
            fap.flash_attention_paged(q[..., :d].contiguous(),
                                      kp[..., :d].contiguous(),
                                      vp[..., :d].contiguous(), table,
                                      offset=0, kv_valid_len=1)
    # a table too long to stage beside the block's tiles
    long_table = torch.zeros(2, 20_000, dtype=torch.int32,
                             device=cuda_device)
    assert fap.smem_bytes(8, 256, 20_000) > fa.MAX_SMEM_BYTES
    with pytest.raises(ValueError, match="shared"):
        fap.flash_attention_paged(q, kp, vp, long_table, offset=0,
                                  kv_valid_len=1)


@pytest.mark.cuda
def test_paged_engine_on_the_card_goes_through_the_paged_kernel(
        cuda_device):
    cfg = get_reduced_config("gemma-2b")
    params = Model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    prompt = np.arange(1, 20, dtype=np.int32) * 7 % cfg.vocab_size
    engine = ServingEngine(cfg, params, batch_slots=2, max_len=32,
                           page_size=8)
    engine.warmup()
    fap.LAUNCHES.clear()
    reqs = [Request(rid=i, prompt=prompt[:n], max_new_tokens=6)
            for i, n in enumerate((3, 19, 12))]
    assert engine.admit_request(reqs[1], drain=True)
    # request 2 borrows request 1's first page and, as a partial tail,
    # its second, which its first decode copies before writing
    assert engine.admit_request(reqs[2], drain=True)
    engine.run_to_completion([reqs[0]])
    assert all(r.done and len(r.output) == 7 for r in reqs)
    assert fap.launch_count() > 0
    assert fap.launch_count() % cfg.num_layers == 0
    stats = engine.page_stats
    assert stats["used_pages"] == 0 and stats["committed"] == 0
    assert stats["shared_hits"] == 2 and stats["cow_copies"] == 1, stats


# ---------------------------------------------------------------------------
# CUDA graphs: the version cache's calls captured and replayed
# ---------------------------------------------------------------------------
# (configuration, engine options, prompt lengths, max_len); the paged
# prompts make requests 2 and 1 share a full page and a partial tail
GRAPH_CASES = {
    "dense": ("gemma-2b", {}, (3, 19, 12), 32),
    "paged": ("gemma-2b", {"page_size": 8}, (3, 19, 12), 32),
    "mamba2": ("mamba2-780m", {}, (3, 39, 17), 64),
}


def _graph_engines(case):
    """An eager engine and a graphed one on the same weights, both warm."""
    name, kw, lens, max_len = GRAPH_CASES[case]
    cfg = get_reduced_config(name)
    params = Model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    prompt = np.arange(1, 41, dtype=np.int32) * 7 % cfg.vocab_size
    engines = [ServingEngine(cfg, params, batch_slots=2, max_len=max_len,
                             cuda_graphs=graphs, **kw)
               for graphs in (False, True)]
    for eng in engines:
        eng.warmup()
    return engines, [prompt[:n] for n in lens]


def _launches():
    return [sum(c.values()) for c in
            (bm.LAUNCHES, fa.LAUNCHES, fap.LAUNCHES, ssd.LAUNCHES)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_graphed_engine_serves_the_eager_engines_streams(cuda_device, case):
    """The same traffic on the eager and the graphed engine: identical
    token streams and identical kernel launch counts (a replay adds what
    its capture recorded), and the graphed serve captures nothing."""
    engines, prompts = _graph_engines(case)
    results = []
    for eng in engines:
        vc = eng.version_cache
        traces0, before = vc.traces, _launches()
        reqs = [Request(rid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        assert eng.admit_request(reqs[1], drain=True)
        assert eng.admit_request(reqs[2], drain=True)
        eng.run_to_completion([reqs[0]])
        assert all(r.done and len(r.output) == 7 for r in reqs)
        assert vc.traces == traces0
        results.append(([r.output for r in reqs],
                        [a - b for a, b in zip(_launches(), before)]))
    assert results[0] == results[1]
    graphed = engines[1].version_cache._calls.values()
    assert all(c.graph is not None for c in graphed)
    assert sum(c.replays for c in graphed) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_replayed_quantum_leaves_the_cache_bit_identical(cuda_device, case):
    """One 4-step quantum on two rows, replayed and eager, from the same
    state: the same token block and the same cache, bit for bit."""
    engines, prompts = _graph_engines(case)
    blocks = []
    for eng in engines:
        for i, p in enumerate(prompts[1:]):
            assert eng.admit_request(Request(rid=i, prompt=p,
                                             max_new_tokens=8), drain=True)
        handle = eng.begin_quantum(4)
        blocks.append(handle.block.clone())
        eng.finish_quantum(handle)
    assert torch.equal(blocks[0], blocks[1])
    for path in ("k", "v", "conv", "ssd"):
        leaves = [e.cache["blocks"][e.cfg.family].get(path) for e in engines]
        if leaves[0] is not None:
            assert torch.equal(leaves[0], leaves[1]), path


@pytest.mark.cuda
def test_no_capture_after_warmup_across_a_level_sweep(cuda_device):
    """After ``warmup()`` every quantum, decode step and prefill chunk of
    a full level sweep is a replay of a graph captured there."""
    (_, eng), prompts = _graph_engines("dense")
    vc = eng.version_cache
    traces0, misses0, calls0 = vc.traces, vc.misses, len(vc._calls)
    replays0 = sum(c.replays for c in vc._calls.values())
    for i in range(cm.NUM_LEVELS):
        eng.set_interference_level(cm.grid_point(i))
        assert eng.admit_request(Request(rid=i, prompt=prompts[i % 3],
                                         max_new_tokens=3), drain=True)
        eng.step()
        eng.step_quantum(1 << (i % 5))
        eng.run_to_completion([])
    assert (vc.traces, vc.misses, len(vc._calls)) == \
        (traces0, misses0, calls0)
    assert sum(c.replays for c in vc._calls.values()) > replays0


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_runtime_serve_on_the_card_graphed_equals_eager(cuda_device, case):
    """``TorchOnlineRuntime`` with ``VeltairPolicy`` in the loop, in
    virtual time, on the eager and the graphed engine (both warm, on the
    card): identical schedule and level traces, token streams and
    metrics; more than one level; the serve captures nothing; and one
    host sync per decode quantum and per finished prompt."""
    from repro_torch.core.scheduler import VeltairPolicy
    from repro_torch.serving.runtime import OnlineRuntime, Workload
    from repro_torch.serving.slo import AdmissionController
    from repro_torch.serving.tenants import build_paper_plans

    engines, _ = _graph_engines(case)
    plans = build_paper_plans(["resnet50", "googlenet"], cm.CPU_3990X)
    runs = []
    for eng in engines:
        assert eng.device.type == "cuda"
        traces0, syncs0 = eng.version_cache.traces, eng.host_syncs
        rt = OnlineRuntime(eng, VeltairPolicy(cm.CPU_3990X), plans,
                           cm.CPU_3990X,
                           admission=AdmissionController()
                           if eng.paged else None)
        m = rt.serve(Workload.bursty(
            ["resnet50", "googlenet"], 900, 12, prompt_len=20,
            prompt_len_spread=15, max_new_tokens=6, seed=3,
            tiers={"resnet50": "interactive", "googlenet": "batch"}))
        assert eng.version_cache.traces == traces0
        decodes = sum(ev[0] == "decode" for ev in rt.sched_trace)
        assert eng.host_syncs - syncs0 == decodes + m.n_queries
        runs.append((rt.sched_trace, rt.level_trace, rt.outputs,
                     m.n_queries, m.avg_latency_s, m.qos_rate))
    assert runs[0] == runs[1]
    assert len({cm.level_to_idx(x) for x in runs[1][1]}) > 1
