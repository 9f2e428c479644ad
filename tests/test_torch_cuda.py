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
Under autograd, B1's custom op (forward, dX and dW, each one launch) is
held at the training shapes against autograd of its plain version at
the same 2e-2, B2's and B4's gradients equal their plain versions'
exactly (they are those gradients), and B3 raises.
"""
import dataclasses

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
        # the block is the engine's, on the engine's stream
        eng.stream.synchronize()
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


# ---------------------------------------------------------------------------
# The H100 spec, its version space and the co-location cluster


@pytest.mark.cuda
def test_h100_spec_agrees_with_the_card_and_its_tiles_fit(cuda_device):
    from repro_torch.configs import get_config, get_shape
    from repro_torch.core import schedule_space as ss
    from repro_torch.core.profiles import lm_layers

    hw = cm.hardware_spec_for(cuda_device)
    props = torch.cuda.get_device_properties(cuda_device)
    assert hw is cm.H100_SXM and hw.n_units == props.multi_processor_count
    tiles = set()
    for arch in ("gemma-2b", "starcoder2-3b", "mamba2-780m"):
        for shape in ("prefill_32k", "decode_32k"):
            for layer in lm_layers(get_config(arch), get_shape(shape)):
                tiles |= {(v.bm, v.bk, v.bn)
                          for v in ss.enumerate_versions(layer, hw)}
    assert tiles
    for t in sorted(tiles):
        assert 0 <= bm.smem_bytes(*t) <= hw.private_cache_bytes, t


@pytest.mark.cuda
def test_cuda_engine_refuses_a_version_set_of_unbuilt_tiles(cuda_device):
    from repro_torch.serving.tenants import cluster_plan

    cfg = get_reduced_config("gemma-2b")
    params = Model(cfg).init(torch.Generator(device=cuda_device)
                             .manual_seed(0), cuda_device)
    cpu_plan = cluster_plan("gemma-2b", cm.CPU_3990X)
    with pytest.raises(ValueError, match="not built for"):
        ServingEngine(cfg, params, batch_slots=2, max_len=32,
                      device=cuda_device,
                      version_sets=cpu_plan.version_sets)
    card_plan = cluster_plan("gemma-2b", cm.H100_SXM)
    eng = ServingEngine(cfg, params, batch_slots=2, max_len=32,
                        device=cuda_device,
                        version_sets=card_plan.version_sets)
    assert eng.tiles_for_level(1.0)["matmul"]["bk"] in bm.BK_CHOICES


def two_version_plans(plans: dict, hw, tile=(128, 32, 64),
                      from_level: int = 2) -> dict:
    """Each plan with its tile source's version set (the layer of the
    largest solo-version FLOPs, as the engine picks it) holding a second
    built tile, selected from grid level ``from_level`` up: the H100
    plans select one version at every level, so a serve under them never
    switches."""
    from repro_torch.core import schedule_space as ss

    out = {}
    for arch, plan in plans.items():
        vsets = list(plan.version_sets)
        i = max(range(len(vsets)),
                key=lambda j: vsets[j].solo_version().flops)
        second = next(v for v in ss.enumerate_versions(plan.layers[i], hw)
                      if (v.bm, v.bk, v.bn) == tile)
        vsets[i] = dataclasses.replace(
            vsets[i], versions=[vsets[i].solo_version(), second],
            level_table=[0] * from_level
            + [1] * (cm.NUM_LEVELS - from_level))
        out[arch] = dataclasses.replace(plan, version_sets=vsets)
    return out


@pytest.mark.cuda
def test_cluster_on_streams_of_its_own_serves_the_one_stream_streams(
        cuda_device):
    """A reduced two-engine cluster (gemma-2b, mamba2-780m) on the card
    whose plans hold two versions each: each engine on a stream of its
    own, then the same weights on one shared stream; virtual-time serves
    switch every engine's version mid-serve and give identical traces
    and token streams."""
    from repro_torch.core.scheduler import VeltairPolicy
    from repro_torch.serving.cluster import ClusterRuntime, build_cluster
    from repro_torch.serving.runtime import Workload
    from repro_torch.serving.tenants import cluster_plans

    archs = ["gemma-2b", "mamba2-780m"]
    hw = cm.H100_SXM
    plans = two_version_plans(cluster_plans(archs, hw), hw)
    shared = torch.cuda.Stream(cuda_device)
    runs, params = [], None
    for stream in (None, shared):
        tenants = build_cluster(archs, hw, batch_slots=2, max_len=64, seed=0,
                                device=cuda_device, plans=plans,
                                params=params, stream=stream)
        params = {t.name: t.engine.params for t in tenants}
        streams = {t.engine.stream for t in tenants}
        assert len(streams) == (len(archs) if stream is None else 1)
        rt = ClusterRuntime(tenants, VeltairPolicy(hw), hw)
        rt.warmup()
        builds = [t.engine.version_cache.traces for t in tenants]
        wl = Workload.poisson(archs, 200, 8, prompt_len=20,
                              prompt_len_spread=15, max_new_tokens=6, seed=1)
        m = rt.serve(wl)
        torch.cuda.synchronize()
        assert m.aggregate.n_queries == wl.n_queries
        assert [t.engine.version_cache.traces for t in tenants] == builds
        for t in tenants:
            ran = {str(t.engine.tiles_for_level(lv))
                   for lv in m.level_traces[t.name]}
            assert len(ran) == 2, (t.name, ran)
        runs.append((rt.outputs, rt.sched_trace, m.partition_trace))
    assert runs[0] == runs[1]


# ---------------------------------------------------------------------------
# Speculative decode quanta


def _one_step_logits(model, params, tokens, dev):
    """Logits after ``tokens`` on the plain path: a prefill of all but the
    last token, then one decode step with it."""
    toks = torch.as_tensor(tokens, dtype=torch.int64, device=dev)
    n = len(tokens) - 1
    row = model.init_cache(1, 64, dev)
    model.prefill(params, {"tokens": toks[None, :n]}, row)
    logits, _ = model.decode_step(params, {"tokens": toks[n:]}, row,
                                  torch.tensor([n], device=dev))
    return logits[0].float()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma-2b", "mamba2-780m"])
def test_spec_engine_on_the_card_serves_the_plain_streams(cuda_device, arch):
    """Reduced models, graphed: the speculative engine's streams are the
    plain engine's (a parting only at a tie of the plain logits within
    two bf16 ulps); every verify launches B2 once per layer (gemma-2b) or
    B4 twice per layer (mamba2: pass 1 and the restore pass) and costs
    one host sync; nothing is captured after warmup."""
    cfg = get_reduced_config(arch)
    model = Model(cfg)
    params = model.init(torch.Generator(device=cuda_device).manual_seed(0),
                        cuda_device)
    rng = np.random.default_rng(1)
    prompts = [np.full(n, int(rng.integers(cfg.vocab_size)), np.int32)
               for n in (6, 11)]
    prompts += [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                for n in (9, 4)]
    counter = fa.LAUNCHES if cfg.ssm is None else ssd.LAUNCHES
    per_verify = cfg.num_layers * (1 if cfg.ssm is None else 2)
    streams, verifies = {}, 0
    for spec in (False, True):
        eng = ServingEngine(cfg, params, batch_slots=2, max_len=64,
                            device=cuda_device, speculative=spec)
        eng.warmup(levels=[cm.grid_point(0), cm.grid_point(9)])
        builds = eng.version_cache.traces
        reqs = [Request(rid=i, prompt=p, max_new_tokens=24)
                for i, p in enumerate(prompts)]
        pending = list(reqs)
        for i in range(400):
            if all(r.done for r in reqs):
                break
            while pending and eng.admit_request(pending[0], drain=True):
                pending.pop(0)
            eng.set_interference_level(cm.grid_point(0 if i % 2 else 9))
            torch.cuda.synchronize()
            launches0, syncs0 = sum(counter.values()), eng.host_syncs
            handle = eng.begin_quantum(4)
            eng.finish_quantum(handle)
            torch.cuda.synchronize()
            if handle is not None and handle.kind == "spec":
                verifies += 1
                assert sum(counter.values()) - launches0 == per_verify
                assert eng.host_syncs == syncs0 + 1
        assert all(r.done for r in reqs)
        assert eng.version_cache.traces == builds
        streams[spec] = [list(r.output) for r in reqs]
    assert verifies > 0
    for rid, (got, want) in enumerate(zip(streams[True], streams[False])):
        if got == want:
            continue
        t = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        lg = _one_step_logits(model, params, np.concatenate(
            [prompts[rid], np.asarray(want[:t], np.int32)]), cuda_device)
        top = lg.topk(2).values.tolist()
        ulp2 = 2.0 ** (np.floor(np.log2(abs(top[0]))) - 6)
        assert top[0] - top[1] <= ulp2, (rid, t, top)
        assert min(lg[got[t]].item(), lg[want[t]].item()) >= top[0] - ulp2


# ---------------------------------------------------------------------------
# the hybrid (recurrentgemma-2b reduced: RG-LRU + a ring of window 32)
# ---------------------------------------------------------------------------
def _hybrid_engines(**kw):
    """An eager and a graphed engine on the same reduced hybrid weights,
    both warm (the monolithic prompt lengths warmed too)."""
    cfg = get_reduced_config("recurrentgemma-2b")
    params = Model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    engines = [ServingEngine(cfg, params, batch_slots=2, max_len=64,
                             cuda_graphs=graphs, **kw)
               for graphs in (False, True)]
    for eng in engines:
        eng.warmup(prompt_lens=(3, 17, 39))
    prompt = np.arange(1, 41, dtype=np.int32) * 7 % cfg.vocab_size
    return cfg, engines, [prompt[:n] for n in (3, 39, 17)]


@pytest.mark.cuda
@pytest.mark.parametrize("chunked", [True, False])
def test_hybrid_graphed_engine_serves_the_eager_streams(cuda_device,
                                                        chunked):
    """Eager and graphed hybrid engines: identical streams and launch
    counts, nothing captured after warmup; ``block_matmul`` runs 3 times
    per layer in every decode step and chunk, ``flash_attention`` only in
    a monolithic prefill (once per attention layer: the 39-token prompt
    wraps the 32-slot ring), the paged and SSD kernels never."""
    cfg, engines, prompts = _hybrid_engines(chunked_prefill=chunked)
    n_attn = cfg.num_layers // 3
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
        got = [a - b for a, b in zip(_launches(), before)]
        chunks = eng.prefill_chunks
        assert got[1] == (0 if chunked else 3 * n_attn), got
        assert got[2:] == [0, 0], got
        assert got[0] % (3 * cfg.num_layers) == 0, got
        if chunked:
            assert chunks > 3
        results.append(([r.output for r in reqs], got))
    assert results[0] == results[1]


@pytest.mark.cuda
def test_hybrid_monolithic_and_chunked_caches_agree(cuda_device):
    """One 39-token prompt prefilled monolithically (``flash_attention``
    under the window, then the ring filled) and in 16-token chunks (the
    ring wraps): logits within LOGIT_TOL, ring positions equal."""
    cfg = get_reduced_config("recurrentgemma-2b")
    model = Model(cfg)
    params = model.init(torch.Generator(device=cuda_device).manual_seed(1),
                        cuda_device)
    prompt = torch.arange(1, 40, device=cuda_device) * 7 % cfg.vocab_size
    mono = model.init_cache(1, 64, cuda_device)
    want, _ = model.prefill(params, {"tokens": prompt[None]}, mono)
    chunked = model.init_cache(1, 64, cuda_device)
    for t0 in range(0, 39, 16):
        toks = torch.zeros(16, dtype=torch.int64, device=cuda_device)
        valid = min(16, 39 - t0)
        toks[:valid] = prompt[t0:t0 + valid]
        got, _ = model.prefill_chunk(params, {"tokens": toks[None]},
                                     chunked, t0, valid)
    torch.testing.assert_close(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    assert torch.equal(chunked["blocks"]["attn_local_2"]["pos"],
                       mono["blocks"]["attn_local_2"]["pos"])


@pytest.mark.cuda
@pytest.mark.parametrize("level", [0, len(H100_LEVEL_TILES) - 1])
def test_flash_attention_at_group_10_with_a_binding_window(cuda_device,
                                                           level):
    """recurrentgemma-2b's 10 query heads over one KV head at D 256 (10
    flattened rows a query): a prefill longer than its window, and 16-row
    chunks at per-row offsets under the window, against the plain
    version."""
    g = torch.Generator(device=cuda_device).manual_seed(10 + level)
    tiles = H100_LEVEL_TILES[level]["attention"]
    for b, s, t, offs, window in ((1, 300, 300, [0], 128),
                                  (4, 16, 512, [68, 140, 260, 300], 100)):
        q = torch.randn(b, s, 10, 256, generator=g,
                        device=cuda_device).bfloat16()
        kk = torch.randn(b, t, 1, 256, generator=g,
                         device=cuda_device).bfloat16()
        v = torch.randn(b, t, 1, 256, generator=g,
                        device=cuda_device).bfloat16()
        off = torch.tensor(offs, device=cuda_device)
        kvl = off + s
        got = fa.flash_attention(q, kk, v, offset=off, kv_valid_len=kvl,
                                 window=window, **tiles)
        want = attention_ref(q, kk, v, offset=off, kv_valid_len=kvl,
                             window=window)
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=KERNEL_TOL, atol=KERNEL_TOL)
        assert torch.equal(got, fa.flash_attention(
            q, kk, v, offset=off, kv_valid_len=kvl, window=window, **tiles))


# ---------------------------------------------------------------------------
# the moe family (deepseek-v2-lite-16b: MLA latent cache, capacity MoE)
# ---------------------------------------------------------------------------
# deepseek-v2-lite-16b's B1 GEMMs (K, N): layer 0's dense MLP (N 10944:
# the last tile of 128 ragged; K 10944: 171 tiles of 64, uneven split-K
# ranges) and the shared experts' (2816 = 22 tiles of 128)
MOE_GEMMS = ((2048, 10944), (10944, 2048), (2048, 2816), (2816, 2048))


@pytest.mark.cuda
@pytest.mark.parametrize("level", range(len(H100_LEVEL_TILES)))
def test_block_matmul_at_deepseek_shapes(cuda_device, level):
    """B1 at deepseek's four GEMMs at a decode step's, a chunk's and a
    verify's M under each level's tile: against the plain version, and
    bit for bit across two launches."""
    g = torch.Generator(device=cuda_device).manual_seed(30 + level)
    tiles = H100_LEVEL_TILES[level]["matmul"]
    for m in (4, 16, 20):
        for k, n in MOE_GEMMS:
            x = torch.randn(m, k, generator=g, device=cuda_device).bfloat16()
            w = (torch.randn(k, n, generator=g, device=cuda_device)
                 * k ** -0.5).bfloat16()
            got = bm.block_matmul_2d(x, w, **tiles)
            torch.testing.assert_close(got.float(),
                                       matmul_ref(x, w).float(),
                                       rtol=KERNEL_TOL, atol=KERNEL_TOL)
            assert torch.equal(got, bm.block_matmul_2d(x, w, **tiles))


def _moe_engines(clone=False, **kw):
    """Engines on reduced deepseek weights (or its MoE-free clone: every
    layer MLA and a dense MLP), both warm: eager and graphed, or as
    ``kw`` asks."""
    cfg = get_reduced_config("deepseek-v2-lite-16b")
    if clone:
        cfg = dataclasses.replace(cfg, name=cfg.name + "-mla-only",
                                  first_dense_layers=cfg.num_layers)
    params = Model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    variants = kw.pop("variants", ({"cuda_graphs": False},
                                   {"cuda_graphs": True}))
    engines = [ServingEngine(cfg, params, batch_slots=2, max_len=64,
                             **kw, **v) for v in variants]
    for eng in engines:
        eng.warmup()
    prompt = np.arange(1, 41, dtype=np.int32) * 7 % cfg.vocab_size
    return cfg, engines, [prompt[:n] for n in (3, 39, 17)]


def _serve_moe(eng, prompts):
    vc = eng.version_cache
    traces0, before = vc.traces, _launches()
    reqs = [Request(rid=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(prompts)]
    assert eng.admit_request(reqs[1], drain=True)
    assert eng.admit_request(reqs[2], drain=True)
    eng.run_to_completion([reqs[0]])
    assert all(r.done and len(r.output) == 7 for r in reqs)
    assert vc.traces == traces0
    return [r.output for r in reqs], [a - b for a, b in
                                      zip(_launches(), before)]


@pytest.mark.cuda
def test_deepseek_graphed_engine_serves_the_eager_streams(cuda_device):
    """Eager and graphed engines on reduced deepseek: identical streams
    and launch counts, nothing captured after warmup; ``block_matmul``
    runs 3 GEMMs for the dense layer and 3 for each block's shared experts
    in every forward pass (9 here), the attention, paged and SSD kernels
    never (MLA is plain ops)."""
    cfg, engines, prompts = _moe_engines()
    results = [_serve_moe(eng, prompts) for eng in engines]
    for _, got in results:
        assert got[0] > 0 and got[0] % (3 * cfg.num_layers) == 0, got
        assert got[1:] == [0, 0, 0], got
    assert results[0] == results[1]


@pytest.mark.cuda
def test_mla_clone_paged_engine_serves_the_dense_streams(cuda_device):
    """On the MoE-free clone (no router to flip), a paged graphed engine
    (pages of 8, the latents gathered through the table; the prompts share
    a prefix, so it prefills fewer chunks) serves the dense graphed
    engine's streams, with no attention-kernel launch."""
    cfg, engines, prompts = _moe_engines(
        clone=True, variants=({}, {"page_size": 8}))
    (dense, dl), (paged, pl) = (_serve_moe(eng, prompts) for eng in engines)
    assert paged == dense
    for got in (dl, pl):
        assert got[0] > 0 and got[0] % (3 * cfg.num_layers) == 0, got
        assert got[1:] == [0, 0, 0], got
    assert engines[1].page_stats["shared_hits"] > 0
    assert engines[1].pool.used_pages == 0


# the GEMMs of the configs registered with the dense-residual MoE:
# arctic-480b's dense residual (7168 <-> 4864), llama3-405b's MLP (16384
# <-> 53248: 416 N tiles of 128, 832 K tiles of 64), minicpm-2b's (2304
# <-> 5760: 36 and 90 K tiles, uneven across a cluster of 8)
LATE_GEMMS = ((7168, 4864), (4864, 7168), (16384, 53248), (53248, 16384),
              (2304, 5760), (5760, 2304))
# their attention (query heads, KV heads, head_dim): KV groups of 7, 16, 1
LATE_HEADS = [(56, 8, 128), (128, 8, 128), (36, 36, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("level", range(len(H100_LEVEL_TILES)))
def test_block_matmul_at_the_late_configs_shapes(cuda_device, level):
    """B1 at the six GEMMs at a decode step's, a chunk's and a verify's M
    under each level's tile: against the plain version, and bit for bit
    across two launches."""
    g = torch.Generator(device=cuda_device).manual_seed(40 + level)
    tiles = H100_LEVEL_TILES[level]["matmul"]
    for k, n in LATE_GEMMS:
        w = (torch.randn(k, n, generator=g, device=cuda_device)
             * k ** -0.5).bfloat16()
        for m in (4, 16, 20):
            x = torch.randn(m, k, generator=g, device=cuda_device).bfloat16()
            got = bm.block_matmul_2d(x, w, **tiles)
            torch.testing.assert_close(got.float(),
                                       matmul_ref(x, w).float(),
                                       rtol=KERNEL_TOL, atol=KERNEL_TOL)
            assert torch.equal(got, bm.block_matmul_2d(x, w, **tiles))


@pytest.mark.cuda
@pytest.mark.parametrize("level", [0, len(H100_LEVEL_TILES) - 1])
@pytest.mark.parametrize("h,kh,d", LATE_HEADS)
def test_flash_attention_at_kv_groups_1_7_and_16(cuda_device, h, kh, d,
                                                 level):
    """B2 at G = 7 (a 64-row tile splits a query position's heads), 16 (a
    16-token chunk is 256 rows: four tiles) and 1 (one row a block at
    decode): decode rows at positions 0 and 511, 16-token chunks and a
    verify of 5 queries a row, against the plain version and bit for bit
    across two launches."""
    g = torch.Generator(device=cuda_device).manual_seed(h + kh + level)
    tiles = H100_LEVEL_TILES[level]["attention"]
    for b, s, offs in ((4, 1, [0, 100, 300, 511]), (2, 16, [32, 240]),
                       (4, 5, [68, 140, 260, 300])):
        q = torch.randn(b, s, h, d, generator=g,
                        device=cuda_device).bfloat16()
        kk = torch.randn(b, 512, kh, d, generator=g,
                         device=cuda_device).bfloat16()
        v = torch.randn(b, 512, kh, d, generator=g,
                        device=cuda_device).bfloat16()
        off = torch.tensor(offs, device=cuda_device)
        kw = dict(offset=off, kv_valid_len=off + s, **tiles)
        got = fa.flash_attention(q, kk, v, **kw)
        want = attention_ref(q, kk, v, offset=off, kv_valid_len=off + s)
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=KERNEL_TOL, atol=KERNEL_TOL)
        assert torch.equal(got, fa.flash_attention(q, kk, v, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("h,kh,d", LATE_HEADS)
def test_flash_attention_paged_at_kv_groups_1_7_and_16(cuda_device, h, kh,
                                                       d):
    """B3 at the three groups over shuffled pages of 16: a decode step and
    a verify of 5 queries a row (at G 16 that is 80 rows: two row tiles
    in one launch), against the plain version and bit for bit across two
    launches."""
    g = torch.Generator(device=cuda_device).manual_seed(h + kh)
    kvl = [5, 37, 300, 512]
    _, kp, vp, table = _paged_inputs(g, cuda_device, 4, kh, 16, kvl, d=d,
                                     h=h)
    kvl_t = torch.tensor(kvl, dtype=torch.int32, device=cuda_device)
    for s in (1, 5):
        # llama3-405b's verify: 80 flattened rows, two row tiles
        assert (s * (h // kh) > fa.MAX_ROWS) == (s == 5 and h // kh == 16)
        q = torch.randn(4, s, h, d, generator=g,
                        device=cuda_device).bfloat16()
        kw = dict(offset=kvl_t - s, kv_valid_len=kvl_t)
        got = fap.flash_attention_paged(q, kp, vp, table, **kw)
        want = paged_attention_ref(q, kp, vp, table, **kw)
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=KERNEL_TOL, atol=KERNEL_TOL)
        assert torch.equal(got, fap.flash_attention_paged(q, kp, vp, table,
                                                          **kw))


@pytest.mark.cuda
def test_arctic_graphed_engine_serves_the_eager_streams(cuda_device):
    """Eager and graphed engines on reduced arctic-480b (dense residual
    beside 4 experts, top-2): identical streams and launch counts, nothing
    captured after warmup; every forward pass launches B1 3 times and B2
    once a layer, B3 and B4 never."""
    cfg = get_reduced_config("arctic-480b")
    params = Model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    engines = [ServingEngine(cfg, params, batch_slots=2, max_len=64,
                             cuda_graphs=graphs) for graphs in (False, True)]
    for eng in engines:
        eng.warmup()
    prompt = np.arange(1, 41, dtype=np.int32) * 7 % cfg.vocab_size
    prompts = [prompt[:n] for n in (3, 39, 17)]
    results = [_serve_moe(eng, prompts) for eng in engines]
    n = cfg.num_layers
    for _, got in results:
        assert got[0] > 0 and got[0] % (3 * n) == 0, got
        assert got[1] == got[0] // 3 and got[2:] == [0, 0], got
    assert results[0] == results[1]


# the frontend configs: qwen2-vl-2b's gated MLP (1536 <-> 8960: K 8960 is
# 140 tiles of 64, uneven across a cluster of 8) and musicgen-large's
# plain gelu MLP with biases (2048 <-> 8192)
FRONT_GEMMS = ((1536, 8960), (8960, 1536), (2048, 8192), (8192, 2048))
# their attention (query heads, KV heads, head_dim): qwen2-vl-2b's G 6
# (a 16-token chunk is 96 rows: at a 64-row tile position 10's six heads
# straddle the tile edge) and musicgen-large's MHA, G 1
FRONT_HEADS = [(12, 2, 128), (32, 32, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("level", range(len(H100_LEVEL_TILES)))
def test_block_matmul_at_the_frontend_configs_shapes(cuda_device, level):
    """B1 at the four GEMMs at a decode step's, a chunk's and a verify's M
    under each level's tile, against the plain version and bit for bit
    across two launches; then musicgen-large's whole MLP (biases added
    outside the kernel, as ``apply_mlp`` adds them) through the kernel
    against its plain version."""
    from repro_torch.kernels import dispatch
    from repro_torch.models import layers as L
    g = torch.Generator(device=cuda_device).manual_seed(60 + level)
    tiles = H100_LEVEL_TILES[level]["matmul"]
    for k, n in FRONT_GEMMS:
        w = (torch.randn(k, n, generator=g, device=cuda_device)
             * k ** -0.5).bfloat16()
        for m in (4, 16, 20):
            x = torch.randn(m, k, generator=g, device=cuda_device).bfloat16()
            got = bm.block_matmul_2d(x, w, **tiles)
            torch.testing.assert_close(got.float(),
                                       matmul_ref(x, w).float(),
                                       rtol=KERNEL_TOL, atol=KERNEL_TOL)
            assert torch.equal(got, bm.block_matmul_2d(x, w, **tiles))
    mlp = {"w_up": (torch.randn(2048, 8192, generator=g, device=cuda_device)
                    * 2048 ** -0.5).bfloat16(),
           "b_up": torch.randn(8192, generator=g, device=cuda_device),
           "w_down": (torch.randn(8192, 2048, generator=g,
                                  device=cuda_device) * 8192 ** -0.5
                      ).bfloat16(),
           "b_down": torch.randn(2048, generator=g, device=cuda_device)}
    x = torch.randn(4, 5, 2048, generator=g, device=cuda_device).bfloat16()
    before = bm.launch_count()
    with dispatch.tile_context({"matmul": tiles}):
        got = L.apply_mlp(mlp, x, "gelu")
    assert bm.launch_count() == before + 2
    want = L.apply_mlp(mlp, x, "gelu", use_kernel_hook=False)
    torch.testing.assert_close(got.float(), want.float(), rtol=KERNEL_TOL,
                               atol=KERNEL_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("level", [0, len(H100_LEVEL_TILES) - 1])
@pytest.mark.parametrize("h,kh,d", FRONT_HEADS)
def test_flash_attention_at_the_frontend_configs_heads(cuda_device, h, kh,
                                                       d, level):
    """B2 at G 6 / D 128 and G 1 / D 64: decode rows at positions 0 and
    511, 16-token chunks (at G 6 two row tiles at level 0, position 10
    split across them) and a verify of 5 queries a row, against the plain
    version and bit for bit across two launches."""
    g = torch.Generator(device=cuda_device).manual_seed(h + kh + level)
    tiles = H100_LEVEL_TILES[level]["attention"]
    if (h, kh, level) == (12, 2, 0):
        (tbq, _), _, _ = fa.launch_geometry(2, 16, h, kh, 512, **tiles)
        assert tbq == 64 and -(-16 * 6 // tbq) == 2 and 64 % 6 != 0
    for b, s, offs in ((4, 1, [0, 100, 300, 511]), (2, 16, [32, 240]),
                       (4, 5, [68, 140, 260, 300])):
        q = torch.randn(b, s, h, d, generator=g,
                        device=cuda_device).bfloat16()
        kk = torch.randn(b, 512, kh, d, generator=g,
                         device=cuda_device).bfloat16()
        v = torch.randn(b, 512, kh, d, generator=g,
                        device=cuda_device).bfloat16()
        off = torch.tensor(offs, device=cuda_device)
        kw = dict(offset=off, kv_valid_len=off + s, **tiles)
        got = fa.flash_attention(q, kk, v, **kw)
        want = attention_ref(q, kk, v, offset=off, kv_valid_len=off + s)
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=KERNEL_TOL, atol=KERNEL_TOL)
        assert torch.equal(got, fa.flash_attention(q, kk, v, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("h,kh,d", FRONT_HEADS)
def test_flash_attention_paged_at_the_frontend_configs_heads(cuda_device, h,
                                                             kh, d):
    """B3 at G 6 / D 128 and G 1 / D 64 over shuffled pages of 16: a
    decode step and a verify of 5 queries a row (30 rows at G 6), against
    the plain version and bit for bit across two launches."""
    g = torch.Generator(device=cuda_device).manual_seed(h + kh + 1)
    kvl = [5, 37, 300, 512]
    _, kp, vp, table = _paged_inputs(g, cuda_device, 4, kh, 16, kvl, d=d,
                                     h=h)
    kvl_t = torch.tensor(kvl, dtype=torch.int32, device=cuda_device)
    for s in (1, 5):
        q = torch.randn(4, s, h, d, generator=g,
                        device=cuda_device).bfloat16()
        kw = dict(offset=kvl_t - s, kv_valid_len=kvl_t)
        got = fap.flash_attention_paged(q, kp, vp, table, **kw)
        want = paged_attention_ref(q, kp, vp, table, **kw)
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=KERNEL_TOL, atol=KERNEL_TOL)
        assert torch.equal(got, fap.flash_attention_paged(q, kp, vp, table,
                                                          **kw))


@pytest.mark.cuda
def test_qwen2_vl_graphed_engine_serves_the_eager_streams(cuda_device):
    """Eager and graphed engines on reduced qwen2-vl-2b (M-RoPE, G 2):
    identical streams and launch counts, nothing captured after warmup;
    every forward pass launches B1 3 times and B2 once a layer, B3 and
    B4 never."""
    cfg = get_reduced_config("qwen2-vl-2b")
    params = Model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    engines = [ServingEngine(cfg, params, batch_slots=2, max_len=64,
                             cuda_graphs=graphs) for graphs in (False, True)]
    for eng in engines:
        eng.warmup()
    prompt = np.arange(1, 41, dtype=np.int32) * 7 % cfg.vocab_size
    prompts = [prompt[:n] for n in (3, 39, 17)]
    results = [_serve_moe(eng, prompts) for eng in engines]
    n = cfg.num_layers
    for _, got in results:
        assert got[0] > 0 and got[0] % (3 * n) == 0, got
        assert got[1] == got[0] // 3 and got[2:] == [0, 0], got
    assert results[0] == results[1]


# gemma-2b's MLP GEMMs at a training microbatch of 2 x 512 tokens: gate/up
# (1024, 2048) @ (2048, 16384), down (1024, 16384) @ (16384, 2048)
TRAIN_GEMMS = ((1024, 2048, 16384), (1024, 16384, 2048))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", TRAIN_GEMMS)
def test_block_matmul_autograd_at_the_training_shapes(cuda_device, m, k, n):
    """B1's custom op: the output, dX and dW against autograd of the plain
    version, each product one launch (three in all)."""
    g = torch.Generator(device=cuda_device).manual_seed(m + n)
    x = torch.randn(m, k, generator=g, device=cuda_device).bfloat16()
    w = (torch.randn(k, n, generator=g, device=cuda_device)
         * k ** -0.5).bfloat16()
    dy = torch.randn(m, n, generator=g, device=cuda_device).bfloat16()
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    xp, wp = x.clone().requires_grad_(), w.clone().requires_grad_()
    before = bm.launch_count()
    got = bm.block_matmul_2d(xa, wa)
    got.backward(dy)
    assert bm.launch_count() == before + 3
    want = matmul_ref(xp, wp)
    want.backward(dy)
    for a, b in ((got, want), (xa.grad, xp.grad), (wa.grad, wp.grad)):
        torch.testing.assert_close(a.float(), b.float(), rtol=KERNEL_TOL,
                                   atol=KERNEL_TOL)
    with torch.no_grad():
        before = bm.launch_count()
        assert bm.block_matmul_2d(xa, wa).grad_fn is None
        assert bm.launch_count() == before + 1


@pytest.mark.cuda
def test_flash_attention_autograd_on_the_card(cuda_device):
    """B2 forward (one launch) with the plain version's gradient: the
    output within KERNEL_TOL of the plain one, the grads those of the
    plain version's autograd (at the kernel's inputs: the same formula)."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    q, k, v = (torch.randn(2, 64, h, 256, generator=g,
                           device=cuda_device).bfloat16().requires_grad_()
               for h in (8, 1, 1))
    before = fa.launch_count()
    got = fa.flash_attention(q, k, v, offset=0, kv_valid_len=64)
    assert fa.launch_count() == before + 1
    dy = torch.randn(got.shape, generator=g, device=cuda_device).bfloat16()
    got.backward(dy)
    ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    want = attention_ref(*ins, offset=0, kv_valid_len=64)
    want.backward(dy)
    torch.testing.assert_close(got.float(), want.float(), rtol=KERNEL_TOL,
                               atol=KERNEL_TOL)
    for a, b in zip((q, k, v), ins):
        assert torch.equal(a.grad, b.grad)
    assert fa.launch_count() == before + 1


@pytest.mark.cuda
def test_paged_attention_raises_under_grad(cuda_device):
    """B3 has no gradient path (it lies on no training path): on the card
    it raises rather than return an output autograd would take for a
    constant."""
    q = torch.zeros(1, 1, 2, 64, device=cuda_device,
                    dtype=torch.bfloat16).requires_grad_()
    pool = torch.zeros(3, 16, 1, 64, device=cuda_device, dtype=torch.bfloat16)
    table = torch.ones(1, 2, device=cuda_device, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="gradient"):
        fap.flash_attention_paged(q, pool, pool, table, offset=0,
                                  kv_valid_len=1)
    with torch.no_grad():
        fap.flash_attention_paged(q, pool, pool, table, offset=0,
                                  kv_valid_len=1)


# mamba2-780m's training shapes (a microbatch of 2 x 512 tokens, 48 heads
# of 64, B and C in one group of 128, chunks of 256), and a ragged one
# (L no multiple of the chunk, G 2 < H 4, a carried state)
SSD_GRAD_CASES = [(2, 512, 48, 64, 1, 128, 256, False),
                  (2, 37, 4, 32, 2, 16, 16, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,l,h,p,g,n,chunk,with_init", SSD_GRAD_CASES)
def test_ssd_scan_autograd_on_the_card(cuda_device, bsz, l, h, p, g, n,
                                       chunk, with_init):
    """B4 forward (one launch) with the plain version's gradient against
    both outputs: y and the state within the kernel tolerances of the
    plain ones, every input's gradient that of the plain version's
    autograd at the kernel's inputs (the same formula), bit for bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(l + h)
    x, dt, a, b, c, h0 = _ssd_inputs(gen, cuda_device, bsz, l, h, p, n,
                                     with_init)
    b, c = b[:, :, :g].contiguous(), c[:, :, :g].contiguous()
    ins = [t for t in (x, dt, a, b, c, h0) if t is not None]
    got_in = [t.clone().requires_grad_() for t in ins]
    want_in = [t.clone().requires_grad_() for t in ins]
    init = (lambda t: t[5] if with_init else None)
    before = ssd.launch_count()
    y, state = ssd.ssd_scan(*got_in[:5], chunk_size=chunk,
                            initial_state=init(got_in))
    assert ssd.launch_count() == before + 1
    dy = torch.randn(y.shape, generator=gen, device=cuda_device).bfloat16()
    ds = torch.randn(state.shape, generator=gen, device=cuda_device)
    torch.autograd.backward([y, state], [dy, ds])
    assert ssd.launch_count() == before + 1
    want_y, want_s = ssd_ref(*want_in[:5], chunk_size=chunk,
                             initial_state=init(want_in))
    torch.testing.assert_close(y.float(), want_y.float(), rtol=KERNEL_TOL,
                               atol=KERNEL_TOL)
    torch.testing.assert_close(
        state, want_s.detach(), rtol=0,
        atol=STATE_TOL * want_s.abs().max().item())
    torch.autograd.backward([want_y, want_s], [dy, ds])
    for got_t, want_t in zip(got_in, want_in):
        assert torch.equal(got_t.grad, want_t.grad)
    with torch.no_grad():
        before = ssd.launch_count()
        y, _ = ssd.ssd_scan(*got_in[:5], chunk_size=chunk,
                            initial_state=init(got_in))
        assert y.grad_fn is None and ssd.launch_count() == before + 1