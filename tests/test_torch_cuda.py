"""The port's CUDA kernels on the card (skipped without one).

The hand-written kernels have no CPU mode, so these tests need an NVIDIA
GPU.  This file imports nothing of JAX, so it runs on a machine that has
PyTorch for CUDA and no JAX:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the kernels and their plain versions both accumulate in fp32
and round the output to bf16 once; they differ only in summation order,
so at most a rounding flip of the bf16 output (2e-2 relative and
absolute covers one bf16 ulp at the values drawn here).  The whole model
compares logits after three residual layers of bf16 activations at 5e-2.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.kernels import block_matmul as bm  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.ref import attention_ref, matmul_ref  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.engine import (H100_LEVEL_TILES, Request,  # noqa: E402
                                        ServingEngine)

KERNEL_TOL = 2e-2
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
