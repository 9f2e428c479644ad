"""The split decompositions of the port's CUDA kernels, on the CPU.

``block_matmul`` splits K across the blocks of a thread-block cluster
(``split_k``) and ``flash_attention`` splits the visible KV tiles
(``split_kv``); both kernels cut a run of tiles with ``split_ranges``
and combine the parts in rank order inside the one launch.  The kernels
run only on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``);
here the split functions are checked for coverage and size, and a plain
emulation of each decomposition (used by these tests only) is held
against the kernel's plain version and the JAX reference
(``repro.kernels.ref``) at the tolerances of ``tests/test_torch_kernels.py``:

  * block_matmul: per-split fp32 partials summed in rank order, rounded
    once; fp32 at rtol 1e-4, atol 8e-4; bf16 at 2**-6 absolute and
    relative, the card's bound for the kernel against its plain version
    (both sum in fp32 and round once, so they may part by one bf16 ulp;
    a run of K tiles lost or counted twice moves outputs of ~N(0, 1) by
    far more).
  * flash_attention: per-split (m, l, acc) combined by the rescale
    algebra; fp32 at 2e-4 (online against one-pass softmax).  Rows with
    no visible key are compared with the plain version only (the JAX
    reference writes mean(v) there, the kernel contract 0).

  * flash_attention_paged: the dense kernel's split over keys read
    through the page table, only those some row can see (the pools'
    garbage never read); fp32 at 2e-4 against the plain version and the
    JAX paged kernel in interpret mode; a row with no visible key is 0.
  * ssd_scan: P split into blocks of 16 columns, B and C read per group,
    each block's fp32 operands of the three fp32-by-bf16 products fed as
    bf16 hi + lo; fp32 inputs at 2e-4 (the algebra of the split, against
    the Pallas kernel in interpret mode and ``ssd_ref``), bf16 inputs at
    2**-7 for y (one bf16 flip) and 2e-4 of the largest state entry for
    the fp32 state (``tests/test_torch_ssm.py``'s tolerances).

Also: ``cuda_build`` rebuilds a kernel when a header it includes changes.
"""
import inspect
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention_paged as jax_flash_attention_paged  # noqa: E402
from repro_torch.kernels import block_matmul as bm  # noqa: E402
from repro_torch.kernels import cuda_build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_attention_paged as fap  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.serving.engine import H100_LEVEL_TILES  # noqa: E402

# the serving path's GEMMs at full width (gemma-2b gate/up and down,
# starcoder2-3b's MLP), decode (M = 1, 4) and a prefill chunk (M = 16),
# and a K whose tiles do not divide evenly among a cluster
SERVE_GEMMS = [(m, k, n) for m in (1, 4, 16)
               for k, n in ((2048, 16384), (16384, 2048), (3072, 12288),
                            (12288, 3072), (16576, 2048))]


@pytest.mark.parametrize("n,parts", [(1, 1), (1, 8), (3, 8), (8, 8),
                                     (256, 8), (259, 8), (33, 4), (5, 2)])
def test_split_ranges_cover_the_run_in_order(n, parts):
    runs = bm.split_ranges(n, parts)
    assert len(runs) == min(n, parts)
    assert runs[0][0] == 0 and runs[-1][1] == n
    assert all(a < b for a, b in runs)                     # non-empty
    assert all(runs[i][1] == runs[i + 1][0] for i in range(len(runs) - 1))
    sizes = [b - a for a, b in runs]
    assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("level", range(len(H100_LEVEL_TILES)))
def test_split_k_fills_the_card_within_one_cluster(level):
    tiles = H100_LEVEL_TILES[level]["matmul"]
    for m, k, n in SERVE_GEMMS:
        tm, tk, tn = bm.effective_tiles(m, k, n, **tiles)
        split = bm.split_k(m, k, n, tm, tk, tn)
        assert split in (1, 2, 4, 8) and split <= bm.MAX_SPLIT
        k_tiles = -(-k // tk)
        blocks = -(-m // tm) * -(-n // tn) * split
        # every block of the cluster keeps a ring's worth of K tiles ...
        assert k_tiles >= bm.MIN_K_TILES * split
        runs = bm.split_ranges(k_tiles, split)
        assert len(runs) == split and runs[-1][1] == k_tiles
        # ... and the split stops once the card is full
        assert blocks >= bm.SMS or split == bm.MAX_SPLIT or \
            k_tiles < bm.MIN_K_TILES * 2 * split
        assert split == 1 or blocks // 2 < bm.SMS


def test_level0_down_projection_gets_128_blocks():
    tile, split, blocks = bm.launch_geometry(
        4, 16384, 2048, **H100_LEVEL_TILES[0]["matmul"])
    assert tile == (16, 64, 128) and split == 8 and blocks >= 128


def test_attention_launch_geometry_at_the_serve_shapes():
    level0 = H100_LEVEL_TILES[0]["attention"]
    # decode: 4 rows x 1 KV head, 8 flattened rows, 8 cache tiles of 64
    assert fa.launch_geometry(4, 1, 8, 1, 512, **level0) == ((8, 64), 8, 32)
    # a 16-token chunk: 128 flattened rows in 2 tiles of 64
    assert fa.launch_geometry(1, 16, 8, 1, 512, **level0) == \
        ((64, 64), 8, 16)
    # a short cache clamps the key tile to a power of two >= 16
    assert fa.launch_geometry(2, 3, 4, 2, 5, 64, 64) == ((6, 16), 1, 4)


def test_split_kv_at_the_serve_shapes():
    for level in H100_LEVEL_TILES:
        bkv = level["attention"]["bkv"]
        # decode: 4 rows, one KV head, one query tile of 8 flattened rows
        assert fa.split_kv(4, 1, 1, 512, bkv) == 8
        # a 16-token chunk of 128 flattened rows at bq 64/32/16
        q_tiles = -(-128 // level["attention"]["bq"])
        split = fa.split_kv(1, 1, q_tiles, 512, bkv)
        assert split <= 8 and (split == 8 or q_tiles * split >= fa.SMS)
    # few cache tiles cap the split; many blocks need none
    assert fa.split_kv(4, 1, 1, 64, 64) == 1
    assert fa.split_kv(4, 1, 1, 200, 64) == 4
    assert fa.split_kv(64, 2, 2, 4096, 64) == 1


def test_attention_smem_follows_the_kernel_layout():
    # 64 rows, 64-key tiles, D 256: the largest block of the level table
    assert fa.smem_bytes(64, 64, 256) == 205_568
    # rows pad to 16, 32 or 64: a decode tile of 8 rows costs 16
    assert fa.smem_bytes(8, 64, 256) == fa.smem_bytes(16, 64, 256)
    assert fa.smem_bytes(128, 128, 256) > fa.MAX_SMEM_BYTES


# --------------------------------------------------------------------------
# block_matmul: per-split fp32 partials summed in rank order
# --------------------------------------------------------------------------
def matmul_split_emulated(x, w, bk, split):
    """What the kernel computes: each rank's fp32 product over its run of
    K tiles, rank 0 adding ranks 1.. in order, one rounding at the end."""
    k_tiles = -(-x.shape[1] // bk)
    acc = None
    for a, b in bm.split_ranges(k_tiles, split):
        part = torch.matmul(x[:, a * bk:b * bk].float(),
                            w[a * bk:b * bk].float())
        acc = part if acc is None else acc + part
    return acc.to(x.dtype)


# (m, k, n, bk, split, dtype): ragged K, runs of unequal length
SPLIT_MATMUL_CASES = [
    (4, 512, 64, 32, None, "float32"),
    (4, 512, 64, 32, None, "bfloat16"),
    (3, 300, 17, 32, 8, "float32"),
    (16, 259 * 8, 24, 8, 8, "bfloat16"),
    (1, 70, 5, 16, 3, "bfloat16"),
    (5, 1000, 33, 64, 2, "float32"),
]


@pytest.mark.parametrize("m,k,n,bk,split,dtype", SPLIT_MATMUL_CASES)
def test_split_k_emulation_matches_plain_and_jax(m, k, n, bk, split, dtype):
    rng = np.random.default_rng(m * 100 + k + n)
    xn = rng.standard_normal((m, k)).astype(np.float32)
    wn = (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)
    td = getattr(torch, dtype)
    x, w = torch.from_numpy(xn).to(td), torch.from_numpy(wn).to(td)
    if split is None:   # the split the wrapper would launch
        tm, tk, tn = bm.effective_tiles(m, k, n, 16, bk, 32)
        split = bm.split_k(m, k, n, tm, tk, tn)
        assert split == 4
    got = matmul_split_emulated(x, w, bk, split)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want_jax = np.asarray(jax_ref.matmul_ref(jnp.asarray(xn, jd),
                                             jnp.asarray(wn, jd)),
                          np.float32)
    rtol, atol = (1e-4, 8e-4) if dtype == "float32" else (2**-6, 2**-6)
    np.testing.assert_allclose(got.float().numpy(),
                               bm.matmul_plain(x, w).float().numpy(),
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(got.float().numpy(), want_jax, rtol=rtol,
                               atol=atol)


# --------------------------------------------------------------------------
# flash_attention: per-split (m, l, acc) combined by the rescale algebra
# --------------------------------------------------------------------------
def attention_split_emulated(q, k, v, *, offset, kv_valid_len, window,
                             softcap, bq, bkv, split):
    """The kernel's decomposition in fp32: blocks over (row, KV head,
    tile of bq flattened (query, head-of-group) rows); each block's
    visible KV tiles cut by ``split_ranges``; each run's (m, l, acc)
    from the masked scores; rank 0's combine: m = max m_r, l = sum l_r *
    exp(m_r - m), acc likewise, out = acc / max(l, 1e-30)."""
    b_, s_, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g_ = h // kh
    out = torch.zeros(b_, s_, h, d)
    keys = torch.arange(t)
    for b in range(b_):
        off, kvl = int(offset[b]), min(int(kv_valid_len[b]), t)
        for kvh in range(kh):
            kf, vf = k[b, :, kvh].float(), v[b, :, kvh].float()
            for q0 in range(0, s_ * g_, bq):
                fr = torch.arange(q0, min(q0 + bq, s_ * g_))
                si, hi_ = fr // g_, kvh * g_ + fr % g_
                qpos = off + si
                scores = (q[b, si, hi_].float() * d ** -0.5) @ kf.T
                if softcap is not None:
                    scores = torch.tanh(scores / softcap) * softcap
                vis = (keys[None] <= qpos[:, None]) & (keys[None] < kvl)
                if window is not None:
                    vis &= keys[None] > qpos[:, None] - window
                hi = min(kvl, int(qpos.max()) + 1)
                lo = max(0, int(qpos.min()) - window + 1) if window else 0
                first = lo // bkv
                n_tiles = -(-hi // bkv) - first if hi > lo else 0
                m = torch.full((len(fr), 1), fa.NEG_INF)
                l_ = torch.zeros(len(fr), 1)
                acc = torch.zeros(len(fr), d)
                parts = []
                for a, z in bm.split_ranges(n_tiles, split):
                    run = (keys >= (first + a) * bkv) & \
                        (keys < (first + z) * bkv)
                    mask = vis & run[None]
                    sm = torch.where(mask, scores, fa.NEG_INF)
                    m_r = sm.amax(dim=1, keepdim=True)
                    p = torch.where(mask, torch.exp(sm - m_r), 0.0)
                    parts.append((m_r, p.sum(dim=1, keepdim=True), p @ vf))
                for m_r, _, _ in parts:
                    m = torch.maximum(m, m_r)
                for m_r, l_r, acc_r in parts:        # rank order
                    f = torch.exp(m_r - m)
                    l_ = l_ + l_r * f
                    acc = acc + acc_r * f
                out[b, si, hi_] = acc / torch.clamp(l_, min=1e-30)
    return out.to(q.dtype)


# (b, s, t, h, kv, d, offsets, kv_valid, window, softcap, bq, bkv, split)
SPLIT_ATTENTION_CASES = [
    # decode at positions 0 and t - 1, MQA; the serve's split
    (4, 1, 64, 8, 1, 16, (0, 9, 40, 63), (1, 10, 41, 64), None, None, 8, 8,
     "serve"),
    # GQA (2 KV heads) decode with a window and a softcap
    (3, 1, 48, 4, 2, 16, (5, 17, 47), (6, 18, 48), 8, 30.0, 8, 8, 8),
    # a 16-token chunk at an offset: 4 heads x 16 tokens in tiles of 16
    # rows, runs of unequal length
    (1, 16, 64, 4, 1, 8, (20,), (36,), None, None, 16, 8, 3),
    # prefill from 0 with a window, several query tiles, more ranks than
    # visible tiles for the first tiles
    (2, 12, 24, 2, 1, 8, (0, 0), (12, 12), 5, None, 8, 4, 8),
]


@pytest.mark.parametrize("b,s,t,h,kv,d,offsets,kv_valid,window,softcap,bq,"
                         "bkv,split", SPLIT_ATTENTION_CASES)
def test_split_kv_emulation_matches_plain_and_jax(b, s, t, h, kv, d, offsets,
                                                  kv_valid, window, softcap,
                                                  bq, bkv, split):
    rng = np.random.default_rng(b * 1000 + s * 10 + t)
    qn = rng.standard_normal((b, s, h, d)).astype(np.float32)
    kn = rng.standard_normal((b, t, kv, d)).astype(np.float32)
    vn = rng.standard_normal((b, t, kv, d)).astype(np.float32)
    q, k, v = (torch.from_numpy(a) for a in (qn, kn, vn))
    off = torch.tensor(offsets, dtype=torch.int32)
    kvl = torch.tensor(kv_valid, dtype=torch.int32)
    if split == "serve":
        split = fa.split_kv(b, kv, -(-s * (h // kv) // bq), t, bkv)
        assert split == 8
    got = attention_split_emulated(q, k, v, offset=off, kv_valid_len=kvl,
                                   window=window, softcap=softcap, bq=bq,
                                   bkv=bkv, split=split)
    plain = fa.attention_plain(q, k, v, offset=off, kv_valid_len=kvl,
                               window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=2e-4,
                               atol=2e-4)
    # the JAX reference takes one offset for every row
    for i in range(b):
        want = jax_ref.attention_ref(
            jnp.asarray(qn[i:i + 1]), jnp.asarray(kn[i:i + 1]),
            jnp.asarray(vn[i:i + 1]), offset=int(offsets[i]),
            kv_valid_len=jnp.asarray(kv_valid[i:i + 1], jnp.int32),
            window=window, softcap=softcap)
        np.testing.assert_allclose(got[i:i + 1].numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-4)


def test_split_kv_emulation_writes_zero_for_a_row_with_no_visible_key():
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)) for shape in ((2, 1, 4, 8), (2, 32, 1, 8),
                                   (2, 32, 1, 8)))
    off = torch.tensor([3, 0], dtype=torch.int32)
    kvl = torch.tensor([4, 0], dtype=torch.int32)
    got = attention_split_emulated(q, k, v, offset=off, kv_valid_len=kvl,
                                   window=None, softcap=None, bq=4, bkv=8,
                                   split=4)
    plain = fa.attention_plain(q, k, v, offset=off, kv_valid_len=kvl)
    assert torch.all(got[1] == 0)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=2e-4,
                               atol=2e-4)


# --------------------------------------------------------------------------
# flash_attention_paged: the dense split over keys gathered through the table
# --------------------------------------------------------------------------
def test_paged_launch_geometry_at_the_serve_shape():
    # decode: 4 rows x 1 KV head, pages of 16, 32 table entries a row: a
    # cluster of 8 per (row, KV head) instead of one block
    assert fap.launch_geometry(4, 1, 8, 1, 16, 32) == (8, 32)
    # it takes shapes and nothing else: no offset, kv_valid or table, whose
    # values live on the card (reading one would add a host sync)
    assert list(inspect.signature(fap.launch_geometry).parameters) == \
        ["b", "s", "h", "kh", "page_size", "n_slot"]
    # decided from the shapes alone, as the dense split is: the same split
    # as B2's over a 512-key cache, for any page size that gives 512 keys
    for ps in (8, 16, 32):
        assert fap.launch_geometry(4, 1, 8, 1, ps, 512 // ps)[0] == \
            fa.split_kv(4, 1, 1, 512, fap.KV_TILE)
    # few keys cap the split; rows beyond 64 take more query tiles
    assert fap.launch_geometry(4, 1, 8, 1, 16, 4) == (1, 4)
    assert fap.launch_geometry(1, 16, 8, 1, 16, 32) == (8, 16)


def paged_split_emulated(q, k_pool, v_pool, table, *, offset, kv_valid_len,
                         window, softcap, split):
    """The paged kernel's decomposition: per row, the keys some query can
    see ([lo, hi)) read through the table key by key, the rest of the row
    zeros (nothing else of the pools is read); then the dense kernel's
    blocks of up to 64 rows and its split of the 64-key tiles, combined
    in rank order."""
    b_, s_, _, d = q.shape
    ps, kh = k_pool.shape[1], k_pool.shape[2]
    t = table.shape[1] * ps
    k = torch.zeros(b_, t, kh, d)
    v = torch.zeros(b_, t, kh, d)
    for b in range(b_):
        off, kvl = int(offset[b]), min(int(kv_valid_len[b]), t)
        hi = min(kvl, off + s_)
        lo = max(0, off - window + 1) if window else 0
        for j in range(lo, hi):
            page = int(table[b, j // ps])
            k[b, j], v[b, j] = k_pool[page, j % ps], v_pool[page, j % ps]
    return attention_split_emulated(q, k, v, offset=offset,
                                    kv_valid_len=kv_valid_len, window=window,
                                    softcap=softcap, bq=fa.MAX_ROWS,
                                    bkv=fap.KV_TILE, split=split)


def _paged_inputs(rng, b, s, h, kh, d, ps, n_slot, kvl):
    """Pools of garbage (~1e4) whose pages are shuffled across rows; each
    row's valid keys on its mapped pages, its other entries on the trash
    page 0 or on a spare page."""
    n_pages = b * n_slot + 2
    kp = 1e4 * rng.standard_normal((n_pages, ps, kh, d))
    vp = 1e4 * rng.standard_normal((n_pages, ps, kh, d))
    perm = rng.permutation(np.arange(1, n_pages))
    table = np.zeros((b, n_slot), np.int32)
    for i in range(b):
        mapped = -(-kvl[i] // ps)
        table[i, :mapped] = perm[i * n_slot:i * n_slot + mapped]
        table[i, mapped:] = rng.choice([0, perm[-1]], n_slot - mapped)
        for j in range(mapped):
            rows = min(ps, kvl[i] - j * ps)
            kp[table[i, j], :rows] = rng.standard_normal((rows, kh, d))
            vp[table[i, j], :rows] = rng.standard_normal((rows, kh, d))
    q = rng.standard_normal((b, s, h, d))
    return [a.astype(np.float32) for a in (q, kp, vp)] + [table]


# (B, S, H, KH, page size, n_slot, kv_valid, window, softcap, split): the
# serve's shape (its split from launch_geometry); GQA; a row with no
# visible key; a window and a softcap; pages of 8, 16 and 32
PAGED_SPLIT_CASES = [
    (4, 1, 8, 1, 16, 32, (0, 69, 261, 301), None, None, "serve"),
    (3, 1, 4, 2, 8, 12, (96, 1, 50), None, None, 8),
    (2, 1, 4, 1, 32, 4, (128, 0), 40, None, 4),
    (3, 1, 4, 2, 8, 9, (5, 72, 33), 20, 30.0, 3),
    (2, 2, 4, 1, 16, 5, (80, 17), None, None, 2),
]


@pytest.mark.parametrize("b,s,h,kh,ps,n_slot,kv_valid,window,softcap,split",
                         PAGED_SPLIT_CASES)
def test_paged_split_emulation_matches_plain_and_jax(b, s, h, kh, ps, n_slot,
                                                     kv_valid, window, softcap,
                                                     split):
    rng = np.random.default_rng(ps * 100 + n_slot + b)
    d = 16
    qn, kn, vn, table = _paged_inputs(rng, b, s, h, kh, d, ps, n_slot,
                                      kv_valid)
    kvl = np.asarray(kv_valid, np.int32)
    off = np.maximum(kvl - s, 0).astype(np.int32)
    if split == "serve":
        split, blocks = fap.launch_geometry(b, s, h, kh, ps, n_slot)
        assert (split, blocks) == (8, 32)
    tq, tk, tv, tt = (torch.from_numpy(a) for a in (qn, kn, vn, table))
    toff, tkvl = torch.from_numpy(off), torch.from_numpy(kvl)
    got = paged_split_emulated(tq, tk, tv, tt, offset=toff,
                               kv_valid_len=tkvl, window=window,
                               softcap=softcap, split=split)
    plain = fap.paged_attention_plain(tq, tk, tv, tt, offset=toff,
                                      kv_valid_len=tkvl, window=window,
                                      softcap=softcap)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=2e-4,
                               atol=2e-4)
    assert torch.all(got[tkvl == 0] == 0)
    want = jax_flash_attention_paged(
        jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray(table), offset=jnp.asarray(off),
        kv_valid_len=jnp.asarray(kvl), window=window, softcap=softcap,
        interpret=True)
    # the JAX kernel writes mean(v) on a row with no visible key, the
    # kernel contract 0: compare the rows that see a key
    seen = kvl > 0
    np.testing.assert_allclose(got.numpy()[seen], np.asarray(want)[seen],
                               rtol=2e-4, atol=2e-4)


# --------------------------------------------------------------------------
# ssd_scan: P split into blocks of 16 columns, B and C read per group
# --------------------------------------------------------------------------
def _bf16_operand(v):
    """An fp32 operand as the kernel feeds it to a bf16 product: hi =
    bf16(v) plus lo = bf16(v - hi)."""
    hi = v.to(torch.bfloat16).float()
    return hi + (v - hi).to(torch.bfloat16).float()


def ssd_split_emulated(x, dt, a, b, c, *, chunk_size, initial_state=None,
                       operand_split=True):
    """The SSD kernel's decomposition: one block per (row, head, 16
    columns of P), each carrying its slice of the state through the
    chunks; head h reads B and C of group h // (H / G); per chunk the
    cumsum of dt*a, S = C.B^T, M = S exp(seg_i - seg_j) dt_j on j <= i (0
    elsewhere, the exponent never taken there), y = M.x + exp(seg) C.h,
    h' = exp(total) h + (x w)^T.B.  With ``operand_split`` the fp32
    operands M, h and x*w enter their products as bf16 hi + lo, as on
    the card's tensor cores."""
    bsz, l, h, p = x.shape
    n = b.shape[-1]
    grp = torch.arange(h) // (h // b.shape[2])
    xf, bf, cf = x.float(), b.float()[:, :, grp], c.float()[:, :, grp]
    op = _bf16_operand if operand_split else (lambda v: v)
    q = min(chunk_size, l)
    y = torch.empty(bsz, l, h, p)
    state = (torch.zeros(bsz, h, p, n) if initial_state is None
             else initial_state.float().clone())
    for p0 in range(0, p, 16):
        cols = slice(p0, min(p0 + 16, p))
        hs = state[:, :, cols].clone()
        for c0 in range(0, l, q):
            r = min(q, l - c0)
            xs = xf[:, c0:c0 + r, :, cols]
            dts = dt[:, c0:c0 + r].float()
            bs, cs = bf[:, c0:c0 + r], cf[:, c0:c0 + r]
            seg = torch.cumsum(dts * a.float(), dim=1)
            causal = torch.ones(r, r, dtype=torch.bool).tril()[None, :, :,
                                                               None]
            diff = torch.where(causal, seg[:, :, None] - seg[:, None], 0.0)
            s = torch.einsum("bihn,bjhn->bijh", cs, bs)
            m = torch.where(causal, s * torch.exp(diff) * dts[:, None], 0.0)
            yc = torch.einsum("bijh,bjhp->bihp", op(m), xs)
            yc = yc + torch.exp(seg)[..., None] * torch.einsum(
                "bihn,bhpn->bihp", cs, op(hs))
            w = torch.exp(seg[:, -1:] - seg) * dts
            hs = torch.exp(seg[:, -1])[..., None, None] * hs + torch.einsum(
                "bjhp,bjhn->bhpn", op(xs * w[..., None]), bs)
            y[:, c0:c0 + r, :, cols] = yc
        state[:, :, cols] = hs
    return y.to(x.dtype), state


def _ssd_case(rng, bsz, l, h, g, p, n, with_init):
    x = rng.standard_normal((bsz, l, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (bsz, l, h)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, (h,)).astype(np.float32)
    b = rng.standard_normal((bsz, l, g, n)).astype(np.float32)
    c = rng.standard_normal((bsz, l, g, n)).astype(np.float32)
    h0 = (rng.standard_normal((bsz, h, p, n)).astype(np.float32)
          if with_init else None)
    return x, dt, a, b, c, h0


def _heads(t, h):
    """(B, L, G, N) expanded to the per-head form the JAX functions take."""
    return np.repeat(t, h // t.shape[2], axis=2)


# (B, L, H, G, P, N, chunk, initial state): one group (mamba2-780m's
# layout) over three chunks with a ragged tail and a ragged P; two groups;
# as many groups as heads (the per-head form)
SSD_SPLIT_CASES = [(2, 40, 4, 1, 20, 8, 16, True),
                   (1, 24, 4, 2, 32, 16, 8, False),
                   (2, 21, 3, 3, 16, 8, 8, True),
                   (1, 17, 2, 1, 48, 32, 32, True)]


@pytest.mark.parametrize("bsz,l,h,g,p,n,chunk,with_init", SSD_SPLIT_CASES)
def test_ssd_split_emulation_matches_pallas_and_ref(bsz, l, h, g, p, n,
                                                    chunk, with_init):
    rng = np.random.default_rng(l * 10 + h + g)
    x, dt, a, b, c, h0 = _ssd_case(rng, bsz, l, h, g, p, n, with_init)
    t = [torch.from_numpy(v) for v in (x, dt, a, b, c)]
    th0 = None if h0 is None else torch.from_numpy(h0)
    y, s = ssd_split_emulated(*t, chunk_size=chunk, initial_state=th0,
                              operand_split=False)
    j = [jnp.asarray(v) for v in (x, dt, a, _heads(b, h), _heads(c, h))]
    jh0 = None if h0 is None else jnp.asarray(h0)
    y_k, s_k = jax_ops.ssd_scan(*j, chunk_size=chunk, initial_state=jh0,
                                interpret=True)
    y_r, s_r = jax_ref.ssd_ref(*j, chunk_size=5, initial_state=jh0)
    y_p, s_p = ssd.ssd_scan_plain(*t, chunk_size=chunk, initial_state=th0)
    for want_y, want_s in ((y_k, s_k), (y_r, s_r), (y_p, s_p)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(s.numpy(), np.asarray(want_s), rtol=2e-4,
                                   atol=2e-4)


BF16_TOL = 2.0 ** -7


@pytest.mark.parametrize("bsz,l,h,g,p,n,chunk,with_init", [
    (2, 40, 4, 1, 20, 8, 16, True),
    # mamba2-780m's widths (P 64, N 128, one group) on two heads: the
    # 600-token prompt's three chunks of 256 with the operand split
    (1, 600, 2, 1, 64, 128, 256, True)])
def test_ssd_operand_split_keeps_the_state_through_three_chunks(
        bsz, l, h, g, p, n, chunk, with_init):
    """bf16 x, B and C as the card gets them; the three fp32-by-bf16
    products fed as bf16 hi + lo: y within one bf16 flip of the Pallas
    kernel and of the plain version, the fp32 state within 2e-4 of its
    largest entry after three chunks (inside chip_smoke's 1e-3)."""
    rng = np.random.default_rng(l + p)
    x, dt, a, b, c, h0 = _ssd_case(rng, bsz, l, h, g, p, n, with_init)
    bf = [torch.from_numpy(v).to(torch.bfloat16) for v in (x, b, c)]
    tdt, ta = torch.from_numpy(dt), torch.from_numpy(a)
    th0 = torch.from_numpy(h0)
    y, s = ssd_split_emulated(bf[0], tdt, ta, bf[1], bf[2], chunk_size=chunk,
                              initial_state=th0)
    assert y.dtype == torch.bfloat16
    y_p, s_p = ssd.ssd_scan_plain(bf[0], tdt, ta, bf[1], bf[2],
                                  chunk_size=chunk, initial_state=th0)
    jb = [jnp.asarray(np.asarray(v.float()), jnp.bfloat16) for v in bf]
    y_k, s_k = jax_ops.ssd_scan(jb[0], jnp.asarray(dt), jnp.asarray(a),
                                jnp.asarray(_heads(np.asarray(jb[1]), h)),
                                jnp.asarray(_heads(np.asarray(jb[2]), h)),
                                chunk_size=chunk,
                                initial_state=jnp.asarray(h0),
                                interpret=True)
    for want_y, want_s in ((y_p.float(), s_p), (y_k, s_k)):
        want_s = np.asarray(want_s, np.float32)
        np.testing.assert_allclose(y.float().numpy(),
                                   np.asarray(want_y, np.float32),
                                   rtol=BF16_TOL, atol=BF16_TOL)
        np.testing.assert_allclose(s.numpy(), want_s, rtol=0,
                                   atol=2e-4 * np.abs(want_s).max())


# --------------------------------------------------------------------------
# the build sees shared headers
# --------------------------------------------------------------------------
def test_a_header_edit_rebuilds_its_includers(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    (csrc / "tiles.cuh").write_text('#include "inner.cuh"\n')
    (csrc / "inner.cuh").write_text("// helpers\n")
    (csrc / "a.cu").write_text('#include <cuda_runtime.h>\n'
                               '#include "tiles.cuh"\n')
    (csrc / "b.cu").write_text("// no shared header\n")
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", build)
    assert cuda_build.sources_of("a") == [csrc / "a.cu", csrc / "tiles.cuh",
                                          csrc / "inner.cuh"]
    assert cuda_build._stale("a") and cuda_build._stale("b")
    for name in ("a", "b"):
        cuda_build.lib_path(name).write_bytes(b"")
        os.utime(cuda_build.lib_path(name), (2_000, 2_000))
    for src in csrc.iterdir():
        os.utime(src, (1_000, 1_000))
    assert not cuda_build._stale("a") and not cuda_build._stale("b")
    os.utime(csrc / "inner.cuh", (3_000, 3_000))
    assert cuda_build._stale("a") and not cuda_build._stale("b")


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
