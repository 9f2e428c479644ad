#!/usr/bin/env python3
"""The PyTorch/CUDA port's main path on one NVIDIA GPU (an H100).

Run from the repository root, with one card visible:

    python3 chip_smoke.py [--seed N] [--b2-reference TREE]

Phases, each fatal on failure:
  1. card: name and power limit, then the build of every CUDA kernel of
     ``src/repro_torch/csrc`` (one nvcc per library, in parallel: the four
     sources and the SSD scan's clock-stamped variant), with each
     library's register count and spills from ptxas (none of the four
     sources may spill);
  2. every kernel against its plain PyTorch version, in bf16 at the
     serving paths' shapes, each call launched twice and equal bit for
     bit (``block_matmul`` and ``flash_attention`` under every distinct
     tile of the H100 level table: B1 at M = 1, 4, 16 and a K that a
     cluster of 8 cannot split evenly, B2 with MQA and GQA, decode rows at
     positions 0 and 511 and 16-token chunks, and every block B2 is built
     for at split 8; ``ssd_scan`` at the serve's chunks, a three-chunk
     monolithic prompt, B = 4 and ragged shapes, with B and C per group
     (G = 1, as the model passes them) and per head; ``flash_attention_paged``
     at page sizes 8, 16 and 32 over shuffled page tables at split 8, rows
     with no visible key, windowed and softcapped cases, gemma-2b's and
     starcoder2-3b's head shapes, also against the dense kernel), plus
     ragged shapes; every wrapper's shared-memory count held to the
     kernel's; with ``--b2-reference TREE`` every B2 output also equal to
     that checkout's B2 build bit for bit; then ``ssd_scan``'s phase
     breakdown (clock stamps per phase) at 16 and 600 tokens;
  3. serve gemma-2b: full width (18 layers, seeded random weights made on
     the card) through ``ServingEngine(batch_slots=4, max_len=512)`` after
     ``warmup()``: six requests admitted with ``admit_request`` +
     ``prefill_step`` and decoded by 8-step quanta while the interference
     level cycles; the launch counters are zeroed just before and read
     just after, and must equal the forward passes run times the
     kernel calls of one pass.  The serve runs twice, first eagerly
     (``cuda_graphs=False``), then with CUDA graphs (the warmup captures
     every call of the full level grid: captures, their seconds and the
     device memory they add are reported); the two must give the same
     token streams and launch counts, and the graphed serve captures
     nothing.  Then a full level sweep on the graphed engine captures
     nothing; PAIRS alternating eager/graph pairs of an 8-step decode
     quantum and of a 16-token prefill chunk give wall, device busy
     (torch.profiler), idle share and decode tokens/s; and a host profile
     of one eager quantum (cProfile, and torch.profiler's CPU activity)
     says where the host's time goes.  Then the online runtime on the
     same warm engines: ``TorchOnlineRuntime`` with ``VeltairPolicy`` in
     the loop serves RT_QUERIES requests of two paper tenants (an
     interactive and a batch tier, prompts of 5-250 tokens) in virtual
     time on the graphed and on the eager engine (identical schedule and
     level traces, streams and metrics, more than one level, an
     interactive prefill chunk between a batch request's decode quanta,
     nothing captured, one host sync per decode quantum and per finished
     prompt, exact launch counts from the trace), then in wall-clock mode
     with measured counters (latencies, wall per quantum by kind, the
     runtime's own host time per quantum, and the device's idle share
     from a profiled rerun);
  4. profile: one 8-step decode quantum (a graph replay) under
     torch.profiler, device time by kernel and the device's idle share;
  5. whole-model check: first-prefill-chunk and first-decode logits
     through the kernels and through the plain versions, same weights;
  6. serve (eager and graphed), sweep, pair, profile and check
     mamba2-780m the same way (48 layers,
     d_inner 3072, 48 SSD heads): ``ssd_scan`` launches once per layer
     for every prefill chunk of two or more tokens; the profile covers
     one 16-token prefill chunk and one 8-step decode quantum; the
     whole-model check runs a 600-token monolithic prefill (three scan
     chunks of 256) through the kernel and through the plain versions;
  7. serve gemma-2b again from a paged KV cache (``page_size=16``,
     128 usable pages): the same six prompts plus two requests that share
     a resident request's prompt pages (one full-page borrower, one
     partial-tail borrower whose first decode copies the shared page);
     exact launch accounting (``flash_attention_paged`` once per layer
     and decode step, ``flash_attention`` once per layer and prefill
     chunk), an empty pool after the serve, eager and graphed as above
     (level sweep, decode-quantum pairs), a profile of one paged decode
     quantum, and a paged whole-model check (decode steps on a shuffled
     page table through the kernels against the plain versions and
     against the dense cache); then the online runtime on a paged engine
     of RT_PAGES pages with worst-case reservation under an admission
     controller, in virtual time (admissions deferred on pages, exact
     launches, an empty pool) and in wall-clock mode, and the SLO
     scheduler's pick clamped to one step by a full pool;
  8. times at the serve's shapes: kernel, plain version, one PyTorch call
     as a yardstick where one exists, and the bound (bytes at 3.35 TB/s
     or FLOPs at 989 TFLOP/s, whichever is larger); the split and block
     count of each launch (for B1 and B2 at each level), and B1 and its
     yardstick again after an L2 flush that leaves no dirty lines.

The line before the last is the ``{"kernels": [...]}`` record; the last
line is ``{"ok": true, "device": {...}}``.  Details land in
``chiprun_out/chip_smoke.json``.  Imports nothing of JAX or of the JAX
package.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import gc
import itertools
import json
import pathlib
import re
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, data sheet
BF16_FLOPS = 989e12              # H100 SXM dense bf16, data sheet
# kernel vs plain version, bf16 outputs: |err| <= ATOL + RTOL*|plain|
# (two bf16 ulps relative, with an absolute floor of 2^-6: the two differ
# only in fp32 summation order, so at most a rounding flip of the output)
ATOL = RTOL = 2.0 ** -6
# ssd_scan's fp32 final state, kernel vs plain version: the same products
# summed in another order (and a warp-level cumsum of dt*a)
STATE_RTOL = 1e-3
# whole-model logits, kernels vs plain versions: activations round to
# bf16 after every op, so a one-ulp flip anywhere in 18 residual layers
# propagates; bound the drift at 5% of the largest logit (and the final
# SSD state of mamba2's last layer at 5% of its largest entry)
LOGIT_RTOL = 5e-2

PROMPT_LENS = (5, 37, 64, 100, 180, 250)
PAGE_SIZE = 16
# the paged serve's order: the 37-token prompt first, then two requests
# that share its prompt pages (admitted once it is resident): one takes
# its two full pages and adds 20 tokens, one is its first 24 tokens (a
# full page plus a partial tail that copy-on-write privatizes at the first
# decode); then the other five prompts
PAGED_BASE = 1
MONO_LEN = 600            # a monolithic mamba2 prompt: 3 scan chunks
MAX_NEW = 32
QUANTUM = 8
BATCH_SLOTS = 4
MAX_LEN = 512


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# cycles of the device-side sleep that holds the stream while the host
# enqueues a timing loop (~0.1 s at the H100's boost clock)
SLEEP_CYCLES = 200_000_000


def cold_ms(fn, n: int, flush) -> float:
    """Median device time of ``fn`` over ``n`` launches, each after the
    L2 cache was flushed (the serving path finds its inputs cold: the
    MLP weights stream through L2 between two calls of one layer).  A
    device-side sleep first holds the stream, so the host enqueues the
    whole loop before the device reaches it and each event pair brackets
    device work only; without it, the wrappers' host time (tens of µs of
    Python per call) shows up as device idle time between the events."""
    import torch
    pairs = []
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    for _ in range(n):
        flush()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def ptxas_summary(log: str) -> dict:
    """Kernels compiled, their largest register count and how many spill
    (``nvcc -Xptxas -v``)."""
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spilling = [ln.strip() for ln in log.splitlines()
                if "spill stores" in ln and
                "0 bytes spill stores, 0 bytes spill loads" not in ln]
    return {"kernels": len(regs), "max_registers": max(regs, default=0),
            "spilling_kernels": len(spilling), "spill_lines": spilling[:8]}


def errors(got, want) -> tuple[float, float, bool]:
    """(max abs err, max rel err, within ATOL + RTOL*|want|)."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    rel = diff / w.abs().clamp_min(ATOL)
    ok = bool((diff <= ATOL + RTOL * w.abs()).all())
    return diff.max().item(), rel.max().item(), ok


def reference_b2(tree: str):
    """``flash_attention`` built from another checkout's
    ``src/repro_torch/csrc`` (for example the parent commit's, unpacked
    with ``git archive``) into that checkout's build directory."""
    import ctypes
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels import flash_attention as fa
    saved = cuda_build.CSRC, cuda_build.BUILD_DIR
    root = pathlib.Path(tree).resolve()
    cuda_build.CSRC = root / "src" / "repro_torch" / "csrc"
    cuda_build.BUILD_DIR = root / "build" / "repro_torch"
    try:
        cuda_build.build(("flash_attention",))
        lib = ctypes.CDLL(str(cuda_build.lib_path("flash_attention")))
    finally:
        cuda_build.CSRC, cuda_build.BUILD_DIR = saved
    lib.flash_attention_bf16.argtypes = \
        fa._lib().flash_attention_bf16.argtypes
    lib.flash_attention_bf16.restype = ctypes.c_int
    lib.cuda_error_name.argtypes = [ctypes.c_int]
    lib.cuda_error_name.restype = ctypes.c_char_p
    return lib


def with_b2(lib, call):
    """``call()`` with ``flash_attention`` launching ``lib``'s kernel."""
    from repro_torch.kernels import flash_attention as fa
    saved = fa._lib()
    fa._LIB = lib
    try:
        return call()
    finally:
        fa._LIB = saved


def check_kernels(dev, gen, report, b2_ref=None) -> dict:
    """``block_matmul`` and ``flash_attention`` against their plain
    versions under every distinct tile of the level table: each call
    twice, the two results equal bit for bit (the splits combine in rank
    order, no atomics).  With ``b2_ref`` (another build of B2, see
    ``reference_b2``) every B2 output must also equal that build's bit for
    bit.  Returns the worst |err| of each and the splits and block counts
    the checks launched."""
    import torch
    from repro_torch.kernels import block_matmul as bm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import attention_ref, matmul_ref
    from repro_torch.serving.engine import H100_LEVEL_TILES

    worst = {"block_matmul": 0.0, "flash_attention": 0.0}
    splits = {"block_matmul": collections.Counter(),
              "flash_attention": collections.Counter()}
    mm_tiles = list({tuple(sorted(t["matmul"].items())): t["matmul"]
                     for t in H100_LEVEL_TILES}.values())
    att_tiles = list({tuple(sorted(t["attention"].items())): t["attention"]
                      for t in H100_LEVEL_TILES}.values())
    # the serve's GEMMs at M = 1, 4 and 16; K = 16576 = 259 tiles of 64,
    # which a cluster of 8 cannot split evenly; ragged shapes
    shapes = [(m, k, n) for m in (1, 4, 16)
              for k, n in ((2048, 16384), (16384, 2048))]
    shapes += [(4, 16576, 2048), (16, 16400, 2048)]
    shapes += [(37, 300, 129), (3, 2056, 72), (129, 65, 1000)]   # ragged
    n_checks = n_ref = 0
    tol = f"tolerance {ATOL:.4g} + {RTOL:.4g}*|plain|"
    for m, k, n in shapes:
        x = torch.randn(m, k, generator=gen, device=dev).bfloat16()
        w = (torch.randn(k, n, generator=gen, device=dev)
             * k ** -0.5).bfloat16()
        want = matmul_ref(x, w)
        case_abs = case_rel = 0.0
        used = set()
        for tiles in mm_tiles:
            got = bm.block_matmul_2d(x, w, **tiles)
            again = bm.block_matmul_2d(x, w, **tiles)
            torch.cuda.synchronize()
            _, split, blocks = bm.launch_geometry(m, k, n, **tiles)
            used.add((split, blocks))
            splits["block_matmul"][split] += 1
            ea, er, ok = errors(got, want)
            case_abs, case_rel = max(case_abs, ea), max(case_rel, er)
            n_checks += 1
            require(ok, f"block_matmul {(m, k, n)} tiles {tiles} split "
                    f"{split}: max abs err {ea:.4g}, max rel err {er:.4g} "
                    f"beyond {tol}")
            require(torch.equal(got, again), f"block_matmul {(m, k, n)} "
                    f"tiles {tiles} split {split}: two launches differ")
        worst["block_matmul"] = max(worst["block_matmul"], case_abs)
        report(f"block_matmul M={m} K={k} N={n}: {len(mm_tiles)} tiles ok, "
               f"bitwise equal across two launches, max abs err "
               f"{case_abs:.4g}, max rel err {case_rel:.4g} ({tol}); "
               f"(split, blocks) {sorted(used)}")
    # (label, B, S, KH, offsets, kv_valid): gemma-2b's 8 query heads at
    # D 256; MQA and GQA (K = 2), decode rows at positions 0 and 511
    cases = [
        ("prefill chunk", 1, 16, 1, [32], [48]),
        ("prefill chunk at 240", 1, 16, 1, [240], [256]),
        ("decode", 4, 1, 1, [5, 100, 300, 511], [6, 101, 301, 512]),
        ("decode at 0 and 511", 2, 1, 1, [0, 511], [1, 512]),
        ("GQA K=2 decode", 4, 1, 2, [0, 100, 300, 511], [1, 101, 301, 512]),
        ("GQA K=2 prefill chunk", 2, 16, 2, [0, 240], [16, 256]),
    ]
    for name, b, s, kh, offs, kvls in cases:
        q = torch.randn(b, s, 8, 256, generator=gen, device=dev).bfloat16()
        kk = torch.randn(b, MAX_LEN, kh, 256, generator=gen,
                         device=dev).bfloat16()
        v = torch.randn(b, MAX_LEN, kh, 256, generator=gen,
                        device=dev).bfloat16()
        off = torch.tensor(offs, device=dev)
        kvl = torch.tensor(kvls, device=dev)
        for window, softcap in ((None, None), (64, 50.0)):
            want = attention_ref(q, kk, v, offset=off, kv_valid_len=kvl,
                                 window=window, softcap=softcap)
            case_abs = case_rel = 0.0
            used = set()
            for tiles in att_tiles:
                kw = dict(offset=off, kv_valid_len=kvl, window=window,
                          softcap=softcap, **tiles)
                got = fa.flash_attention(q, kk, v, **kw)
                again = fa.flash_attention(q, kk, v, **kw)
                if b2_ref is not None:
                    n_ref += 1
                    require(torch.equal(got, with_b2(
                        b2_ref, lambda: fa.flash_attention(q, kk, v, **kw))),
                        f"flash_attention {name} tiles {tiles}: differs "
                        "from the reference build")
                torch.cuda.synchronize()
                _, split, blocks = fa.launch_geometry(b, s, 8, kh, MAX_LEN,
                                                      **tiles)
                used.add((split, blocks))
                splits["flash_attention"][split] += 1
                ea, er, ok = errors(got, want)
                case_abs, case_rel = max(case_abs, ea), max(case_rel, er)
                n_checks += 1
                require(ok, f"flash_attention {name} window={window} "
                        f"softcap={softcap} tiles {tiles} split {split}: max "
                        f"abs err {ea:.4g}, max rel err {er:.4g} beyond {tol}")
                require(torch.equal(got, again), f"flash_attention {name} "
                        f"window={window} softcap={softcap} tiles {tiles} "
                        f"split {split}: two launches differ")
            worst["flash_attention"] = max(worst["flash_attention"],
                                           case_abs)
            report(f"flash_attention {name} window={window} "
                   f"softcap={softcap}: {len(att_tiles)} tiles ok, bitwise "
                   f"equal across two launches, max abs err {case_abs:.4g}, "
                   f"max rel err {case_rel:.4g} ({tol}); (split, blocks) "
                   f"{sorted(used)}")
    # every block B2 is built for (head_dim x padded rows x key tile),
    # split 8 across a 512-key cache: narrow heads leave warps without a
    # share of the accumulator, and each rank's partial is packed by the
    # threads that hold one.  The wrapper's shared-memory count (by which
    # it refuses blocks) must be the kernel's own.
    blocks_abs = 0.0
    for d in fa.HEAD_DIMS:
        for rows in (16, 32, 64):
            for bkv in fa.BKV_CHOICES:
                smem = fa.kernel_smem_bytes(rows, bkv, d)
                require(smem == fa.smem_bytes(rows, bkv, d),
                        f"flash_attention (bq={rows}, bkv={bkv}) D={d}: "
                        f"kernel sizes {smem} bytes of shared memory, the "
                        f"wrapper {fa.smem_bytes(rows, bkv, d)}")
                sq = rows // 8
                q = torch.randn(1, sq, 8, d, generator=gen,
                                device=dev).bfloat16()
                kk = torch.randn(1, MAX_LEN, 1, d, generator=gen,
                                 device=dev).bfloat16()
                v = torch.randn(1, MAX_LEN, 1, d, generator=gen,
                                device=dev).bfloat16()
                kw = dict(offset=MAX_LEN - sq, kv_valid_len=MAX_LEN,
                          bq=rows, bkv=bkv)
                _, split, _ = fa.launch_geometry(1, sq, 8, 1, MAX_LEN, rows,
                                                 bkv)
                got = fa.flash_attention(q, kk, v, **kw)
                again = fa.flash_attention(q, kk, v, **kw)
                if b2_ref is not None:
                    n_ref += 1
                    require(torch.equal(got, with_b2(
                        b2_ref, lambda: fa.flash_attention(q, kk, v, **kw))),
                        f"flash_attention (bq={rows}, bkv={bkv}) D={d}: "
                        "differs from the reference build")
                torch.cuda.synchronize()
                ea, er, ok = errors(got, attention_ref(q, kk, v, **{
                    x: kw[x] for x in ("offset", "kv_valid_len")}))
                blocks_abs = max(blocks_abs, ea)
                n_checks += 1
                splits["flash_attention"][split] += 1
                require(ok and split > 1, f"flash_attention (bq={rows}, "
                        f"bkv={bkv}) D={d} split {split}: max abs err "
                        f"{ea:.4g}, max rel err {er:.4g} beyond {tol}")
                require(torch.equal(got, again), f"flash_attention (bq="
                        f"{rows}, bkv={bkv}) D={d}: two launches differ")
    worst["flash_attention"] = max(worst["flash_attention"], blocks_abs)
    report(f"flash_attention every built block (D {fa.HEAD_DIMS} x rows "
           f"16/32/64 x bkv {fa.BKV_CHOICES}) at split 8: shared memory as "
           f"the wrapper counts it, bitwise equal across two launches, max "
           f"abs err {blocks_abs:.4g} ({tol})")
    # B1's shared memory is sized by its source alone; every built tile
    # fits the card
    for tile in itertools.product(bm.BM_CHOICES, bm.BK_CHOICES,
                                  bm.BN_CHOICES):
        require(0 < bm.smem_bytes(*tile) <= fa.MAX_SMEM_BYTES,
                f"block_matmul tile (bm, bk, bn) {tile}: "
                f"{bm.smem_bytes(*tile)} bytes of shared memory")
    if b2_ref is not None:
        report(f"flash_attention: {n_ref} outputs equal the reference "
               "build's bit for bit")
    report(f"kernel checks: {n_checks} passed, each launched twice with "
           f"bitwise equal results; max abs err block_matmul "
           f"{worst['block_matmul']:.4g}, flash_attention "
           f"{worst['flash_attention']:.4g} ({tol}); splits launched "
           + ", ".join(f"{k} {dict(sorted(v.items()))}"
                       for k, v in splits.items()))
    return worst


def paged_inputs(gen, dev, b, h, kh, d, ps, kvl, garbage=1e3):
    """bf16 q (B,1,H,D), K/V pools of B * MAX_LEN / ps pages plus the trash
    page and a spare page, and a shuffled int32 page table.  Each row maps
    the pages that hold its ``kvl`` keys to physical pages drawn from a
    random permutation; its other entries point at the trash page or at
    the spare page.  The trash page, the spare page and every position
    past a row's valid length hold garbage of magnitude ~``garbage``."""
    import torch
    n_slot = MAX_LEN // ps
    n_pages = b * n_slot + 2
    shape = (n_pages, ps, kh, d)
    k_pool = (torch.randn(shape, generator=gen, device=dev)
              * garbage).bfloat16()
    v_pool = (torch.randn(shape, generator=gen, device=dev)
              * garbage).bfloat16()
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    spare = int(perm[-1])
    table = torch.zeros(b, n_slot, dtype=torch.int32, device=dev)
    for i in range(b):
        mapped = -(-int(kvl[i]) // ps)
        table[i, :mapped] = perm[i * n_slot:i * n_slot + mapped].int()
        pick = torch.randint(0, 2, (n_slot - mapped,), generator=gen,
                             device=dev)
        table[i, mapped:] = (pick * spare).int()
        for j in range(mapped):
            rows = min(ps, int(kvl[i]) - j * ps)
            ph = int(table[i, j])
            k_pool[ph, :rows] = torch.randn(rows, kh, d, generator=gen,
                                            device=dev).bfloat16()
            v_pool[ph, :rows] = torch.randn(rows, kh, d, generator=gen,
                                            device=dev).bfloat16()
    q = torch.randn(b, 1, h, d, generator=gen, device=dev).bfloat16()
    return q, k_pool, v_pool, table


def check_paged(dev, gen, report) -> float:
    """``flash_attention_paged`` against its plain version (gather, then
    dense attention) at gemma-2b's widths (H 8, K 1, D 256), at a GQA shape
    (K 2) and at starcoder2-3b's (H 24, K 2, D 128): page sizes 8, 16 and
    32, B = 1 and 4, kv_valid of 1, ragged, a full MAX_LEN slot and rows
    with no visible key (which must write 0), shuffled tables with garbage
    in the trash page and the unmapped entries, windowed and softcapped
    cases; each call launched twice and equal bit for bit, at the split
    ``launch_geometry`` gives (the largest, 8, among them); and against the
    dense kernel on the gathered cache.  The wrapper's shared-memory count
    is held to the kernel's for every block it is built for.  Returns the
    worst |err| against the plain version."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_paged as fap
    from repro_torch.kernels.ref import paged_attention_ref

    tol = f"tolerance {ATOL:.4g} + {RTOL:.4g}*|plain|"
    kvls = {"kv_valid 1": [1, 1, 1, 1], "ragged": [37, 100, 260, 301],
            "full slot": [MAX_LEN] * 4, "no visible key": [0, 37, 0, 301]}
    # (H, K, D, page size, B, kv_valid, window, softcap)
    cases = [(8, kh, 256, ps, b, name, None, None) for kh in (1, 2)
             for ps in (8, 16, 32) for b in (1, 4) for name in kvls]
    cases += [(8, 1, 256, 16, 4, "ragged", 64, None),
              (8, 2, 256, 8, 4, "ragged", None, 50.0),
              (8, 1, 256, 32, 4, "full slot", 100, 30.0),
              (24, 2, 128, 16, 4, "ragged", None, None),
              (24, 2, 128, 8, 4, "full slot", 200, None)]
    worst = worst_dense = 0.0
    splits = collections.Counter()
    for h, kh, d, ps, b, name, window, softcap in cases:
        kvl = torch.tensor(kvls[name][:b], dtype=torch.int32, device=dev)
        q, kp, vp, table = paged_inputs(gen, dev, b, h, kh, d, ps, kvl)
        off = kvl - 1
        kw = dict(offset=off, kv_valid_len=kvl, window=window,
                  softcap=softcap)
        got = fap.flash_attention_paged(q, kp, vp, table, **kw)
        again = fap.flash_attention_paged(q, kp, vp, table, **kw)
        torch.cuda.synchronize()
        split, blocks = fap.launch_geometry(b, 1, h, kh, ps, table.shape[1])
        splits[split] += 1
        want = paged_attention_ref(q, kp, vp, table, **kw)
        ea, er, ok = errors(got, want)
        label = (f"flash_attention_paged H={h} K={kh} D={d} page {ps} B={b} "
                 f"{name} window={window} softcap={softcap} split {split}")
        require(ok and bool(torch.isfinite(got).all()),
                f"{label}: max abs err {ea:.4g}, max rel err {er:.4g} "
                f"beyond {tol}")
        require(torch.equal(got, again), f"{label}: two launches differ")
        empty = kvl == 0
        require(bool((got[empty] == 0).all()),
                f"{label}: a row with no visible key wrote nonzero")
        dense = fa.flash_attention(
            q, fap.gather_pages(kp, table).contiguous(),
            fap.gather_pages(vp, table).contiguous(), **kw)
        torch.cuda.synchronize()
        da, dr, dok = errors(got, dense)
        require(dok, f"{label}: against the dense kernel on the gathered "
                f"cache max abs err {da:.4g}, max rel err {dr:.4g} beyond "
                f"{tol}")
        worst, worst_dense = max(worst, ea), max(worst_dense, da)
        report(f"{label} ({blocks} blocks): max abs err {ea:.4g}, max rel "
               f"err {er:.4g}, bitwise equal across two launches; against "
               f"the dense kernel {da:.4g} ({tol})")
    require(splits[fa.MAX_SPLIT] > 0, f"no paged check at split "
            f"{fa.MAX_SPLIT}: {dict(splits)}")
    n_smem = 0
    for d in fa.HEAD_DIMS:
        for rows in (1, 8, 16, 17, 32, 33, 64, 200):
            for n_slot in (1, 32, 64, 1000):
                smem = fap.kernel_smem_bytes(rows, d, n_slot)
                n_smem += 1
                require(smem == fap.smem_bytes(rows, d, n_slot),
                        f"flash_attention_paged rows={rows} D={d} "
                        f"n_slot={n_slot}: kernel sizes {smem} bytes of "
                        f"shared memory, the wrapper "
                        f"{fap.smem_bytes(rows, d, n_slot)}")
    report(f"flash_attention_paged checks: {len(cases)} passed, each "
           f"launched twice with bitwise equal results, splits "
           f"{dict(sorted(splits.items()))}; max abs err {worst:.4g} against "
           f"the plain version, {worst_dense:.4g} against the dense kernel "
           f"on the gathered cache; shared memory as the wrapper counts it "
           f"for {n_smem} blocks")
    return worst


def ssd_inputs(gen, dev, bsz, l, h, p, n, with_init, groups=None):
    """bf16 x, B, C and an fp32 state of unit scale; dt = softplus of a
    normal (as the mixer makes it), a in (-2.1, -0.1).  B and C per head,
    or per group with ``groups`` (as the model passes them)."""
    import torch
    g = h if groups is None else groups
    x = torch.randn(bsz, l, h, p, generator=gen, device=dev).bfloat16()
    dt = torch.nn.functional.softplus(
        torch.randn(bsz, l, h, generator=gen, device=dev) - 1.0)
    a = -torch.rand(h, generator=gen, device=dev) * 2.0 - 0.1
    b = torch.randn(bsz, l, g, n, generator=gen, device=dev).bfloat16()
    c = torch.randn(bsz, l, g, n, generator=gen, device=dev).bfloat16()
    h0 = (torch.randn(bsz, h, p, n, generator=gen, device=dev)
          if with_init else None)
    return x, dt, a, b, c, h0


def check_ssd(dev, gen, report) -> float:
    """``ssd_scan`` against its plain version in the serve's types, on the
    per-head copies of B and C: y within ATOL + RTOL*|plain|, the fp32
    final state within STATE_RTOL of its largest entry; each call launched
    twice and equal bit for bit; B and C per group (G = 1, mamba2-780m's
    layout, as the model passes them) and per head (G = H).  The wrapper's
    shared-memory count is held to the kernel's.  Returns the worst |y|
    error."""
    import torch
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels.ref import ssd_ref

    # (label, B, L, H, G, P, N, chunk, initial state)
    cases = [(f"serve chunk L={l}", 1, l, 48, 1, 64, 128, 256, True)
             for l in (2, 4, 8, 16)]
    cases += [("serve chunk L=16, per head", 1, 16, 48, 48, 64, 128, 256,
               True)]
    cases += [(f"monolithic L={MONO_LEN} (3 chunks, ragged tail)", 1,
               MONO_LEN, 48, 1, 64, 128, 256, init) for init in (False, True)]
    cases += [(f"monolithic L={MONO_LEN}, per head", 1, MONO_LEN, 48, 48, 64,
               128, 256, True)]
    cases += [("batch 4 L=16", 4, 16, 48, 1, 64, 128, 256, True),
              ("ragged L=37 P=20 N=7", 2, 37, 3, 3, 20, 7, 16, True),
              ("ragged L=5 P=33 N=130", 3, 5, 2, 1, 33, 130, 4, False),
              ("two groups L=40 P=96", 2, 40, 4, 2, 96, 64, 16, True)]
    worst = 0.0
    tol = f"y {ATOL:.4g} + {RTOL:.4g}*|plain|, state {STATE_RTOL:.4g}*max"
    for label, bsz, l, h, g, p, n, chunk, init in cases:
        x, dt, a, b, c, h0 = ssd_inputs(gen, dev, bsz, l, h, p, n, init, g)
        kw = dict(chunk_size=chunk, initial_state=h0)
        y, state = ssd.ssd_scan(x, dt, a, b, c, **kw)
        y2, state2 = ssd.ssd_scan(x, dt, a, b, c, **kw)
        torch.cuda.synchronize()
        split, blocks = ssd.launch_geometry(bsz, h, p)
        want_y, want_s = ssd_ref(x, dt, a, b.repeat_interleave(h // g, 2),
                                 c.repeat_interleave(h // g, 2), **kw)
        ea, er, ok = errors(y, want_y)
        es = (state - want_s).abs().max().item()
        smax = want_s.abs().max().item()
        worst = max(worst, ea)
        what = (f"ssd_scan {label} B={bsz} H={h} G={g} P={p} N={n} "
                f"chunk={chunk} init={init} (P split {split}, {blocks} "
                "blocks)")
        require(ok, f"{what}: y max abs err {ea:.4g}, max rel err {er:.4g} "
                f"beyond {tol}")
        require(es <= STATE_RTOL * smax and bool(torch.isfinite(y).all()),
                f"{what}: state max abs err {es:.4g} (max |state| "
                f"{smax:.4g}) beyond {tol}")
        require(torch.equal(y, y2) and torch.equal(state, state2),
                f"{what}: two launches differ")
        report(f"{what}: y max abs err {ea:.4g}, max rel err {er:.4g}; "
               f"state max abs err {es:.4g} of max {smax:.4g} ({tol}); "
               "bitwise equal across two launches")
    for q in (1, 2, 16, 17, 100, 256):
        for n in (7, 64, 128, 130):
            require(ssd.kernel_smem_bytes(q, n) == ssd.smem_bytes(q, n),
                    f"ssd_scan chunk {q} N={n}: kernel sizes "
                    f"{ssd.kernel_smem_bytes(q, n)} bytes of shared memory, "
                    f"the wrapper {ssd.smem_bytes(q, n)}")
    report(f"ssd_scan checks: {len(cases)} passed, each launched twice with "
           f"bitwise equal results; max abs err {worst:.4g}; shared memory "
           "as the wrapper counts it")
    return worst


def serve(cfg, params, prompts, dev, report, counters, expected, *,
          engine_kw=None, after=None) -> dict:
    """Serve ``prompts`` x MAX_NEW tokens after ``warmup()``.  ``counters``
    maps each kernel of the path to its launch counter, zeroed just before
    the serve and read just after; ``expected(decode_steps, chunks)``
    gives each kernel's launch count for the decode steps and prefill
    chunk sizes run, and a line that says why.  ``engine_kw`` goes to the
    engine (the paged cache's options); ``after`` maps a request's index
    to the index of one that must be resident, its prompt prefilled,
    before it is admitted (admission stays FIFO: a held request holds the
    ones behind it)."""
    import torch
    from repro_torch.core import cost_model as cm
    from repro_torch.serving.engine import Request, ServingEngine

    engine = ServingEngine(cfg, params, batch_slots=BATCH_SLOTS,
                           max_len=MAX_LEN, device=dev, **(engine_kw or {}))
    graphs = engine.version_cache.graphs is not None
    what = (f"{cfg.name}{' paged' if engine.paged else ''}"
            f"{'' if graphs else ' eager'}")
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_stats()
    t0 = time.perf_counter()
    stats = engine.warmup()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    mem1 = torch.cuda.memory_stats()
    captures = {
        "warmup_s": warmup_s, "builds": engine.version_cache.traces,
        "captures": sum(c.graph is not None for c in
                        engine.version_cache._calls.values()),
        "capture_s": engine.version_cache.capture_s,
        "allocated_bytes_delta": mem1["allocated_bytes.all.current"]
        - mem0["allocated_bytes.all.current"],
        "reserved_bytes_delta": mem1["reserved_bytes.all.current"]
        - mem0["reserved_bytes.all.current"]}
    report(f"{what} warmup: {warmup_s:.2f} s, {stats}; "
           f"{captures['captures']} CUDA graphs captured in "
           f"{captures['capture_s']:.2f} s; device memory allocated "
           f"+{captures['allocated_bytes_delta'] / 2**20:.1f} MiB, reserved "
           f"+{captures['reserved_bytes_delta'] / 2**20:.1f} MiB over the "
           "warmup (the graphs' pool and outputs)")
    reqs = [Request(rid=i, prompt=p, max_new_tokens=MAX_NEW)
            for i, p in enumerate(prompts)]
    levels = [cm.grid_point(i) for i in (0, 5, 9)]
    syncs0, switches0 = engine.host_syncs, engine.level_switches
    builds0, tokens0 = engine.version_cache.traces, engine.tokens_decoded
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.clear()
    pending = collections.deque(reqs)
    quanta = finishing_prefills = decode_steps = 0
    chunks: list[int] = []
    quantum_ms, quantum_tokens = [], 0
    t_start = time.perf_counter()
    turn = 0
    after = after or {}

    def may_admit(req) -> bool:
        base = after.get(req.rid)
        if base is None:
            return True
        require(not reqs[base].done, f"request {req.rid}: request {base}, "
                "whose pages it should share, finished first")
        return bool(reqs[base].output)

    while pending or engine.active_slots:
        while pending and may_admit(pending[0]) and \
                engine.admit_request(pending[0]):
            pending.popleft()
        while engine.prefill_pending:
            pq = engine.prefill_step()
            chunks.append(pq.chunk)
            finishing_prefills += pq.finished
        engine.set_interference_level(levels[turn % len(levels)])
        turn += 1
        tq = time.perf_counter()
        handle = engine.begin_quantum(QUANTUM)
        engine.finish_quantum(handle)
        if handle is not None:
            quanta += 1
            decode_steps += handle.bucket     # the quantum runs its bucket
            quantum_ms.append((time.perf_counter() - tq) * 1e3)
            quantum_tokens += int(handle.n_left.sum())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = {name: dict(c) for name, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    syncs = engine.host_syncs - syncs0
    for r in reqs:
        require(r.done and len(r.output) == MAX_NEW + 1,
                f"request {r.rid} ended with {len(r.output)} tokens")
    require(syncs == quanta + finishing_prefills,
            f"{syncs} host syncs for {quanta} quanta + "
            f"{finishing_prefills} finishing prefills")
    require(engine.version_cache.traces == builds0,
            "the serve built a version after warmup")
    require(engine.level_switches - switches0 >= 3,
            f"{engine.level_switches - switches0} level switches")
    want, why = expected(decode_steps, chunks)
    for name, per_tile in launches.items():
        n = sum(per_tile.values())
        require(n > 0, f"{name} never launched")
        require(n == want[name], f"{name}: {n} launches, expected "
                f"{want[name]} ({why[name]})")
    tokens = engine.tokens_decoded - tokens0
    out = {
        "model": cfg.name, "cuda_graphs": graphs, "warmup": captures,
        "requests": len(reqs), "tokens": tokens,
        "wall_s": wall, "tokens_per_s": tokens / wall,
        "decode_tokens_per_s": quantum_tokens / (sum(quantum_ms) / 1e3),
        "quanta": quanta, "quantum_ms_median": statistics.median(quantum_ms),
        "quantum_ms": quantum_ms, "prefill_chunks": len(chunks),
        "prefill_chunk_sizes": chunks, "decode_steps": decode_steps,
        "expected_launches": want, "host_syncs": syncs,
        "level_switches": engine.level_switches - switches0,
        "max_memory_allocated": peak,
        "streams": [list(r.output) for r in reqs],
        "launches": {k: {str(t): n for t, n in v.items()}
                     for k, v in launches.items()},
    }
    report(f"serve {what}: {len(reqs)} requests x {MAX_NEW + 1} tokens, "
           f"{tokens} tokens in {wall:.3f} s = {out['tokens_per_s']:.1f} "
           f"tokens/s; {quanta} quanta, median {out['quantum_ms_median']:.2f}"
           f" ms/quantum ({out['decode_tokens_per_s']:.1f} decode tokens/s);"
           f" {syncs} host syncs; {out['level_switches']} level switches; "
           f"max_memory_allocated {peak / 2**30:.2f} GiB")
    for name, per_tile in launches.items():
        report(f"launches {name}: {sum(per_tile.values())} ({why[name]}); "
               "by tile " + ", ".join(f"{t}: {n}" for t, n in
                                       sorted(per_tile.items())))
    return engine, out


def dense_launches(cfg):
    """Every forward pass (a decode step or a prefill chunk) runs each
    layer's three MLP GEMMs and its attention through the kernels."""
    def expected(decode_steps, chunks):
        passes = decode_steps + len(chunks)
        per = {"block_matmul": 3 * cfg.num_layers,
               "flash_attention": cfg.num_layers}
        return ({k: v * passes for k, v in per.items()},
                {k: f"{v} per forward pass x {passes} passes = "
                 f"{decode_steps} decode steps + {len(chunks)} prefill "
                 "chunks" for k, v in per.items()})
    return expected


def paged_launches(cfg):
    """A paged engine prefills into a dense row (the dense attention
    kernel, once per layer and chunk) and decodes through the page table
    (the paged kernel, once per layer and step); every forward pass runs
    the three MLP GEMMs of each layer."""
    def expected(decode_steps, chunks):
        n, passes = cfg.num_layers, decode_steps + len(chunks)
        return ({"block_matmul": 3 * n * passes,
                 "flash_attention": n * len(chunks),
                 "flash_attention_paged": n * decode_steps},
                {"block_matmul": f"{3 * n} per forward pass x {passes} "
                 f"passes = {decode_steps} decode steps + {len(chunks)} "
                 "prefill chunks",
                 "flash_attention": f"{n} per prefill chunk x "
                 f"{len(chunks)} chunks (prefill fills a dense row)",
                 "flash_attention_paged": f"{n} per decode step x "
                 f"{decode_steps} steps"})
    return expected


def ssm_launches(cfg):
    """Every prefill chunk of two or more tokens runs the scan once per
    layer; a one-token chunk and every decode step run the plain decode
    step (the reference has no kernel there)."""
    def expected(decode_steps, chunks):
        scan = sum(c >= 2 for c in chunks)
        return ({"ssd_scan": cfg.num_layers * scan},
                {"ssd_scan": f"{cfg.num_layers} per prefill chunk of >= 2 "
                 f"tokens x {scan} chunks; {len(chunks) - scan} one-token "
                 f"chunks and {decode_steps} decode steps run the decode "
                 "step"})
    return expected


def device_profile(fn, groups: dict) -> dict:
    """Run ``fn`` (which ends in a host sync) under torch.profiler:
    host wall, device time by kernel group (``groups`` maps a group to a
    substring of its kernels' names) and the number of device ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_kernel: dict[str, float] = collections.Counter()
    n_device_ops = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.name] += e.time_range.elapsed_us()
            n_device_ops += 1
    by_group: dict[str, float] = collections.Counter()
    for name, us in by_kernel.items():
        by_group[next((g for g, sub in groups.items() if sub in name),
                      "other")] += us
    others = sorted(((us, n) for n, us in by_kernel.items()
                     if not any(sub in n for sub in groups.values())),
                    reverse=True)
    return {"wall_us": wall_us, "busy_us": sum(by_kernel.values()),
            "n_device_ops": n_device_ops, "by_group": by_group,
            "others": others}


def timed(fn) -> float:
    """Host wall of ``fn`` in µs, synchronized at both ends."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6


def profile_summary(what, unprofiled_us, prof, steps, report) -> dict:
    busy_us = prof["busy_us"]
    out = {"wall_ms": unprofiled_us / 1e3,
           "profiled_wall_ms": prof["wall_us"] / 1e3,
           "device_busy_ms": busy_us / 1e3,
           "device_idle_share": (max(0.0, 1.0 - busy_us / unprofiled_us)
                                 if busy_us else None),
           "device_idle_share_profiled": (1.0 - busy_us / prof["wall_us"]
                                          if busy_us else None),
           "device_ops_per_step": prof["n_device_ops"] / steps,
           "device_ms_by_group": {k: v / 1e3
                                  for k, v in prof["by_group"].items()},
           "top_other_kernels_ms": [(n[:120], us / 1e3)
                                    for us, n in prof["others"][:6]]}
    if not busy_us:
        report(f"profile {what}: torch.profiler recorded no device time "
               "(device idle share not measured)")
        return out
    report(f"profile {what}: wall {out['wall_ms']:.2f} ms "
           f"({out['profiled_wall_ms']:.2f} ms under the profiler), device "
           f"busy {out['device_busy_ms']:.2f} ms, idle share "
           f"{out['device_idle_share']:.3f} "
           f"({out['device_idle_share_profiled']:.3f} under the profiler); "
           f"{out['device_ops_per_step']:.0f} device ops per step; device ms "
           + ", ".join(f"{k} {v:.3f}" for k, v in sorted(
               out["device_ms_by_group"].items())))
    report(f"profile {what}: largest other kernels (ms): " + "; ".join(
        f"{n[:60]} {ms:.3f}" for n, ms in out["top_other_kernels_ms"]))
    return out


def profile_quantum(engine, prompts, report, groups) -> dict:
    """Where one full 8-step decode quantum spends its time: device
    kernel time by kernel (torch.profiler's CUDA activity) against the
    host wall of the quantum.  Four fresh requests fill the warm engine;
    one quantum runs unprofiled first, and its wall is the denominator of
    the idle share (the profiler's own host cost inflates the profiled
    quantum's wall, so the idle share under the profiler is an upper
    bound)."""
    from repro_torch.core import cost_model as cm
    from repro_torch.serving.engine import Request

    engine.set_interference_level(cm.grid_point(0))
    for i, p in enumerate(prompts[:BATCH_SLOTS]):
        require(engine.admit_request(Request(
            rid=100 + i, prompt=p, max_new_tokens=4 * QUANTUM), drain=True),
            "profile: no free slot")
    unprofiled_us = timed(lambda: engine.step_quantum(QUANTUM))
    prof = device_profile(lambda: engine.step_quantum(QUANTUM), groups)
    return profile_summary(f"{engine.cfg.name} one {QUANTUM}-step quantum "
                           "at level 0, 4 rows", unprofiled_us, prof,
                           QUANTUM, report)


def _host_group(file: str, name: str) -> str:
    """cProfile's function key -> where that host time goes."""
    if "repro_torch" in file:
        return "port Python"
    if file == "~":
        # a C function called from Python: torch's ops (argument parsing,
        # dispatch, the launch) or a Python builtin
        # (torch's functions live on a type object, _VariableFunctions)
        return ("torch C++ ops" if "torch" in name or "Tensor" in name
                or "of type object" in name else "Python builtins")
    if "torch/cuda" in file:
        return "torch.cuda Python (device contexts, streams)"
    if "/torch/" in file:
        return "torch Python"
    return "other Python"


def host_profile(engine, prompts, report) -> dict:
    """Where the host's time goes in one eager 8-step decode quantum of
    four rows: cProfile's own time per function, grouped into the port's
    Python (model code, kernel wrappers with their ctypes calls, tile
    lookups, tree walks), torch's C++ ops (PyTorch's eager dispatch and
    the launches it makes), torch's Python (``torch.cuda.device``
    contexts, ``current_stream``) and the rest.  cProfile adds a fixed
    cost to every Python call, so its shares are read beside the
    unprofiled wall of the same quantum."""
    import cProfile
    import pstats
    import torch
    from repro_torch.core import cost_model as cm
    from repro_torch.serving.engine import Request

    engine.set_interference_level(cm.grid_point(0))
    for i, p in enumerate(prompts[:BATCH_SLOTS]):
        require(engine.admit_request(Request(
            rid=300 + i, prompt=p, max_new_tokens=4 * QUANTUM), drain=True),
            "host profile: no free slot")
    wall_us = timed(lambda: engine.step_quantum(QUANTUM))
    prof = cProfile.Profile()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof.enable()
    engine.step_quantum(QUANTUM)
    torch.cuda.synchronize()
    prof.disable()
    profiled_us = (time.perf_counter() - t0) * 1e6
    stats = pstats.Stats(prof).stats
    groups: dict[str, float] = collections.Counter()
    funcs = []
    for (file, line, name), (_, calls, tottime, cumtime, _) in stats.items():
        groups[_host_group(file, name)] += tottime * 1e6
        funcs.append((tottime * 1e6, calls, cumtime * 1e6,
                      f"{pathlib.Path(file).name}:{line}({name})"))
    funcs.sort(reverse=True)
    total = sum(groups.values())
    # the same quantum under torch.profiler's CPU activity: the host time
    # spent inside torch's ops, whatever called them (cProfile books an
    # op reached through an operator, x * y or x[i], to the Python line)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as tprof:
        t0 = time.perf_counter()
        engine.step_quantum(QUANTUM)
        torch.cuda.synchronize()
        tprof_us = (time.perf_counter() - t0) * 1e6
    op_us = sum(e.self_cpu_time_total for e in tprof.key_averages())
    n_ops = sum(e.count for e in tprof.key_averages()
                if e.key.startswith("aten::"))
    for slot, req in enumerate(engine.slot_req):
        if req is not None and req.rid >= 300:
            engine.release_slot(slot)
    out = {"tool": "cProfile, torch.profiler (CPU)",
           "wall_ms": wall_us / 1e3,
           "torch_profiler_wall_ms": tprof_us / 1e3,
           "torch_profiler_op_ms": op_us / 1e3,
           "torch_profiler_aten_ops": n_ops,
           "profiled_wall_ms": profiled_us / 1e3,
           "profiled_total_ms": total / 1e3,
           "share": {g: us / total for g, us in groups.items()},
           "ms": {g: us / 1e3 for g, us in groups.items()},
           "top_functions": [{"fn": f, "tottime_ms": t / 1e3, "calls": n,
                              "cumtime_ms": c / 1e3}
                             for t, n, c, f in funcs[:25]]}
    report(f"host profile {engine.cfg.name} one eager {QUANTUM}-step "
           f"quantum (cProfile): wall {out['wall_ms']:.2f} ms unprofiled, "
           f"{out['profiled_wall_ms']:.2f} ms profiled; own time by group "
           + ", ".join(f"{g} {out['ms'][g]:.1f} ms ({s:.3f})"
                       for g, s in sorted(out["share"].items(),
                                          key=lambda kv: -kv[1])))
    report(f"host profile {engine.cfg.name} (torch.profiler, CPU): "
           f"{out['torch_profiler_op_ms']:.1f} ms inside torch's ops "
           f"({out['torch_profiler_aten_ops']} aten ops) of "
           f"{out['torch_profiler_wall_ms']:.1f} ms profiled wall")
    report(f"host profile {engine.cfg.name}: largest own times (ms, calls): "
           + "; ".join(f"{d['fn']} {d['tottime_ms']:.1f} x{d['calls']}"
                       for d in out["top_functions"][:10]))
    return out


def profile_prefill_chunk(engine, prompt, report, groups) -> dict:
    """One 16-token prefill chunk (a whole 16-token prompt: the chunk
    ends in the admission's first-token sync), unprofiled and then
    profiled, on fresh requests; their slots are released after."""
    from repro_torch.core import cost_model as cm
    from repro_torch.serving.engine import Request

    engine.set_interference_level(cm.grid_point(0))
    walls = []
    for rid in (200, 201):
        require(engine.admit_request(Request(
            rid=rid, prompt=prompt[:16], max_new_tokens=1)),
            "profile: no free slot")
        if not walls:
            walls.append(timed(engine.prefill_step))
        else:
            prof = device_profile(engine.prefill_step, groups)
    for slot, req in enumerate(engine.slot_req):
        if req is not None and req.rid in (200, 201):
            engine.release_slot(slot)
    return profile_summary(f"{engine.cfg.name} one 16-token prefill chunk",
                           walls[0], prof, 1, report)


def level_sweep(engine, prompts, report) -> dict:
    """After ``warmup()``, a full level sweep builds nothing: at every
    grid level an admission (its chunks), a one-step decode and fused
    quanta of every K-bucket, then the requests run out.  Every call is a
    replay of a graph captured in the warmup."""
    from repro_torch.core import cost_model as cm
    from repro_torch.serving.engine import Request

    vc = engine.version_cache
    traces0, misses0 = vc.traces, vc.misses
    replays0 = sum(c.replays for c in vc._calls.values())
    for i in range(cm.NUM_LEVELS):
        engine.set_interference_level(cm.grid_point(i))
        require(engine.admit_request(Request(
            rid=600 + i, prompt=prompts[i % 4], max_new_tokens=40),
            drain=True), "level sweep: no free slot")
        engine.step()
        for k in engine.quantum_buckets:
            engine.step_quantum(k)
    engine.run_to_completion([])
    replays = sum(c.replays for c in vc._calls.values()) - replays0
    require(vc.traces == traces0 and vc.misses == misses0,
            f"level sweep after warmup built {vc.traces - traces0} calls, "
            f"{vc.misses - misses0} versions")
    report(f"{engine.cfg.name}{' paged' if engine.paged else ''} level "
           f"sweep over {cm.NUM_LEVELS} levels after warmup: 0 captures, "
           f"{replays} graph replays")
    return {"levels": cm.NUM_LEVELS, "captures": 0, "replays": replays}


PAIRS = 5


def _summary(rows: list[dict]) -> dict:
    """Median, min and max of each measured key (None: not measured)."""
    out = {}
    for k in rows[0]:
        vals = [r[k] for r in rows if r[k] is not None]
        if vals:
            out[k] = {"median": statistics.median(vals), "min": min(vals),
                      "max": max(vals), "n": len(vals)}
    return out


def eager_graph_pairs(eager, graphed, prompts, report, groups, *,
                      chunk: bool) -> dict:
    """Alternating eager/graph pairs in one call, PAIRS of each: an
    8-step decode quantum of four rows at level 0 (and, with ``chunk``, a
    16-token prefill chunk that ends in the admission's first-token
    sync).  Each run is timed alone (the wall) and again under
    torch.profiler (device busy); the idle share is 1 - busy / wall.
    Pair i runs eager first when i is even, graphs first when odd."""
    from repro_torch.core import cost_model as cm
    from repro_torch.serving.engine import Request

    engines = {"eager": eager, "graphs": graphed}
    for eng in engines.values():
        eng.set_interference_level(cm.grid_point(0))
        for i, p in enumerate(prompts[:BATCH_SLOTS]):
            require(eng.admit_request(Request(
                rid=700 + i, prompt=p,
                max_new_tokens=2 * PAIRS * QUANTUM + 1), drain=True),
                "pairs: no free slot")

    def run(eng, kind, rid):
        if kind == "decode_quantum":
            def quantum_run():
                handle = eng.begin_quantum(QUANTUM)
                require(handle is not None and int(handle.n_left.sum()) ==
                        BATCH_SLOTS * QUANTUM, "pairs: a quantum ran short")
                eng.finish_quantum(handle)
            return quantum_run

        def chunk_run():
            require(eng.admit_request(Request(rid=rid, prompt=prompts[1][:16],
                                              max_new_tokens=1)),
                    "pairs: no free slot")
            eng.prefill_step()
            eng.release_slot(next(s for s, r in enumerate(eng.slot_req)
                                  if r is not None and r.rid == rid))
        return chunk_run

    out = {}
    for kind in ("decode_quantum", "prefill_chunk") if chunk else \
            ("decode_quantum",):
        if kind == "prefill_chunk":      # the chunk takes the last slot
            for eng in engines.values():
                eng.release_slot(next(
                    s for s, r in enumerate(eng.slot_req)
                    if r is not None and r.rid == 700 + BATCH_SLOTS - 1))
        rows = {name: [] for name in engines}
        for i in range(PAIRS):
            order = list(engines.items())
            if i % 2:
                order.reverse()
            for name, eng in order:
                wall_us = timed(run(eng, kind, 800 + 2 * i))
                prof = device_profile(run(eng, kind, 801 + 2 * i), groups)
                busy = prof["busy_us"]
                rows[name].append({
                    "wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
                    "idle_share": (max(0.0, 1.0 - busy / wall_us)
                                   if busy else None),
                    "decode_tokens_per_s": (
                        BATCH_SLOTS * QUANTUM / (wall_us / 1e6)
                        if kind == "decode_quantum" else None),
                    "device_ops": prof["n_device_ops"]})
        out[kind] = {name: {"runs": r, "summary": _summary(r)}
                     for name, r in rows.items()}
        for name in engines:
            sm = out[kind][name]["summary"]
            report(f"pairs {eager.cfg.name}{' paged' if eager.paged else ''}"
                   f" {kind} {name} ({PAIRS} runs, median [min, max]): "
                   + "; ".join(f"{k} {v['median']:.4g} [{v['min']:.4g}, "
                               f"{v['max']:.4g}]" for k, v in sm.items()))
    for eng in engines.values():
        for slot, req in enumerate(eng.slot_req):
            if req is not None and req.rid >= 700:
                eng.release_slot(slot)
    return out


def whole_model_check(cfg, params, prompt, dev, report) -> dict:
    import torch
    from repro_torch.models.model import Model

    results = {}
    kern, plain = Model(cfg), Model(cfg, use_kernels=False)
    toks = torch.as_tensor(prompt[:16], dtype=torch.int64,
                           device=dev)[None]
    rows = {m: m.init_cache(1, MAX_LEN, dev) for m in (kern, plain)}
    chunk = {m: m.prefill_chunk(params, {"tokens": toks}, rows[m], 0, 16)[0]
             for m in (kern, plain)}
    nxt = chunk[plain].argmax(dim=-1)
    pos = torch.tensor([16], device=dev)
    step = {m: m.decode_step(params, {"tokens": nxt}, rows[m], pos)[0]
            for m in (kern, plain)}
    for name, lg in (("prefill chunk", chunk), ("decode step", step)):
        diff = (lg[kern] - lg[plain]).abs().max().item()
        scale = lg[plain].abs().max().item()
        same_top = bool((lg[kern].argmax(-1) == lg[plain].argmax(-1)).all())
        results[name] = {"max_abs_diff": diff, "max_abs_logit": scale,
                         "same_argmax": same_top}
        report(f"whole model {name}: max |kernels - plain| {diff:.4g} "
               f"(max |logit| {scale:.4g}, tolerance "
               f"{LOGIT_RTOL} x max |logit|), same argmax: {same_top}")
        require(diff <= LOGIT_RTOL * scale,
                f"whole-model {name} logits drift {diff:.4g}")
    return results


def whole_model_check_paged(cfg, params, prompt, dev, report) -> dict:
    """Decode steps on a paged cache (pages of PAGE_SIZE shuffled over the
    pool, garbage in the trash page and the unmapped ones) through the
    kernels against the plain versions, and against the dense cache's
    decode through the kernels; every run starts from the same prompt
    cache (the plain model's 16-token prefill) and is fed the same
    tokens (the plain paged run's argmax).  Bound: LOGIT_RTOL x max
    |logit|, as ``whole_model_check``."""
    import torch
    from repro_torch.kernels import flash_attention_paged as fap
    from repro_torch.models.model import Model

    kern, plain = Model(cfg), Model(cfg, use_kernels=False)
    toks = torch.as_tensor(prompt[:16], dtype=torch.int64,
                           device=dev)[None]
    row = plain.init_cache(1, MAX_LEN, dev)
    logits, row = plain.prefill_chunk(params, {"tokens": toks}, row, 0, 16)
    n_slot, n_pages = MAX_LEN // PAGE_SIZE, 2 * (MAX_LEN // PAGE_SIZE)
    gen = torch.Generator(device=dev).manual_seed(1)
    table = (torch.randperm(n_pages, generator=gen, device=dev)[:n_slot]
             + 1).int()[None]

    def paged_cache():
        cache = kern.init_paged_cache(1, MAX_LEN, n_pages, PAGE_SIZE, dev)
        for leaf in ("k", "v"):
            pool = cache["blocks"]["dense"][leaf]
            pool.copy_(torch.randn(pool.shape, generator=gen, device=dev)
                       * 100.0)
            rows = row["blocks"]["dense"][leaf][:, 0]
            pool[:, table[0].long()] = rows.reshape(
                rows.shape[0], n_slot, PAGE_SIZE, *rows.shape[2:])
        cache["page_table"] = table.clone()
        return cache

    runs = {"kernels, paged": (kern, paged_cache()),
            "plain, paged": (plain, paged_cache()),
            "kernels, dense": (kern, {"blocks": {"dense": {
                k: v.clone() for k, v in row["blocks"]["dense"].items()}}})}
    nxt = logits.argmax(dim=-1)
    steps, results = 4, {}
    worst = {"plain": 0.0, "dense": 0.0}
    for step in range(steps):
        pos = torch.tensor([16 + step], device=dev)
        before = fap.launch_count()
        lg = {}
        for name, (m, cache) in runs.items():
            lg[name] = m.decode_step(params, {"tokens": nxt}, cache, pos)[0]
        torch.cuda.synchronize()
        require(fap.launch_count() - before == cfg.num_layers,
                f"paged decode step {step}: "
                f"{fap.launch_count() - before} paged-kernel launches")
        scale = lg["plain, paged"].abs().max().item()
        for other, key in (("plain, paged", "plain"),
                           ("kernels, dense", "dense")):
            diff = (lg["kernels, paged"] - lg[other]).abs().max().item()
            require(diff <= LOGIT_RTOL * scale and bool(torch.isfinite(
                lg["kernels, paged"]).all()), f"paged decode step {step}: "
                f"kernels vs {other} logits drift {diff:.4g}")
            worst[key] = max(worst[key], diff / scale)
        results[f"step {step}"] = {
            "max_abs_diff_plain": (lg["kernels, paged"]
                                   - lg["plain, paged"]).abs().max().item(),
            "max_abs_diff_dense": (lg["kernels, paged"]
                                   - lg["kernels, dense"]).abs().max().item(),
            "max_abs_logit": scale,
            "same_argmax": bool((lg["kernels, paged"].argmax(-1) ==
                                 lg["plain, paged"].argmax(-1)).all())}
        nxt = lg["plain, paged"].argmax(dim=-1)
    report(f"whole model {cfg.name} paged (page {PAGE_SIZE}, shuffled "
           f"table): {steps} decode steps from position 16, max |kernels "
           f"paged - plain paged| / max |logit| {worst['plain']:.4g}, max "
           f"|kernels paged - kernels dense| / max |logit| "
           f"{worst['dense']:.4g} (tolerance {LOGIT_RTOL}); same argmax "
           "as plain: " + ", ".join(str(r["same_argmax"])
                                    for r in results.values()))
    return results


def whole_model_check_ssm(cfg, params, prompt, dev, report) -> dict:
    """A monolithic prefill of ``len(prompt)`` tokens (three scan chunks
    of 256) through the kernel and through the plain versions.

    Layer by layer, each mixer gets the plain run's input once through
    the kernel and once through the plain version: outputs and SSD
    states must agree within LOGIT_RTOL of their largest entry (a wrong
    kernel is off by O(1)).  End to end, 48 residual layers of random
    weights amplify bf16 rounding flips, so the layer-by-layer check is
    the gate: the end-to-end drift of the logits and of the last layer's
    final SSD state is reported beside a yardstick (the same plain model
    with the scan cut into chunks of 128 instead of 256: the same
    function, summed in another order) but not bounded; the logits must
    be finite and of shape (1, vocab).  Then the engine's chunked schedule
    (16-token chunks, padded tail) runs over the same prompt through the
    kernel; its first-token logits are reported against the monolithic
    ones."""
    import dataclasses
    import torch
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as S
    from repro_torch.models.model import Model
    from repro_torch.models.params import tree_map_with_path

    toks = torch.as_tensor(prompt, dtype=torch.int64, device=dev)[None]
    # layer by layer, on the plain run's residual stream
    x = L.embed(params["embed"], toks, cfg)
    worst_out = worst_state = 0.0
    for i in range(cfg.num_layers):
        p = tree_map_with_path(lambda _, a: a[i], params["blocks"]["ssm"])
        xa = L.apply_norm(p["ln1"], x, cfg.norm_type)
        outs = {}
        for kern in (True, False):
            cache = tree_map_with_path(lambda _, a: a[0], Model(cfg).init_cache(
                1, MAX_LEN, dev)["blocks"]["ssm"])
            before = ssd.launch_count()
            out = S.mamba2_block(p["mixer"], xa, cfg=cfg, cache=cache,
                                 use_kernel_hook=kern)
            torch.cuda.synchronize()
            require(ssd.launch_count() - before == int(kern),
                    f"layer {i}: ssd_scan launches")
            outs[kern] = (out, cache["ssd"])
        for j, what in ((0, "output"), (1, "SSD state")):
            d = (outs[True][j].float() - outs[False][j].float()).abs().max()
            m = outs[False][j].float().abs().max()
            rel = (d / m).item()
            require(rel <= LOGIT_RTOL and bool(torch.isfinite(
                outs[True][j]).all()), f"layer {i} {what}: kernel vs "
                f"plain max |diff| {d.item():.4g} of max {m.item():.4g}")
            if j == 0:
                worst_out = max(worst_out, rel)
            else:
                worst_state = max(worst_state, rel)
        x = x + outs[False][0]
    report(f"whole model {cfg.name}, layer by layer on {len(prompt)} "
           f"tokens: kernel vs plain mixer, max |diff| / max |plain| "
           f"{worst_out:.4g} (outputs), {worst_state:.4g} (SSD states); "
           f"tolerance {LOGIT_RTOL}")
    # end to end, against the re-chunked plain yardstick
    cfg128 = dataclasses.replace(
        cfg, ssm=dataclasses.replace(cfg.ssm, chunk_size=128))
    runs = {"kernel": Model(cfg), "plain": Model(cfg, use_kernels=False),
            "plain chunk 128": Model(cfg128, use_kernels=False)}
    logits, states = {}, {}
    for name, m in runs.items():
        before = ssd.launch_count()
        logits[name], cache = m.prefill(params, {"tokens": toks},
                                        m.init_cache(1, MAX_LEN, dev))
        torch.cuda.synchronize()
        launched = ssd.launch_count() - before
        require(launched == (cfg.num_layers if name == "kernel" else 0),
                f"monolithic prefill ({name}) launched ssd_scan {launched} "
                "times")
        states[name] = cache["blocks"]["ssm"]["ssd"][-1]

    def drift(t, a, b):
        return (t[a] - t[b]).abs().max().item()
    diff, ydiff = drift(logits, "kernel", "plain"), drift(
        logits, "plain chunk 128", "plain")
    sdiff, ysdiff = drift(states, "kernel", "plain"), drift(
        states, "plain chunk 128", "plain")
    scale = logits["plain"].abs().max().item()
    smax = states["plain"].abs().max().item()
    same_top = bool((logits["kernel"].argmax(-1) ==
                     logits["plain"].argmax(-1)).all())
    report(f"whole model {cfg.name} monolithic prefill of {len(prompt)} "
           f"tokens: max |kernels - plain| logits {diff:.4g}, last layer's "
           f"SSD state {sdiff:.4g}; yardstick (plain, chunk 128 vs 256) "
           f"{ydiff:.4g} and {ysdiff:.4g}; max |logit| {scale:.4g}, max "
           f"|state| {smax:.4g}; same argmax: {same_top}")
    require(tuple(logits["kernel"].shape) == (1, cfg.vocab_size) and
            bool(torch.isfinite(logits["kernel"]).all()),
            "kernel logits not finite or of the wrong shape")
    kern = runs["kernel"]
    row = kern.init_cache(1, MAX_LEN, dev)
    t0 = 0
    while t0 < len(prompt):
        valid = min(16, len(prompt) - t0)
        c = 1 << (valid - 1).bit_length()
        chunk = torch.zeros((1, c), dtype=torch.int64, device=dev)
        chunk[0, :valid] = toks[0, t0:t0 + valid]
        chunked, row = kern.prefill_chunk(params, {"tokens": chunk}, row, t0,
                                          valid)
        t0 += valid
    cdiff = (chunked - logits["kernel"]).abs().max().item()
    csame = bool((chunked.argmax(-1) == logits["kernel"].argmax(-1)).all())
    require(bool(torch.isfinite(chunked).all()), "chunked logits not finite")
    report(f"whole model {cfg.name}: chunked (16-token chunks) vs monolithic "
           f"first-token logits max |diff| {cdiff:.4g}, same argmax: {csame}")
    return {"layer_max_rel_diff_output": worst_out,
            "layer_max_rel_diff_state": worst_state,
            "max_abs_diff": diff, "yardstick_max_abs_diff": ydiff,
            "max_abs_logit": scale, "same_argmax": same_top,
            "state_max_abs_diff": sdiff, "yardstick_state_max_abs_diff":
                ysdiff, "state_max_abs": smax,
            "chunked_vs_monolithic_max_abs_diff": cdiff,
            "chunked_same_argmax": csame}


def ssd_bound(bsz, l, h, p, n, q, with_init, groups=None
              ) -> tuple[float, str, int, int]:
    """The least time for one scan: each input byte read once (x, dt, a,
    B, C, the initial state) and each output written once (y, the final
    state) at 3.35 TB/s, against the causal products of each chunk of R
    rows (C.B^T and the score-weighted x over j <= i, C.h and the state
    update over all rows) at 989 TFLOP/s (the inputs are bf16).  B and C
    are counted once per group with ``groups`` (as the kernel reads the
    model's B and C), else once per head."""
    bc_heads = h if groups is None else groups
    nbytes = bsz * l * (h * (2 * p * 2 + 4) + bc_heads * 2 * n * 2) + \
        h * 4 + bsz * h * p * n * 4 * (1 + int(with_init))
    flops = 0
    for c0 in range(0, l, q):
        r = min(q, l - c0)
        flops += r * (r + 1) // 2 * (2 * n + 2 * p) + 4 * r * p * n
    flops *= bsz * h
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def ssd_phase_breakdown(dev, gen, report) -> dict:
    """Where one ``ssd_scan`` launch spends its time, at the serve's
    16-token chunk and at the 600-token prompt (B = 1, H 48, P 64, N 128,
    the state carried in): the kernel built with per-phase clock stamps
    (``ssd_scan.phase_clocks``) runs once after a warm-up launch, and
    each phase's mean over the blocks is reported beside the blocks' own
    span and the launch's span from the first block's start to the last
    block's end."""
    from repro_torch.kernels import ssd_scan as ssd
    out = {}
    for l in (16, MONO_LEN):
        x, dt, a, b, c, h0 = ssd_inputs(gen, dev, 1, l, 48, 64, 128, True,
                                        groups=1)
        ssd.phase_clocks(x, dt, a, b, c, initial_state=h0)
        got = ssd.phase_clocks(x, dt, a, b, c, initial_state=h0)
        out[l] = got
        report(f"ssd_scan phases L={l} (B=1 H=48 G=1 P=64 N=128, "
               f"{got['blocks']} blocks, SM clock {got['clock_ghz']:.3f} "
               "GHz; mean us per block): " + ", ".join(
                   f"{k} {v:.3f}" for k, v in got["phases_us"].items())
               + f"; block span {got['block_us']:.3f} us, launch span "
               f"{got['span_us']:.3f} us (first block start to last end)")
    return out


def ssd_timings(dev, gen, report) -> list[dict]:
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels.ref import ssd_ref
    import torch

    scratch = torch.empty(96 * 2**20, dtype=torch.uint8, device=dev)

    def flush():
        scratch.zero_()

    rows = []
    # the serve's prefill chunk and the monolithic prompt, both carrying
    # the cache's state in (the model always passes it)
    for label, l in (("serve chunk", 16), ("monolithic", MONO_LEN)):
        x, dt, a, b, c, h0 = ssd_inputs(gen, dev, 1, l, 48, 64, 128, True,
                                        groups=1)
        q = min(256, l)
        bound_ms, bound_by, nbytes, flops = ssd_bound(1, l, 48, 64, 128, q,
                                                      True, groups=1)
        row = {"name": "ssd_scan", "shape": label, "b": 1, "l": l,
               "h": 48, "p": 64, "n": 128, "chunk": q,
               "ms": cold_ms(lambda: ssd.ssd_scan(
                   x, dt, a, b, c, chunk_size=256, initial_state=h0), 20,
                   flush),
               "plain_ms": cold_ms(lambda: ssd_ref(
                   x, dt, a, b, c, chunk_size=256, initial_state=h0), 20,
                   flush),
               "library_ms": None, "bound_ms": bound_ms,
               "bound_by": bound_by, "bytes": nbytes, "flops": flops,
               "bound_ms_per_head": ssd_bound(1, l, 48, 64, 128, q,
                                              True)[0]}
        row["split"], row["blocks"] = ssd.launch_geometry(1, 48, 64)
        rows.append(row)
        report(f"time ssd_scan {label} B=1 L={l} H=48 G=1 P=64 N=128 "
               f"chunk={q}: kernel {row['ms']:.4f} ms (P split "
               f"{row['split']}, {row['blocks']} blocks), plain "
               f"{row['plain_ms']:.4f} ms, no library call, bound "
               f"{bound_ms:.5f} ms ({bound_by}: {nbytes} bytes, {flops} "
               f"flops; B and C once per group); with per-head copies of B "
               f"and C {row['bound_ms_per_head']:.5f} ms")
    return rows


def timings(dev, gen, report) -> list[dict]:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import block_matmul as bm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import attention_ref, matmul_ref
    from repro_torch.serving.engine import H100_LEVEL_TILES

    scratch = torch.empty(96 * 2**20, dtype=torch.uint8, device=dev)

    def flush():
        scratch.zero_()

    def read_flush():
        # evicts the L2 with clean lines: nothing to write back first
        scratch.view(torch.int64).sum()

    rows = []
    level0 = H100_LEVEL_TILES[0]
    # block_matmul: the decode step's MLP GEMMs (M = 4 slots)
    for label, (m, k, n) in (("decode gate/up", (4, 2048, 16384)),
                             ("decode down", (4, 16384, 2048)),
                             ("prefill-chunk gate/up", (16, 2048, 16384)),
                             ("prefill-chunk down", (16, 16384, 2048))):
        x = torch.randn(m, k, generator=gen, device=dev).bfloat16()
        w = (torch.randn(k, n, generator=gen, device=dev)
             * k ** -0.5).bfloat16()
        per_level = [cold_ms(lambda t=t: bm.block_matmul_2d(
            x, w, **t["matmul"]), 20, flush) for t in H100_LEVEL_TILES]
        geometry = [bm.launch_geometry(m, k, n, **t["matmul"])[1:]
                    for t in H100_LEVEL_TILES]
        nbytes = (m * k + k * n + m * n) * 2
        flops = 2 * m * k * n
        row = {"name": "block_matmul", "shape": label, "m": m, "k": k,
               "n": n, "ms": per_level[0], "ms_per_level": per_level,
               "split": geometry[0][0], "blocks": geometry[0][1],
               "split_blocks_per_level": geometry,
               "plain_ms": cold_ms(lambda: matmul_ref(x, w), 20, flush),
               "library_ms": cold_ms(lambda: torch.matmul(x, w), 20, flush),
               "ms_l2_clean": cold_ms(lambda: bm.block_matmul_2d(
                   x, w, **level0["matmul"]), 20, read_flush),
               "library_ms_l2_clean": cold_ms(lambda: torch.matmul(x, w),
                                              20, read_flush),
               "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                               flops / BF16_FLOPS) * 1e3,
               "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                            >= flops / BF16_FLOPS else "operations")}
        rows.append(row)
        report(f"time block_matmul {label} M={m} K={k} N={n}: kernel "
               f"{row['ms']:.4f} ms (level 0 tiles {level0['matmul']}, "
               f"split {row['split']}, {row['blocks']} blocks), plain "
               f"{row['plain_ms']:.4f} ms, torch.matmul "
               f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
               f"({row['bound_by']}); after a read-only L2 flush kernel "
               f"{row['ms_l2_clean']:.4f}, torch.matmul "
               f"{row['library_ms_l2_clean']:.4f} ms; per level ms "
               + ", ".join(f"{v:.4f}" for v in per_level)
               + "; per level (split, blocks) "
               + ", ".join(f"{g}" for g in geometry))
    # flash_attention: decode over the serve's positions and a prefill
    # chunk; the bound counts the keys this data makes visible
    for label, b, s, offs in (("decode", 4, 1, [68, 140, 260, 300]),
                              ("prefill chunk", 1, 16, [240])):
        h, t, d = 8, MAX_LEN, 256
        q = torch.randn(b, s, h, d, generator=gen, device=dev).bfloat16()
        kk = torch.randn(b, t, 1, d, generator=gen, device=dev).bfloat16()
        v = torch.randn(b, t, 1, d, generator=gen, device=dev).bfloat16()
        off = torch.tensor(offs, device=dev)
        kvl = off + s
        per_level = [cold_ms(lambda a=tl["attention"]: fa.flash_attention(
            q, kk, v, offset=off, kv_valid_len=kvl, **a), 20, flush)
            for tl in H100_LEVEL_TILES]
        geometry = [fa.launch_geometry(b, s, h, 1, t, **tl["attention"])[1:]
                    for tl in H100_LEVEL_TILES]
        qpos = off[:, None] + torch.arange(s, device=dev)
        mask = (torch.arange(t, device=dev)[None, None, :]
                <= qpos[:, :, None])[:, None]            # (B,1,S,T)
        qt = q.transpose(1, 2)
        kt, vt = (a.transpose(1, 2).expand(b, h, t, d) for a in (kk, v))

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        keys = sum(o + s for o in offs)               # visible keys, per head
        nbytes = (2 * b * s * h * d + 2 * keys * d) * 2 + 2 * b * 4
        flops = 4 * h * d * sum(
            sum(o + i + 1 for i in range(s)) for o in offs)
        row = {"name": "flash_attention", "shape": label, "b": b, "s": s,
               "t": t, "offsets": offs, "ms": per_level[0],
               "ms_per_level": per_level, "split": geometry[0][0],
               "blocks": geometry[0][1], "split_blocks_per_level": geometry,
               "plain_ms": cold_ms(lambda: attention_ref(
                   q, kk, v, offset=off, kv_valid_len=kvl), 20, flush),
               "library_ms": cold_ms(library, 20, flush),
               "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                               flops / BF16_FLOPS) * 1e3,
               "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                            >= flops / BF16_FLOPS else "operations")}
        rows.append(row)
        report(f"time flash_attention {label} B={b} S={s} T={t} "
               f"offsets={offs}: kernel {row['ms']:.4f} ms (level 0 tiles "
               f"{level0['attention']}, split {row['split']}, "
               f"{row['blocks']} blocks), plain {row['plain_ms']:.4f} ms, "
               f"sdpa {row['library_ms']:.4f} ms, bound "
               f"{row['bound_ms']:.5f} ms ({row['bound_by']}); per level ms "
               + ", ".join(f"{v:.4f}" for v in per_level)
               + "; per level (split, blocks) "
               + ", ".join(f"{g}" for g in geometry))
    return rows


def paged_bound(offs, ps, h, kh, d) -> tuple[float, str, int, int]:
    """The least time for one decode call of the paged kernel (one query
    per row, at position ``o``; kv_valid is ``o + 1``): each row's visible
    keys, ``o + 1`` of K and V (bf16), q and out (bf16), the
    ``ceil((o + 1) / ps)`` table entries that address those keys and the
    row's offset and kv_valid (int32), each read or written once at
    3.35 TB/s, against 4*D FLOPs per visible key and query head at
    989 TFLOP/s."""
    b = len(offs)
    keys = sum(o + 1 for o in offs)
    entries = sum(-(-(o + 1) // ps) for o in offs)
    nbytes = keys * kh * d * 2 * 2 + 2 * b * h * d * 2 + entries * 4 + \
        2 * b * 4
    flops = 4 * h * d * keys
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def paged_timings(dev, gen, report) -> list[dict]:
    """``flash_attention_paged`` at the paged serve's decode shape (4 rows,
    H 8, K 1, D 256, pages of PAGE_SIZE, the dense decode timing's
    positions): kernel, plain version (gather + dense attention), the
    bound, and a yardstick: SDPA over the K/V already gathered into dense
    rows (the gather is not counted; no single PyTorch call reads through
    a page table).  Then the same at rows of one 64-key tile each, which
    separates the kernel's cost per tile from its fixed cost."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention_paged as fap
    from repro_torch.kernels.ref import paged_attention_ref

    scratch = torch.empty(96 * 2**20, dtype=torch.uint8, device=dev)

    def flush():
        scratch.zero_()

    rows = []
    b, h, kh, d, t = 4, 8, 1, 256, MAX_LEN
    for label, offs in (("decode", [68, 140, 260, 300]),
                        ("decode, one tile per row", [63] * 4)):
        off = torch.tensor(offs, dtype=torch.int32, device=dev)
        kvl = off + 1
        q, kp, vp, table = paged_inputs(gen, dev, b, h, kh, d, PAGE_SIZE,
                                        kvl)
        kd = fap.gather_pages(kp, table)
        vd = fap.gather_pages(vp, table)
        mask = (torch.arange(t, device=dev)[None, None, None, :]
                <= off[:, None, None, None])             # (B,1,1,T)
        qt = q.transpose(1, 2)
        kt, vt = (a.transpose(1, 2).expand(b, h, t, d) for a in (kd, vd))
        bound_ms, bound_by, nbytes, flops = paged_bound(
            offs, PAGE_SIZE, h, kh, d)
        row = {"name": "flash_attention_paged", "shape": label, "b": b,
               "h": h, "kh": kh, "d": d, "page_size": PAGE_SIZE,
               "offsets": offs,
               "ms": cold_ms(lambda: fap.flash_attention_paged(
                   q, kp, vp, table, offset=off, kv_valid_len=kvl), 20,
                   flush),
               "plain_ms": cold_ms(lambda: paged_attention_ref(
                   q, kp, vp, table, offset=off, kv_valid_len=kvl), 20,
                   flush),
               "library_ms": cold_ms(lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, attn_mask=mask), 20, flush),
               "library": "scaled_dot_product_attention over K/V already "
                          "gathered into dense rows (gather not counted)",
               "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
               "flops": flops}
        row["split"], row["blocks"] = fap.launch_geometry(
            b, 1, h, kh, PAGE_SIZE, table.shape[1])
        rows.append(row)
        report(f"time flash_attention_paged {label} B={b} H={h} K={kh} "
               f"D={d} page {PAGE_SIZE} offsets={offs}: kernel "
               f"{row['ms']:.4f} ms (split {row['split']}, {row['blocks']} "
               f"blocks), plain {row['plain_ms']:.4f} ms, sdpa "
               f"over the gathered rows (gather not counted) "
               f"{row['library_ms']:.4f} ms, bound {bound_ms:.5f} ms "
               f"({bound_by}: {nbytes} bytes, {flops} flops)")
    return rows


def check_paged_serve(engine, out, report) -> None:
    """The paged serve's pool: prefix pages were shared and a shared page
    was copied before a write, nothing stalled, and the pool is empty
    after the serve.  Reports the pool's peak bytes against the dense
    cache's slots x MAX_LEN rows and the cache utilization."""
    stats = engine.page_stats
    require(stats["shared_hits"] >= 1 and stats["cow_copies"] >= 1,
            f"paged serve shared no prefix page or copied none: {stats}")
    require(stats["stalls"] == 0, f"paged serve stalled: {stats}")
    require(stats["used_pages"] == 0 and stats["committed"] == 0,
            f"paged serve left pages in use: {stats}")
    leaves = engine.cache["blocks"]["dense"]
    page_bytes = sum(a[:, 0].numel() * a.element_size()
                     for a in leaves.values())      # one page, all layers
    out["page_stats"] = stats
    out["cache_utilization"] = engine.cache_utilization
    out["pool_peak_bytes"] = stats["peak_used"] * page_bytes
    out["dense_cache_bytes"] = BATCH_SLOTS * MAX_LEN // PAGE_SIZE * \
        page_bytes
    report(f"paged serve pool: {stats}; cache utilization "
           f"{out['cache_utilization']:.4f}; peak {stats['peak_used']} pages "
           f"= {out['pool_peak_bytes'] / 2**20:.2f} MiB against "
           f"{out['dense_cache_bytes'] / 2**20:.2f} MiB for dense rows of "
           f"{BATCH_SLOTS} x {MAX_LEN}")


def serve_paged(cfg, params, prompts, dense_streams, dev, report,
                seed, card) -> tuple[dict, dict]:
    """Serve the dense serve's prompts again on a paged engine
    (``page_size=PAGE_SIZE``, the default 128 usable pages), with two
    requests that share the PAGED_BASE prompt's pages, then profile one
    paged decode quantum.  Exact launch accounting for all three kernels
    of the path; the pool's counters are checked after the serve; the
    streams of the dense serve's prompts are compared, not gated (the
    paged and dense kernels sum in different orders)."""
    import numpy as np
    from repro_torch.kernels import block_matmul as bm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_paged as fap

    base = prompts[PAGED_BASE]
    tail = np.random.default_rng(seed + 1).integers(0, cfg.vocab_size, 20)
    sharers = [np.concatenate([base[:2 * PAGE_SIZE],
                               tail.astype(np.int32)]),
               base[:PAGE_SIZE + PAGE_SIZE // 2].copy()]
    rest = [i for i in range(len(prompts)) if i != PAGED_BASE]
    order = [PAGED_BASE, rest[0]] + [None, None] + rest[1:]
    paged_prompts = [prompts[i] if i is not None else sharers.pop(0)
                     for i in order]
    counters = {"block_matmul": bm.LAUNCHES, "flash_attention": fa.LAUNCHES,
                "flash_attention_paged": fap.LAUNCHES}
    groups = {"block_matmul": "block_matmul_kernel",
              "flash_attention": "flash_attention_kernel",
              "flash_attention_paged": "paged_flash_kernel"}
    eager, eager_out = serve(cfg, params, paged_prompts, dev, report,
                             counters, paged_launches(cfg),
                             engine_kw={"page_size": PAGE_SIZE,
                                        "cuda_graphs": False},
                             after={2: 0, 3: 0})
    check_paged_serve(eager, eager_out, report)
    engine, out = serve(cfg, params, paged_prompts, dev, report, counters,
                        paged_launches(cfg),
                        engine_kw={"page_size": PAGE_SIZE},
                        after={2: 0, 3: 0})
    check_paged_serve(engine, out, report)
    same_streams(f"{cfg.name} paged", out, eager_out, report)
    out["eager"] = eager_out
    out["level_sweep"] = level_sweep(engine, prompts, report)
    out["pairs"] = eager_graph_pairs(eager, engine, prompts, report, groups,
                                     chunk=False)
    same = [out["streams"][j] == dense_streams[i]
            for j, i in enumerate(order) if i is not None]
    out["streams_equal_to_dense"] = sum(same)
    report(f"paged serve: {sum(same)} of {len(same)} token streams equal "
           "the dense serve's streams of the same prompts (not gated: the "
           "paged and dense attention kernels sum in different orders)")
    prof = profile_quantum(engine, prompts, report, groups)
    busy = prof["device_busy_ms"]
    share = (prof["device_ms_by_group"].get("flash_attention_paged", 0.0)
             / busy if busy else None)
    prof["flash_attention_paged_share"] = share
    report("profile paged quantum: flash_attention_paged share of device "
           "time " + ("not measured" if share is None else f"{share:.4f}"))
    del engine, eager
    gc.collect()
    out["runtime"] = serve_runtime_paged(cfg, params, dev, counters, report,
                                         seed, card)
    return out, prof


def same_streams(what, graphed, eager, report) -> None:
    """The graphed serve's token streams must be the eager serve's."""
    same = sum(a == b for a, b in zip(graphed["streams"], eager["streams"]))
    require(graphed["streams"] == eager["streams"],
            f"{what}: {same} of {len(eager['streams'])} token streams "
            "with CUDA graphs equal the eager serve's")
    report(f"{what}: {same} of {len(eager['streams'])} token streams with "
           "CUDA graphs equal the eager serve's (cuda_graphs=False) in this "
           "call; median quantum "
           f"{graphed['quantum_ms_median']:.2f} ms with graphs, "
           f"{eager['quantum_ms_median']:.2f} ms eager")


# ---------------------------------------------------------------------------
# The online runtime (TorchOnlineRuntime with VeltairPolicy in the loop)

RT_TENANTS = ("resnet50", "googlenet")
RT_TIERS = {"resnet50": "interactive", "googlenet": "batch"}
RT_QUERIES = 32
# offered load (Gamma-modulated, burstiness 4): arrivals keep coming while
# the first requests decode, so interactive prefills meet batch decodes,
# and all four slots fill
RT_QPS = 80.0
# the runtime's paged engine: two worst-case requests' pages (282 tokens,
# 18 pages of 16 each), so page commitments defer admissions while slots
# are free.  Worst-case reservation cannot stall a row; with prompt-only
# reservation a pool that binds lets this workload's rows all wait on a
# page at once (the reference does the same), so the clamp of a decode
# quantum by free pages is shown on a state built for it
# (``page_clamp_check``)
RT_PAGES = 36


def runtime_workload(seed: int):
    """The runtime phases' traffic: Gamma-modulated arrivals of two paper
    tenants (an interactive and a batch tier), prompts of 5-250 tokens,
    MAX_NEW new tokens each, offered faster than four slots drain."""
    from repro_torch.serving.runtime import Workload
    return Workload.bursty(list(RT_TENANTS), RT_QPS, RT_QUERIES,
                           prompt_len=250, prompt_len_spread=245,
                           max_new_tokens=MAX_NEW, seed=seed,
                           tiers=RT_TIERS)


class EngineCalls:
    """Times the engine's device-facing calls made by a runtime serve
    (admission, version switch, prefill chunk, quantum dispatch and
    finish: instance attributes that shadow the methods), records the
    K-bucket of every dispatched decode quantum and, on a paged engine,
    counts decode quanta clamped by free pages.  ``close()`` restores the
    engine."""

    TIMED = ("admit_request", "set_interference_level", "prefill_step",
             "begin_quantum", "finish_quantum")

    def __init__(self, engine):
        self.engine = engine
        self.inside_s = 0.0
        self.buckets: list[int] = []
        self.clamps = 0
        self.max_active = 0
        for name in self.TIMED:
            setattr(engine, name, self._timed(name, getattr(engine, name)))
        if engine.paged:
            headroom = engine.decode_k_headroom

            def clamped(k):
                got = headroom(k)
                self.clamps += got < k
                return got
            engine.decode_k_headroom = clamped

    def _timed(self, name, fn):
        def call(*args, **kw):
            self.max_active = max(self.max_active, self.engine.active_slots)
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            self.inside_s += time.perf_counter() - t0
            if name == "begin_quantum" and out is not None:
                self.buckets.append(out.bucket)
            return out
        return call

    def close(self) -> None:
        for name in (*self.TIMED, "decode_k_headroom"):
            self.engine.__dict__.pop(name, None)


def page_deferrals(admission) -> list:
    """Wrap an AdmissionController's decision (on the instance) to record
    deferrals on pages: a slot is free but the request's page commitment
    exceeds the uncommitted free pages."""
    decide = admission.decide
    seen: list = []

    def counted(**kw):
        d = decide(**kw)
        if d == "defer" and kw["slot_free"] and kw["pages_free"] is not None \
                and kw["pages_needed"] > kw["pages_free"]:
            seen.append((kw["entry"].rid, kw["pages_needed"],
                         kw["pages_free"]))
        return d
    admission.decide = counted
    return seen


def cuda_sync(engine) -> None:
    import torch
    if engine.device.type == "cuda":
        torch.cuda.synchronize()


def runtime_serve(engine, seed, counters, *, wall_clock=False,
                  admission=False, profile=False) -> dict:
    """One serve of ``runtime_workload(seed)`` through TorchOnlineRuntime
    with VeltairPolicy(CPU_3990X) over the paper tenants' plans: oracle
    counters in virtual time, measured counters in wall-clock mode.  The
    launch counters are zeroed just before the serve and read just after.
    ``profile`` runs the serve under torch.profiler and adds the device's
    busy time."""
    from repro_torch.core import cost_model as cm
    from repro_torch.core.scheduler import VeltairPolicy
    from repro_torch.serving.runtime import OnlineRuntime
    from repro_torch.serving.slo import AdmissionController
    from repro_torch.serving.tenants import build_paper_plans

    plans = build_paper_plans(list(RT_TENANTS), cm.CPU_3990X)
    adm = AdmissionController() if admission else None
    deferred_on_pages = page_deferrals(adm) if adm is not None else []
    rt = OnlineRuntime(engine, VeltairPolicy(cm.CPU_3990X), plans,
                       cm.CPU_3990X, wall_clock=wall_clock,
                       counter_source="measured" if wall_clock else "oracle",
                       admission=adm)
    wl = runtime_workload(seed)
    calls = EngineCalls(engine)
    traces0, syncs0 = engine.version_cache.traces, engine.host_syncs
    busy_ms = None
    cuda_sync(engine)
    for c in counters.values():
        c.clear()
    t0 = time.perf_counter()
    try:
        if profile and engine.device.type == "cuda":
            import torch
            from torch.profiler import ProfilerActivity, profile as tprof
            # the card's activity only: a whole serve is ~10^6 events, and
            # the host ops would double them for nothing the share needs
            with tprof(activities=[ProfilerActivity.CUDA]) as prof:
                metrics = rt.serve(wl)
                cuda_sync(engine)
                wall_s = time.perf_counter() - t0
            busy_ms = device_busy_ms(prof)
        else:
            metrics = rt.serve(wl)
            cuda_sync(engine)
            wall_s = time.perf_counter() - t0
    finally:
        calls.close()
    trace_s = time.perf_counter() - t0 - wall_s
    launches = {name: sum(c.values()) for name, c in counters.items()}
    chunks = [size for kind, size, _, _ in rt.quantum_log
              if kind == "prefill"]
    return {"runtime": rt, "metrics": metrics, "workload": wl,
            "wall_s": wall_s, "inside_s": calls.inside_s,
            "buckets": calls.buckets, "chunks": chunks,
            "clamps": calls.clamps, "deferred_on_pages": deferred_on_pages,
            "max_active": calls.max_active,
            "builds": engine.version_cache.traces - traces0,
            "host_syncs": engine.host_syncs - syncs0,
            "launches": launches, "busy_ms": busy_ms, "trace_s": trace_s}


def device_busy_ms(prof) -> float:
    """The card's busy time in a torch.profiler trace: the summed
    durations of its device events, read from the profiler's raw results
    (building its Python event tree for the ~10^6 events of a whole serve
    takes minutes), else from its events."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    raw = getattr(prof.profiler, "kineto_results", None)
    if raw is not None:
        return sum(e.duration_ns() for e in raw.events()
                   if e.device_type() == cuda) / 1e6
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == cuda) / 1e3


def check_runtime_serve(what, run, expected, report) -> dict:
    """The checks every runtime serve must pass: every arrival served or
    shed, nothing built, one host sync per decode quantum and per
    finished prompt, and launches equal to the forward passes the serve
    ran (each decode quantum runs its K-bucket)."""
    rt, m, wl = run["runtime"], run["metrics"], run["workload"]
    decodes = [ev for ev in rt.sched_trace if ev[0] == "decode"]
    require(m.n_queries + m.shed_queries == wl.n_queries and
            len(rt.outputs) == m.n_queries, f"{what}: {m.n_queries} served "
            f"+ {m.shed_queries} shed of {wl.n_queries}")
    require(all(len(toks) == wl.max_new_tokens + 1
                for toks in rt.outputs.values()),
            f"{what}: a request ended short")
    require(run["builds"] == 0, f"{what}: {run['builds']} builds (captures) "
            "during the serve")
    require(len(decodes) == len(run["buckets"]),
            f"{what}: {len(decodes)} decode quanta traced, "
            f"{len(run['buckets'])} dispatched")
    require(run["host_syncs"] == len(decodes) + m.n_queries,
            f"{what}: {run['host_syncs']} host syncs for {len(decodes)} "
            f"decode quanta + {m.n_queries} finishing prefill chunks")
    want, why = expected(sum(run["buckets"]), run["chunks"])
    for name, n in run["launches"].items():
        require(n == want[name], f"{what}: {name} {n} launches, expected "
                f"{want[name]} ({why[name]})")
    levels = collections.Counter(cm_idx(x) for x in rt.level_trace)
    out = {"queries": m.n_queries, "shed": m.shed_queries,
           "deferred": m.deferred_queries, "decode_quanta": len(decodes),
           "decode_steps": sum(run["buckets"]),
           "prefill_chunks": len(run["chunks"]),
           "host_syncs": run["host_syncs"], "launches": run["launches"],
           "expected_launches": want, "levels": dict(sorted(levels.items())),
           "counter_sources": dict(rt.counter_sources),
           "clamped_quanta": run["clamps"],
           "deferred_on_pages": len({d[0] for d in run["deferred_on_pages"]}),
           "max_active_slots": run["max_active"],
           "serve_wall_s": run["wall_s"]}
    report(f"{what}: {m.n_queries} served, {m.shed_queries} shed, "
           f"{m.deferred_queries} deferred ({out['deferred_on_pages']} on "
           f"pages); {len(decodes)} decode quanta ({out['decode_steps']} "
           f"steps), {out['prefill_chunks']} prefill chunks; "
           f"{run['host_syncs']} host syncs; 0 captures; levels (grid "
           f"index: quanta) {out['levels']}; launches " + ", ".join(
               f"{k} {v} ({why[k]})" for k, v in run["launches"].items()))
    return out


def cm_idx(level: float) -> int:
    from repro_torch.core import cost_model as cm
    return cm.level_to_idx(level)


def preemptions(rt) -> int:
    """Interactive prefill chunks scheduled while a batch-tier request
    was mid-decode (it decoded before the chunk and again after)."""
    tiers = {}
    for ev in rt.sched_trace:
        if ev[0] == "prefill":
            tiers[ev[1]] = ev[2]
    seen_decode: dict[int, int] = {}
    last_decode: dict[int, int] = {}
    for i, ev in enumerate(rt.sched_trace):
        if ev[0] == "decode":
            for rid in ev[1]:
                seen_decode.setdefault(rid, i)
                last_decode[rid] = i
    return sum(1 for i, ev in enumerate(rt.sched_trace)
               if ev[0] == "prefill" and ev[2] == "interactive" and any(
                   tiers.get(rid) == "batch" and seen_decode[rid] < i
                   < last_decode[rid] for rid in seen_decode))


def metrics_summary(m) -> dict:
    out = {k: getattr(m, k) for k in (
        "n_queries", "qos_rate", "avg_latency_s", "p99_latency_s",
        "avg_ttft_s", "qps_at_qos", "qps_offered", "conflict_rate",
        "shed_queries", "deferred_queries", "refit_count",
        "proxy_rms_error", "peak_cache_tokens", "cache_utilization")}
    out["per_tier"] = {t: dataclasses.asdict(v)
                       for t, v in m.per_tier.items()}
    return out


def wall_clock_report(what, run, card, report) -> dict:
    """What a wall-clock serve measured: the metrics (their latencies are
    the card's under this host; qos_rate and qps_at_qos hold them to the
    paper's CPU QoS targets and say nothing about the card), counter
    sources, the level histogram, the switch time, the wall per quantum
    by kind, the runtime's own host time per quantum and the device idle
    share (set by the caller from a profiled rerun)."""
    rt, m = run["runtime"], run["metrics"]
    log = rt.quantum_log
    by_kind: dict[str, list[float]] = collections.defaultdict(list)
    for kind, size, final, dt in log:
        key = (f"decode K={size}" if kind == "decode" else
               "prefill final chunk" if final else "prefill chunk")
        by_kind[key].append(dt * 1e3)
    walls = {k: {"n": len(v), "median_ms": statistics.median(v),
                 "min_ms": min(v), "max_ms": max(v), "sum_ms": sum(v)}
             for k, v in sorted(by_kind.items())}
    host_ms = (run["wall_s"] - run["inside_s"]) * 1e3 / max(len(log), 1)
    out = {"card": card, "metrics": metrics_summary(m),
           "counter_sources": dict(rt.counter_sources),
           "levels": dict(sorted(collections.Counter(
               cm_idx(x) for x in rt.level_trace).items())),
           "compile_time_s": rt.compile_time_s, "quanta": len(log),
           "quantum_wall_ms": walls,
           "serve_wall_s": run["wall_s"],
           "inside_engine_s": run["inside_s"],
           "runtime_host_ms_per_quantum": host_ms}
    tiers = "; ".join(f"{t} n {v.n_queries} avg {v.avg_latency_s * 1e3:.2f} "
                      f"ms p99 {v.p99_latency_s * 1e3:.2f} ms ttft "
                      f"{v.avg_ttft_s * 1e3:.2f} ms"
                      for t, v in m.per_tier.items())
    report(f"{what} [{card}]: {m.n_queries} served in "
           f"{run['wall_s']:.3f} s; latency avg {m.avg_latency_s * 1e3:.2f}"
           f" ms, p99 {m.p99_latency_s * 1e3:.2f} ms, ttft avg "
           f"{m.avg_ttft_s * 1e3:.2f} ms; per tier: {tiers}; qps_at_qos "
           f"{m.qps_at_qos:.2f} (against the paper's CPU QoS targets: not "
           f"a statement about the card); proxy refits {m.refit_count}; "
           f"counter sources {out['counter_sources']}; levels "
           f"{out['levels']}; version switches {rt.compile_time_s * 1e3:.3f}"
           " ms in all")
    report(f"{what} [{card}]: wall per quantum (ms, median [min, max] x n; "
           "a decode quantum and a final prefill chunk end in the host sync,"
           " a non-final chunk's wall is its enqueue): " + "; ".join(
               f"{k} {v['median_ms']:.3f} [{v['min_ms']:.3f}, "
               f"{v['max_ms']:.3f}] x{v['n']}" for k, v in walls.items()))
    report(f"{what} [{card}]: runtime host time {host_ms:.3f} ms per quantum"
           f" (serve wall {run['wall_s']:.3f} s minus "
           f"{run['inside_s']:.3f} s inside the engine's calls, over "
           f"{len(log)} quanta)")
    return out


def idle_share(what, wall_s, run, card, report) -> dict:
    busy = run["busy_ms"]
    out = {"unprofiled_wall_s": wall_s, "profiled_wall_s": run["wall_s"],
           "trace_processing_s": run["trace_s"], "device_busy_ms": busy,
           "device_idle_share": (max(0.0, 1.0 - busy / (wall_s * 1e3))
                                 if busy else None)}
    if not busy:
        report(f"{what} [{card}]: torch.profiler recorded no device time "
               "(device idle share not measured)")
        return out
    report(f"{what} [{card}]: device busy {busy:.1f} ms under "
           f"torch.profiler against {wall_s * 1e3:.1f} ms unprofiled wall: "
           f"idle share {out['device_idle_share']:.4f} (profiled serve wall "
           f"{run['wall_s'] * 1e3:.1f} ms; reading the trace took "
           f"{run['trace_s']:.1f} s)")
    return out


def serve_runtime_dense(eager, graphed, cfg, counters, report, seed,
                        card) -> dict:
    """Phase 3's runtime serves on the warm engines of the dense serve:
    the workload in virtual time on the graphed and then the eager
    engine (identical traces, streams and metrics), then in wall-clock
    mode with measured counters on the graphed engine, unprofiled and
    profiled."""
    expected = dense_launches(cfg)
    runs, out = {}, {}
    for name, eng in (("graphs", graphed), ("eager", eager)):
        runs[name] = runtime_serve(eng, seed, counters)
        out[name] = check_runtime_serve(
            f"runtime {cfg.name} virtual time, {name}", runs[name],
            expected, report)
    g, e = runs["graphs"]["runtime"], runs["eager"]["runtime"]
    require(g.sched_trace == e.sched_trace and g.level_trace ==
            e.level_trace, "runtime: graphed and eager traces differ")
    require(g.outputs == e.outputs, "runtime: graphed and eager streams "
            "differ")
    # (repr: the oracle runs' proxy_rms_error is NaN on both)
    require(repr(runs["graphs"]["metrics"]) ==
            repr(runs["eager"]["metrics"]),
            "runtime: graphed and eager metrics differ")
    require(len(out["graphs"]["levels"]) > 1, "runtime: one level only")
    full = runs["graphs"]["max_active"]
    require(full == BATCH_SLOTS, f"runtime: at most {full} slots occupied")
    pre = preemptions(g)
    require(pre > 0, "runtime: no interactive prefill chunk preempted a "
            "batch decode")
    out["preemptions"] = pre
    out["metrics_workload_time"] = metrics_summary(runs["graphs"]["metrics"])
    report(f"runtime {cfg.name} virtual time: graphed == eager (traces, "
           f"streams, metrics); {pre} interactive prefill chunks ran "
           "between a batch request's decode quanta; workload-time "
           f"metrics (step_dt 1 ms, not the card's): "
           f"{out['metrics_workload_time']}")
    wall = runtime_serve(graphed, seed, counters, wall_clock=True)
    out["wall_clock_checks"] = check_runtime_serve(
        f"runtime {cfg.name} wall clock, graphs", wall, expected, report)
    out["wall_clock"] = wall_clock_report(
        f"runtime {cfg.name} wall clock", wall, card, report)
    prof = runtime_serve(graphed, seed, counters, wall_clock=True,
                         profile=True)
    out["wall_clock"]["idle"] = idle_share(
        f"runtime {cfg.name} wall clock", wall["wall_s"], prof, card,
        report)
    return out


def page_clamp_check(engine, seed, report) -> dict:
    """The SLO scheduler's pick on the paged engine when free pages bind:
    with prompt-only reservation, a request of 20 pages' prompt (319
    tokens) and one of 16 (255 tokens) fill the RT_PAGES pool; each row's
    next step fits its last page, a second step needs a page the pool
    does not have.  ``pick_quantum`` asked for 16 steps must pick 1, and
    that 1-step quantum runs without a stall; the slots are then
    released and the pool must be empty."""
    import numpy as np
    from repro_torch.serving.engine import Request
    from repro_torch.serving.slo import DeadlineBook, pick_quantum

    require(engine.pool.total == RT_PAGES and engine.active_slots == 0,
            "page clamp: the engine is not idle")
    rng = np.random.default_rng(seed + 2)
    reserve = engine.page_reserve
    engine.page_reserve = "prompt"
    try:
        for rid, n in ((900, 20 * PAGE_SIZE - 1), (901, 16 * PAGE_SIZE - 1)):
            require(engine.admit_request(Request(
                rid=rid, prompt=rng.integers(0, engine.cfg.vocab_size, n)
                .astype(np.int32), max_new_tokens=MAX_NEW), drain=True),
                "page clamp: admission refused")
        free = engine.pool.free_pages
        pick = pick_quantum(engine, DeadlineBook(), 0.0, 1e-3, 16)
        handle = engine.begin_quantum(pick[1])
        require(handle is not None and handle.steps == 1,
                "page clamp: the clamped quantum did not run one step")
        engine.finish_quantum(handle)
        stalls = engine.page_stats["stalls"]
    finally:
        for slot, req in enumerate(engine.slot_req):
            if req is not None:
                engine.release_slot(slot)
        engine.page_reserve = reserve
    require(free == 0 and pick == ("decode", 1) and stalls == 0,
            f"page clamp: {free} free pages, pick {pick}, {stalls} stalls")
    require(engine.pool.used_pages == 0 and engine.pool.committed == 0,
            f"page clamp: pages left in use: {engine.page_stats}")
    report(f"page clamp: {RT_PAGES} of {RT_PAGES} pages held by two rows "
           "(prompt-only reservation); pick_quantum asked for 16 steps "
           f"picked {pick}; that quantum ran 1 step with 0 stalls; the pool "
           "is empty after the slots are released")
    return {"free_pages": free, "pick": list(pick), "stalls": stalls}


def serve_runtime_paged(cfg, params, dev, counters, report, seed,
                        card) -> dict:
    """The runtime on a paged engine whose pool binds (RT_PAGES pages of
    PAGE_SIZE, worst-case reservation) under an AdmissionController,
    graphed and warm: in virtual time (admissions deferred on pages,
    exact launches, an empty pool after), then in wall-clock mode; then
    the scheduler's pick on a state where free pages clamp a quantum."""
    from repro_torch.serving.engine import ServingEngine

    engine = ServingEngine(cfg, params, batch_slots=BATCH_SLOTS,
                           max_len=MAX_LEN, device=dev, page_size=PAGE_SIZE,
                           n_pages=RT_PAGES)
    t0 = time.perf_counter()
    engine.warmup()
    cuda_sync(engine)
    report(f"runtime {cfg.name} paged engine ({RT_PAGES} pages of "
           f"{PAGE_SIZE}, worst-case reservation): warmup "
           f"{time.perf_counter() - t0:.2f} s")
    expected = paged_launches(cfg)
    out = {}
    run = runtime_serve(engine, seed, counters, admission=True)
    out["virtual"] = check_runtime_serve(
        f"runtime {cfg.name} paged virtual time", run, expected, report)
    require(run["deferred_on_pages"], "runtime paged: no admission "
            "deferred on pages")
    stats = engine.page_stats
    require(stats["used_pages"] == 0 and stats["committed"] == 0,
            f"runtime paged: pages left in use: {stats}")
    out["virtual"]["page_stats"] = stats
    out["virtual"]["metrics_workload_time"] = metrics_summary(run["metrics"])
    wall = runtime_serve(engine, seed, counters, wall_clock=True,
                         admission=True)
    out["wall_clock_checks"] = check_runtime_serve(
        f"runtime {cfg.name} paged wall clock", wall, expected, report)
    out["wall_clock"] = wall_clock_report(
        f"runtime {cfg.name} paged wall clock", wall, card, report)
    prof = runtime_serve(engine, seed, counters, wall_clock=True,
                         admission=True, profile=True)
    out["wall_clock"]["idle"] = idle_share(
        f"runtime {cfg.name} paged wall clock", wall["wall_s"], prof, card,
        report)
    require(engine.page_stats["used_pages"] == 0,
            "runtime paged: pages left in use after the wall-clock serves")
    out["page_clamp"] = page_clamp_check(engine, seed, report)
    del engine
    gc.collect()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--b2-reference", metavar="TREE",
                    help="another checkout whose flash_attention build every "
                         "B2 check must equal bit for bit")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda_build
    from repro_torch.models.model import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    lines: list[str] = []

    def report(line: str) -> None:
        lines.append(line)
        print(line, flush=True)

    card = card_line()
    report(card)
    t0 = time.perf_counter()
    logs = cuda_build.build()
    build_s = time.perf_counter() - t0
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_ptxas.log").write_text(
        "\n".join(f"=== {k}\n{v}" for k, v in logs.items()))
    ptxas = {name: ptxas_summary(log) for name, log in logs.items()}
    report(f"kernel build: {build_s:.1f} s for {sorted(logs) or 'nothing'} "
           "(nvcc sm_90a); ptxas: " + "; ".join(
               f"{name} {p['kernels']} kernels, at most {p['max_registers']} "
               f"registers, {p['spilling_kernels']} spilling"
               for name, p in sorted(ptxas.items())))
    for name in cuda_build.SOURCES:
        require(name not in ptxas or ptxas[name]["spilling_kernels"] == 0,
                f"{name}: register spills {ptxas[name]['spill_lines']}")

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    b2_ref = reference_b2(args.b2_reference) if args.b2_reference else None
    worst = check_kernels(dev, gen, report, b2_ref)
    worst["ssd_scan"] = check_ssd(dev, gen, report)
    worst["flash_attention_paged"] = check_paged(dev, gen, report)
    ssd_phases = ssd_phase_breakdown(dev, gen, report)

    from repro_torch.kernels import block_matmul as bm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    rng = np.random.default_rng(args.seed)
    served, prof, model_check, host = {}, {}, {}, {}
    for name in ("gemma-2b", "mamba2-780m"):
        cfg = get_config(name)
        t0 = time.perf_counter()
        params = Model(cfg).init(torch.Generator(device=dev).manual_seed(
            args.seed), dev)
        torch.cuda.synchronize()
        widths = (f"d_ff {cfg.d_ff}" if cfg.ssm is None else
                  f"d_inner {cfg.ssm.d_inner}, {cfg.ssm.num_heads} SSD "
                  f"heads x {cfg.ssm.head_dim}, state {cfg.ssm.state_dim}")
        report(f"{name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
               f"{widths}, vocab {cfg.vocab_size}; weights made on the "
               f"card in {time.perf_counter() - t0:.1f} s")
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                   for n in PROMPT_LENS]
        if cfg.ssm is None:
            counters = {"block_matmul": bm.LAUNCHES,
                        "flash_attention": fa.LAUNCHES}
            groups = {"block_matmul": "block_matmul_kernel",
                      "flash_attention": "flash_attention_kernel"}
            expected = dense_launches(cfg)
        else:
            counters, groups = ({"ssd_scan": ssd.LAUNCHES},
                                {"ssd_scan": "ssd_scan_kernel"})
            expected = ssm_launches(cfg)
        eager, eager_out = serve(cfg, params, prompts, dev, report, counters,
                                 expected, engine_kw={"cuda_graphs": False})
        engine, served[name] = serve(cfg, params, prompts, dev, report,
                                     counters, expected)
        same_streams(name, served[name], eager_out, report)
        served[name]["eager"] = eager_out
        if cfg.ssm is None:
            served[name]["runtime"] = serve_runtime_dense(
                eager, engine, cfg, counters, report, args.seed, card)
        served[name]["level_sweep"] = level_sweep(engine, prompts, report)
        served[name]["pairs"] = eager_graph_pairs(
            eager, engine, prompts, report, groups, chunk=True)
        host[name] = host_profile(eager, prompts, report)
        prof[name] = {}
        if cfg.ssm is not None:
            prof[name]["prefill_chunk"] = profile_prefill_chunk(
                engine, prompts[1], report, groups)
        prof[name]["decode_quantum"] = profile_quantum(engine, prompts,
                                                       report, groups)
        del engine, eager
        gc.collect()             # the version caches' graphs and pools
        if cfg.ssm is None:
            model_check[name] = whole_model_check(cfg, params, prompts[1],
                                                  dev, report)
            paged = f"{name} paged"
            served[paged], prof[paged] = serve_paged(
                cfg, params, prompts, served[name]["streams"], dev, report,
                args.seed, card)
            model_check[paged] = whole_model_check_paged(
                cfg, params, prompts[1], dev, report)
        else:
            model_check[name] = whole_model_check_ssm(
                cfg, params, rng.integers(0, cfg.vocab_size, MONO_LEN),
                dev, report)
        del params
        torch.cuda.empty_cache()
    times = (timings(dev, gen, report) + ssd_timings(dev, gen, report)
             + paged_timings(dev, gen, report))

    kernels = []
    for name, src, replaces, model in (
            ("block_matmul", "src/repro_torch/csrc/block_matmul.cu",
             "src/repro/kernels/block_matmul.py:25", "gemma-2b"),
            ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:31", "gemma-2b"),
            ("ssd_scan", "src/repro_torch/csrc/ssd_scan.cu",
             "src/repro/kernels/ssd_scan.py:23", "mamba2-780m"),
            ("flash_attention_paged",
             "src/repro_torch/csrc/flash_attention_paged.cu",
             "src/repro/kernels/flash_attention.py:141", "gemma-2b paged")):
        row = next(r for r in times if r["name"] == name)
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": sum(served[model]["launches"][name].values()),
            "max_abs_err": worst[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps({
        "card": card, "build_s": build_s, "ptxas": ptxas, "serve": served,
        "profile": prof, "host_profile": host, "whole_model": model_check,
        "times": times,
        "ssd_phases": ssd_phases,
        "kernels": kernels, "lines": lines}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
