#!/usr/bin/env python3
"""The PyTorch/CUDA port's main path on one NVIDIA GPU (an H100).

Run from the repository root, with one card visible:

    python3 chip_smoke.py [--seed N]

Phases, each fatal on failure:
  1. card: name and power limit, then the build of every CUDA kernel of
     ``src/repro_torch/csrc`` (one nvcc per source, in parallel);
  2. every kernel against its plain PyTorch version, in bf16 at the
     serving path's shapes, under every distinct tile of the H100 level
     table, plus ragged shapes;
  3. serve: full-width gemma-2b (18 layers, seeded random weights made on
     the card) through ``ServingEngine(batch_slots=4, max_len=512)`` after
     ``warmup()``: six requests admitted with ``admit_request`` +
     ``prefill_step`` and decoded by 8-step quanta while the interference
     level cycles; the launch counters are zeroed just before and read
     just after, and must equal the forward passes run times the
     kernel calls of one pass;
  4. profile: one 8-step decode quantum under torch.profiler, device
     time by kernel and the device's idle share;
  5. whole-model check: first-prefill-chunk and first-decode logits
     through the kernels and through the plain versions, same weights;
  6. times at the serve's shapes: kernel, plain version, one PyTorch call
     as a yardstick, and the bound (bytes at 3.35 TB/s or FLOPs at
     989 TFLOP/s, whichever is larger).

The line before the last is the ``{"kernels": [...]}`` record; the last
line is ``{"ok": true, "device": {...}}``.  Details land in
``chiprun_out/chip_smoke.json``.  Imports nothing of JAX or of the JAX
package.
"""
from __future__ import annotations

import argparse
import collections
import json
import pathlib
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
# whole-model logits, kernels vs plain versions: activations round to
# bf16 after every op, so a one-ulp flip anywhere in 18 residual layers
# propagates; bound the drift at 5% of the largest logit
LOGIT_RTOL = 5e-2

PROMPT_LENS = (5, 37, 64, 100, 180, 250)
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


def cold_ms(fn, n: int, flush) -> float:
    """Median device time of ``fn`` over ``n`` launches, each after the
    L2 cache was flushed (the serving path finds its inputs cold: the
    MLP weights stream through L2 between two calls of one layer)."""
    import torch
    pairs = []
    fn()
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


def errors(got, want) -> tuple[float, float, bool]:
    """(max abs err, max rel err, within ATOL + RTOL*|want|)."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    rel = diff / w.abs().clamp_min(ATOL)
    ok = bool((diff <= ATOL + RTOL * w.abs()).all())
    return diff.max().item(), rel.max().item(), ok


def check_kernels(dev, gen, report) -> dict:
    import torch
    from repro_torch.kernels import block_matmul as bm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import attention_ref, matmul_ref
    from repro_torch.serving.engine import H100_LEVEL_TILES

    worst = {"block_matmul": 0.0, "flash_attention": 0.0}
    mm_tiles = list({tuple(sorted(t["matmul"].items())): t["matmul"]
                     for t in H100_LEVEL_TILES}.values())
    att_tiles = list({tuple(sorted(t["attention"].items())): t["attention"]
                      for t in H100_LEVEL_TILES}.values())
    shapes = [(m, k, n) for m in (4, 16)
              for k, n in ((2048, 16384), (16384, 2048))]
    shapes += [(37, 300, 129), (3, 2056, 72), (129, 65, 1000)]   # ragged
    n_checks = 0
    tol = f"tolerance {ATOL:.4g} + {RTOL:.4g}*|plain|"
    for m, k, n in shapes:
        x = torch.randn(m, k, generator=gen, device=dev).bfloat16()
        w = (torch.randn(k, n, generator=gen, device=dev)
             * k ** -0.5).bfloat16()
        want = matmul_ref(x, w)
        case_abs = case_rel = 0.0
        for tiles in mm_tiles:
            got = bm.block_matmul_2d(x, w, **tiles)
            torch.cuda.synchronize()
            ea, er, ok = errors(got, want)
            case_abs, case_rel = max(case_abs, ea), max(case_rel, er)
            n_checks += 1
            require(ok, f"block_matmul {(m, k, n)} tiles {tiles}: max abs "
                    f"err {ea:.4g}, max rel err {er:.4g} beyond {tol}")
        worst["block_matmul"] = max(worst["block_matmul"], case_abs)
        report(f"block_matmul M={m} K={k} N={n}: {len(mm_tiles)} tiles ok, "
               f"max abs err {case_abs:.4g}, max rel err {case_rel:.4g} "
               f"({tol})")
    cases = {
        "prefill chunk": dict(b=1, s=16, t=512, off=[32], kvl=[48]),
        "decode": dict(b=4, s=1, t=512, off=[5, 100, 300, 511],
                       kvl=[6, 101, 301, 512]),
    }
    for name, c in cases.items():
        q = torch.randn(c["b"], c["s"], 8, 256, generator=gen,
                        device=dev).bfloat16()
        kk = torch.randn(c["b"], c["t"], 1, 256, generator=gen,
                         device=dev).bfloat16()
        v = torch.randn(c["b"], c["t"], 1, 256, generator=gen,
                        device=dev).bfloat16()
        off = torch.tensor(c["off"], device=dev)
        kvl = torch.tensor(c["kvl"], device=dev)
        for window, softcap in ((None, None), (64, 50.0)):
            want = attention_ref(q, kk, v, offset=off, kv_valid_len=kvl,
                                 window=window, softcap=softcap)
            case_abs = case_rel = 0.0
            for tiles in att_tiles:
                got = fa.flash_attention(q, kk, v, offset=off,
                                         kv_valid_len=kvl, window=window,
                                         softcap=softcap, **tiles)
                torch.cuda.synchronize()
                ea, er, ok = errors(got, want)
                case_abs, case_rel = max(case_abs, ea), max(case_rel, er)
                n_checks += 1
                require(ok, f"flash_attention {name} window={window} "
                        f"softcap={softcap} tiles {tiles}: max abs err "
                        f"{ea:.4g}, max rel err {er:.4g} beyond {tol}")
            worst["flash_attention"] = max(worst["flash_attention"],
                                           case_abs)
            report(f"flash_attention {name} window={window} "
                   f"softcap={softcap}: {len(att_tiles)} tiles ok, max abs "
                   f"err {case_abs:.4g}, max rel err {case_rel:.4g} ({tol})")
    report(f"kernel checks: {n_checks} passed; max abs err "
           f"block_matmul {worst['block_matmul']:.4g}, flash_attention "
           f"{worst['flash_attention']:.4g} ({tol})")
    return worst


def serve(cfg, params, prompts, dev, report) -> dict:
    import torch
    from repro_torch.core import cost_model as cm
    from repro_torch.kernels import block_matmul as bm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.serving.engine import Request, ServingEngine

    engine = ServingEngine(cfg, params, batch_slots=BATCH_SLOTS,
                           max_len=MAX_LEN, device=dev)
    t0 = time.perf_counter()
    stats = engine.warmup()
    torch.cuda.synchronize()
    report(f"warmup: {time.perf_counter() - t0:.2f} s, {stats}")
    reqs = [Request(rid=i, prompt=p, max_new_tokens=MAX_NEW)
            for i, p in enumerate(prompts)]
    levels = [cm.grid_point(i) for i in (0, 5, 9)]
    syncs0, switches0 = engine.host_syncs, engine.level_switches
    builds0, tokens0 = engine.version_cache.traces, engine.tokens_decoded
    chunks0 = engine.prefill_chunks
    torch.cuda.reset_peak_memory_stats()
    bm.LAUNCHES.clear()
    fa.LAUNCHES.clear()
    pending = collections.deque(reqs)
    quanta = finishing_prefills = decode_steps = 0
    quantum_ms, quantum_tokens = [], 0
    t_start = time.perf_counter()
    turn = 0
    while pending or engine.active_slots:
        while pending and engine.admit_request(pending[0]):
            pending.popleft()
        while engine.prefill_pending:
            finishing_prefills += engine.prefill_step().finished
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
    launches = {"block_matmul": dict(bm.LAUNCHES),
                "flash_attention": dict(fa.LAUNCHES)}
    peak = torch.cuda.max_memory_allocated()
    syncs = engine.host_syncs - syncs0
    for r in reqs:
        require(r.done and len(r.output) == MAX_NEW + 1,
                f"request {r.rid} ended with {len(r.output)} tokens")
    require(syncs == quanta + finishing_prefills,
            f"{syncs} host syncs for {quanta} quanta + "
            f"{finishing_prefills} finishing prefills")
    require(engine.level_switches - switches0 >= 3,
            f"{engine.level_switches - switches0} level switches")
    require(engine.version_cache.traces == builds0,
            "the serve built a version after warmup")
    # every forward pass (a decode step or a prefill chunk) runs each
    # layer's three MLP GEMMs and its attention through the kernels
    passes = decode_steps + engine.prefill_chunks - chunks0
    per_pass = {"block_matmul": 3 * cfg.num_layers,
                "flash_attention": cfg.num_layers}
    for name, per_tile in launches.items():
        n = sum(per_tile.values())
        require(n > 0, f"{name} never launched")
        require(n == per_pass[name] * passes,
                f"{name}: {n} launches for {passes} forward passes, "
                f"expected {per_pass[name]} per pass")
    tokens = engine.tokens_decoded - tokens0
    out = {
        "requests": len(reqs), "tokens": tokens, "wall_s": wall,
        "tokens_per_s": tokens / wall,
        "decode_tokens_per_s": quantum_tokens / (sum(quantum_ms) / 1e3),
        "quanta": quanta, "quantum_ms_median": statistics.median(quantum_ms),
        "quantum_ms": quantum_ms,
        "prefill_chunks": engine.prefill_chunks - chunks0,
        "decode_steps": decode_steps, "launches_per_pass": per_pass,
        "host_syncs": syncs, "level_switches":
            engine.level_switches - switches0,
        "max_memory_allocated": peak,
        "launches": {k: {str(t): n for t, n in v.items()}
                     for k, v in launches.items()},
    }
    report(f"serve: {len(reqs)} requests x {MAX_NEW + 1} tokens, "
           f"{tokens} tokens in {wall:.3f} s = {out['tokens_per_s']:.1f} "
           f"tokens/s; {quanta} quanta, median {out['quantum_ms_median']:.2f}"
           f" ms/quantum ({out['decode_tokens_per_s']:.1f} decode tokens/s);"
           f" {syncs} host syncs; {out['level_switches']} level switches; "
           f"max_memory_allocated {peak / 2**30:.2f} GiB")
    for name, per_tile in launches.items():
        report(f"launches {name}: {sum(per_tile.values())} "
               f"({per_pass[name]} per forward pass x {passes} passes = "
               f"{decode_steps} decode steps + {out['prefill_chunks']} "
               "prefill chunks); by tile "
               + ", ".join(f"{t}: {n}" for t, n in sorted(per_tile.items())))
    return engine, out


def profile_quantum(engine, prompts, report) -> dict:
    """Where one full 8-step decode quantum spends its time: device
    kernel time by kernel (torch.profiler's CUDA activity) against the
    host wall of the quantum.  Four fresh requests fill the warm engine;
    one quantum runs unprofiled first, and its wall is the denominator of
    the idle share (the profiler's own host cost inflates the profiled
    quantum's wall, so the idle share under the profiler is an upper
    bound)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import cost_model as cm
    from repro_torch.serving.engine import Request

    engine.set_interference_level(cm.grid_point(0))
    for i, p in enumerate(prompts[:BATCH_SLOTS]):
        require(engine.admit_request(Request(
            rid=100 + i, prompt=p, max_new_tokens=4 * QUANTUM), drain=True),
            "profile: no free slot")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.step_quantum(QUANTUM)
    torch.cuda.synchronize()
    unprofiled_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.step_quantum(QUANTUM)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_kernel: dict[str, float] = collections.Counter()
    n_device_ops = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.name] += e.time_range.elapsed_us()
            n_device_ops += 1
    busy_us = sum(by_kernel.values())
    groups: dict[str, float] = collections.Counter()
    for name, us in by_kernel.items():
        key = ("block_matmul" if "block_matmul_kernel" in name else
               "flash_attention" if "flash_attention_kernel" in name else
               "other")
        groups[key] += us
    others = sorted(((us, n) for n, us in by_kernel.items()
                     if "block_matmul_kernel" not in n
                     and "flash_attention_kernel" not in n), reverse=True)
    out = {"wall_ms": unprofiled_us / 1e3,
           "profiled_wall_ms": wall_us / 1e3,
           "device_busy_ms": busy_us / 1e3,
           "device_idle_share": (max(0.0, 1.0 - busy_us / unprofiled_us)
                                 if busy_us else None),
           "device_idle_share_profiled": (1.0 - busy_us / wall_us
                                          if busy_us else None),
           "device_ops_per_step": n_device_ops / QUANTUM,
           "device_ms_by_group": {k: v / 1e3 for k, v in groups.items()},
           "top_other_kernels_ms": [(n[:120], us / 1e3)
                                    for us, n in others[:6]]}
    if not busy_us:
        report("profile: torch.profiler recorded no device time "
               "(device idle share not measured)")
        return out
    report(f"profile: one {QUANTUM}-step quantum at level 0, 4 rows: "
           f"wall {out['wall_ms']:.2f} ms ({out['profiled_wall_ms']:.2f} "
           f"ms under the profiler), device busy "
           f"{out['device_busy_ms']:.2f} ms, idle share "
           f"{out['device_idle_share']:.3f} ("
           f"{out['device_idle_share_profiled']:.3f} under the profiler); "
           f"{out['device_ops_per_step']:.0f} device ops per decode step; "
           "device ms "
           + ", ".join(f"{k} {v:.2f}" for k, v in sorted(
               out["device_ms_by_group"].items())))
    report("profile: largest other kernels (ms): " + "; ".join(
        f"{n[:60]} {ms:.3f}" for n, ms in out["top_other_kernels_ms"]))
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
        nbytes = (m * k + k * n + m * n) * 2
        flops = 2 * m * k * n
        row = {"name": "block_matmul", "shape": label, "m": m, "k": k,
               "n": n, "ms": per_level[0], "ms_per_level": per_level,
               "plain_ms": cold_ms(lambda: matmul_ref(x, w), 20, flush),
               "library_ms": cold_ms(lambda: torch.matmul(x, w), 20, flush),
               "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                               flops / BF16_FLOPS) * 1e3,
               "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                            >= flops / BF16_FLOPS else "operations")}
        rows.append(row)
        report(f"time block_matmul {label} M={m} K={k} N={n}: kernel "
               f"{row['ms']:.4f} ms (level 0 tiles {level0['matmul']}), "
               f"plain {row['plain_ms']:.4f} ms, torch.matmul "
               f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
               f"({row['bound_by']}); per level ms "
               + ", ".join(f"{v:.4f}" for v in per_level))
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
               "ms_per_level": per_level,
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
               f"{level0['attention']}), plain {row['plain_ms']:.4f} ms, "
               f"sdpa {row['library_ms']:.4f} ms, bound "
               f"{row['bound_ms']:.5f} ms ({row['bound_by']}); per level ms "
               + ", ".join(f"{v:.4f}" for v in per_level))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
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
    spills = sum(" 0 bytes spill stores" not in ln
                 for v in logs.values() for ln in v.splitlines()
                 if "spill stores" in ln)
    report(f"kernel build: {build_s:.1f} s for {sorted(logs) or 'nothing'} "
           f"(nvcc sm_90a; {spills} kernel(s) with register spills)")

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    worst = check_kernels(dev, gen, report)

    cfg = get_config("gemma-2b")
    t0 = time.perf_counter()
    params = Model(cfg).init(torch.Generator(device=dev).manual_seed(
        args.seed), dev)
    torch.cuda.synchronize()
    report(f"gemma-2b: {cfg.num_layers} layers, d_model {cfg.d_model}, "
           f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; weights made on the "
           f"card in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPT_LENS]
    engine, served = serve(cfg, params, prompts, dev, report)
    prof = profile_quantum(engine, prompts, report)
    del engine
    model_check = whole_model_check(cfg, params, prompts[1], dev, report)
    times = timings(dev, gen, report)

    kernels = []
    for name, src, replaces in (
            ("block_matmul", "src/repro_torch/csrc/block_matmul.cu",
             "src/repro/kernels/block_matmul.py:25"),
            ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:31")):
        row = next(r for r in times if r["name"] == name)
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": sum(served["launches"][name].values()),
            "max_abs_err": worst[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps({
        "card": card, "build_s": build_s, "serve": served,
        "profile": prof, "whole_model": model_check, "times": times,
        "kernels": kernels, "lines": lines}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
