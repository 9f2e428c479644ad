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
     tile of the H100 level table: B1 at M = 1, 4, 16 over gemma-2b's and
     starcoder2-3b's MLP GEMMs, at M = 4, 16 and 20 over
     recurrentgemma-2b's (2560 -> 7680 -> 2560: uneven split-K ranges),
     over deepseek-v2-lite-16b's dense MLP (2048 -> 10944 -> 2048: a
     ragged last N tile, 171 K tiles) and shared experts (2048 <-> 2816),
     at M = 4, 16 and 20 over phase 13's GEMMs (arctic-480b's dense
     residual 7168 <-> 4864, llama3-405b's 16384 <-> 53248, minicpm-2b's
     2304 <-> 5760) and phase 14's (qwen2-vl-2b's 1536 <-> 8960,
     musicgen-large's 2048 <-> 8192), and a K that a cluster of 8 cannot
     split evenly, B2 at phase 13's KV groups (7 and 16 at D 128, 1 at D
     64) and phase 14's (6 at D 128: a chunk's two row tiles split
     position 10's heads; 1 at D 64 over 32 KV heads): decode at
     positions 0 and 511, 16-token chunks, a verify, B2 with MQA and GQA
     at gemma-2b's heads and at starcoder2-3b's (24 over 2 KV heads, D
     128), decode rows at positions 0 and 511, 16-token chunks and a
     speculative verify pass (B 4, S 5), at recurrentgemma-2b's (10 over
     1, D 256) under its 2048-token window over a 2100-token prefill (the
     window binds) and 16-token chunks, and every block B2 is built for
     at split 8; ``ssd_scan`` at the serve's chunks, a three-chunk
     monolithic prompt, B = 4 and ragged shapes, with B and C per group
     (G = 1, as the model passes them) and per head; ``flash_attention_paged``
     at page sizes 8, 16 and 32 over shuffled page tables at split 8, rows
     with no visible key, windowed and softcapped cases, gemma-2b's and
     starcoder2-3b's head shapes, verify passes of five queries a row (also
     past a full slot), phase 13's three groups (llama3-405b's verify: 80
     rows, two row tiles) and phase 14's two, also against the dense
     kernel), plus
     ragged shapes; every wrapper's shared-memory count held to the
     kernel's; with ``--b2-reference TREE`` every B2 output also equal to
     that checkout's B2 build bit for bit; then ``ssd_scan``'s phase
     breakdown (clock stamps per phase) at 16 and 600 tokens;
  3. serve gemma-2b: full width (9 of its 18 layers: EARLY_LAYERS;
     seeded random weights made on the card) through
     ``ServingEngine(batch_slots=4, max_len=512)`` after
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
     (torch.profiler), idle share and decode tokens/s, and PAIRS more
     the graphed engine on its own stream against one built on the
     current stream (what a stream of its own costs); and a host profile
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
     mamba2-780m the same way (6 of its 48 layers: EARLY_LAYERS,
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
  8. (run right after phase 2, beside phase 17 (b)'s tracers: every
     time here is device time between CUDA events, the stream held by
     a device sleep while the host enqueues the loop, so the host's
     load does not enter it) times at the serve's shapes (B2 and B3 also at a verify pass's,
     five queries a row; B1 and B2 also at recurrentgemma-2b's: its MLP
     at M = 4, 16 and 20, B1 at deepseek-v2-lite-16b's four GEMMs at M =
     4, 16 and 20, the 2100-token windowed prefill and 16-token
     chunks; B1 at phase 13's and phase 14's GEMMs at M = 4, 16 and 20,
     B2 and B3 at their KV groups, at the level-0 tile only): kernel,
     plain version, one
     PyTorch call
     as a yardstick where one exists, and the bound (bytes at 3.35 TB/s
     or FLOPs at 989 TFLOP/s, whichever is larger); the split and block
     count of each launch (for B1 and B2 at each level), and B1 and its
     yardstick again after an L2 flush that leaves no dirty lines;
  9. co-location: ``hardware_spec_for`` checks the card against
     ``H100_SXM``; ``cluster_plans`` compiles gemma-2b, starcoder2-3b and
     mamba2-780m for it (each plan's QoS, its tile source's versions and
     the tile each level selects, all built B1 tiles held against the
     plain version in phase 2); the plans select one version at every
     level, so each tile source gets CL_SECOND_TILE from level
     CL_SWITCH_LEVEL up; ``build_cluster`` stands up the three at full
     width (``batch_slots=4``, ``max_len=512``, seeded weights made on the
     card), each engine on a CUDA stream of its own; starcoder2-3b's
     logits through the kernels are held against the plain versions; and
     ``ClusterRuntime.warmup`` captures the two versions the levels
     select.  CL_QUERIES Poisson queries then run in
     virtual time with oracle counters under ``VeltairPolicy`` (every
     query served, every tick within the 132 SMs and the pool whole
     after, a level per quantum, nothing captured, one host sync per
     decode quantum and per finished prompt, exact launch counts, every
     engine running both of its versions), and every request is served
     again alone on its engine through the code versions and steps it
     met, which must give its co-located token stream; then in wall-clock
     mode with measured counters on separate streams (and a profiled
     rerun), under ``PremaPolicy`` (at most one engine granted per tick),
     and on three engines built on one shared stream (the same weights,
     warmed before they serve): latencies, wall and runtime host time per tick, tokens/s,
     levels, and the device's idle share and the streams' overlap from
     CUDA events around every dispatch (and from the kernels' busy time
     in the profiled rerun);
 10. speculative decode quanta (run inside phases 3 and 6, on their
     weights and their graphed engines as the plain side): speculative
     engines (``speculative=True, spec_depth=SPEC_DEPTH``, warmed at the
     levels the serves cycle: captures and seconds reported) for
     gemma-2b dense, gemma-2b paged (against a plain paged engine built
     here) and mamba2-780m at 6 layers serve two arms in 8-step quanta
     while the level cycles: repetitive (constant-token prompts of
     20-250 tokens on gemma-2b, echo prompts on mamba2-780m;
     SPEC_REP_NEW new tokens) and adversarial (the serve's random
     prompts, MAX_NEW new tokens), SPEC_PAIRS alternating plain/spec
     serves each (wall, tokens/s, spec/plain, draft hit rate).  Fatal:
     every stream equals the plain engine's or parts at a tie of the
     plain logits (recomputed through a one-step decode) within
     SPEC_TIE_ULPS bf16 ulps: two on gemma-2b, eight on mamba2-780m,
     partings beyond two counted apart; verifies, accepted tokens and
     rollbacks all above 0 per configuration (where the two arms' n-gram
     drafts never roll back or never hold, one more serve of the random
     prompts drafts, every quantum, the token after each row's last); exact launches (B1 3 and B2 1 per layer and dense
     verify, B3 1 and B2 0 per layer and paged verify, B4 2 per layer
     and mamba2 verify, plus the
     plain quanta and prefill chunks); an eager speculative serve equal
     to the graphed one (streams, launches, ``spec_stats``); nothing
     captured after warmup; the paged pool empty after; a verify with a
     row at MAX_LEN - 1 - d beside a slot mid-prefill at MAX_LEN - 2
     without a fault and the slot's cache unchanged; mamba2's restore
     pass leaving the state of ``n_emit`` plain steps (bit-equal to the
     state carried in where ``n_emit`` is 0).  Reported: one verify
     quantum under torch.profiler against a 1-step plain quantum;
 11. the hybrid family: recurrentgemma-2b at full width and 8 of its
     26 layers (EARLY_LAYERS, for the script's time: (rec, rec, attn) x
     2 + (rec, rec); the RG-LRU in plain ops,
     a ring of the last 2048 keys per attention layer), seeded weights
     made on the card, ``batch_slots=4``, ``max_len=512``, warmed at the
     levels 0/5/9 and K-buckets 1-8.  Fatal: the six prompts x MAX_NEW
     tokens served eagerly and with graphs give equal streams, nothing
     captured after warmup, one host sync a quantum, B1 exactly 24
     launches per decode step and chunk and B2, B3, B4 none; a
     ``chunked_prefill=False`` serve (B2 2 times per monolithic prefill)
     equals the chunked streams or parts at a two-ulp tie; a
     RING_PROMPT-token prompt prefilled monolithically (B2's window
     binding) and in 16-token chunks (the ring wraps), then RING_STEPS
     decode steps: logits within RING_RTOL of the largest, tokens equal
     where clear, ring positions equal; the whole model through the
     kernels against the plain versions (monolithic prefill, decode
     step, chunk); the restore pass (B1 48, B2 0 per verify; layer by
     layer h within STATE_RTOL, conv and ring within two bf16 ulps, ring
     positions equal, a row emitting nothing unchanged); a speculative
     engine on constant-token prompts (echo prompts too if those draft
     nothing) with exact launches, streams equal or parting at two-ulp
     ties, verifies, acceptances and rollbacks above 0.  Reported: a
     profiled 8-step quantum and 16-token chunk, warmup captures and
     seconds, the phase's seconds.  A failed check is reported and the
     phase runs on; it fails at its end;
 12. the moe family: deepseek-v2-lite-16b at its published widths and 5
     of its 27 layers (EARLY_LAYERS, for the script's time: ``pro_0`` a
     dense MLP of 10944, then 4 ``moe_ds`` blocks:
     MLA with a 512 + 64 latent cache, 64 routed experts top-6 at capacity
     factor 1.25, 2 shared experts as one MLP of 2816), seeded weights made
     on the card after the earlier phases' engines are freed,
     ``batch_slots=4``, ``max_len=512``.  Fatal: the six prompts x MAX_NEW
     tokens served eagerly and with graphs (levels 0/5/9, K-buckets 1-8)
     give equal streams (the same schedule routes the same groups),
     nothing captured after warmup, one host sync a quantum, B1 exactly 15
     launches a forward pass (``moe_launches``) and B2, B3, B4 none; an
     eager monolithic serve (the first four prompts) and an eager paged
     serve (prefix sharing, the pool checks of phase 7, B3 none) at one
     level with exact launches, their streams against the chunked serve's
     reported (capacity MoE depends on the routing groups); the whole
     model through the kernels against the plain versions (chunk, step,
     monolithic prefill) within LOGIT_RTOL, or, past it, a first router
     decision that differs at a probability gap within ROUTER_TIE (every
     flip and the routers' input drift reported); a speculative serve at
     one level on constant-token prompts, every quantum a verify of the
     last token's copies (random deepseek's stream does not repeat, so
     n-gram drafts never come), with exact launches and at least one
     verify (partings reported, not gated: a verify routes 20 tokens
     together, a step 4).  Then the MoE-free clone (every layer
     ``ds_dense0``, the same widths and depth, the first four prompts,
     eager, one level) holds the MLA cache machinery strictly: paged
     streams (the same requests) equal dense ones, monolithic and
     speculative (every quantum a verify, rollbacks > 0) streams equal
     them or part at two-ulp ties, and the whole clone through the
     kernels is within LOGIT_RTOL of the plain versions.  Reported: a
     profiled 8-step quantum and 16-token chunk, the routed experts' time
     per step against their bounds, peak memory, the phase's seconds.
     Failed checks are collected and the phase fails at its end;
 13. the remaining token configs, after phase 12's engines are freed,
     one config's weights resident at a time, in the order arctic-480b (2
     of its 35 layers: d_model 7168, 56 heads over 8 of 128, a dense
     residual MLP of 4864 beside 128 experts of 4864, top-2, capacity
     factor 1.25), llama3-405b (4 of 126: d_model 16384, 128 heads over 8
     of 128, d_ff 53248, vocab 128256) and minicpm-2b (20 of 40: d_model
     2304, 36 heads over 36 of 64, d_ff 5760, vocab 122753, tied), widths
     published (LATE_LAYERS), seeded weights made on the card (arctic's
     expert stacks slice by slice).  Each: the six prompts x MAX_NEW
     tokens served eagerly and with graphs at LATE_LEVELS (K-buckets 1-8)
     with equal streams, exact launches (``dense_launches``: B1 3 and B2 1
     a layer per forward pass; B3, B4 none), one host sync a quantum,
     nothing captured after warmup; a graphed paged serve at one level
     (prefix sharing, phase 7's pool checks, ``paged_launches``); a
     profiled graphed 8-step quantum; the
     whole model through the kernels against the plain versions within
     LOGIT_RTOL (arctic: or a first router flip within ROUTER_TIE, phase
     12's rule).  arctic also: a speculative serve drafting the last
     token's copies (streams reported, not gated: a verify routes 20
     tokens together, a step 4) and the routed experts' time a step
     against both bounds.  llama3 also: a
     speculative serve on a paged engine (B3 verifies 80 rows: two row
     tiles), streams equal to the plain paged engine's or parting at
     two-ulp ties (phase 10's rule), verifies and rollbacks above 0
     (drafting the last token's copies where n-gram drafts never roll
     back).  Reported: peak memory per config, the phase's seconds.
     Failed checks are collected and the phase fails at its end;
 14. the frontends, after phase 13's engines are freed, one config's
     weights resident at a time: qwen2-vl-2b (all 28 layers: d_model
     1536, 12 heads over 2 of 128, G 6, swiglu MLP of 8960, vocab 151936
     tied, M-RoPE sections 16/24/24) and musicgen-large (all 48: d_model
     2048, 32 heads over 32 of 64, the plain gelu MLP of 8192 with
     biases, two B1 GEMMs a layer, layernorm, sinusoidal positions),
     published widths, seeded weights made on the card.  Each: the
     embedding path eagerly through the model's entry points
     (``make_sample_inputs`` patch or frame embeddings, FRONT_ROWS rows
     of FRONT_PROMPT; qwen2-vl-2b with M-RoPE positions t 0, h i // 16,
     w i): one prefill against 16-position ``prefill_chunk`` calls
     (within LOGIT_RTOL, same argmax), FRONT_STEPS decode steps (tokens
     on qwen2-vl-2b, frame embeddings on musicgen-large), the prefill and
     the first step through the plain versions within LOGIT_RTOL; the
     token path through ``ServingEngine``: the six prompts x MAX_NEW
     tokens served with graphs at LATE_LEVELS with exact launches
     (``late_launches``), one host sync a quantum and nothing captured
     after warmup; an eager engine (no warmup) against the graphed one on
     four one-chunk prompts and one 8-step quantum (streams and launches
     equal); a graphed paged serve at level 0 (prefix sharing, phase 7's
     pool checks); musicgen-large's speculative serve on that paged
     engine (phase 13's rule: streams equal or parting at two-ulp ties,
     verifies and rollbacks above 0, drafting the last token's copies
     where n-gram drafts never roll back, and tokens the model does not
     pick where those never do either); a profiled graphed 8-step
     quantum.  Reported: peak memory per config, the phase's seconds.
     Failed checks are collected and the phase fails at its end;
 15. training, after phase 14's engines are freed: first B1 at the
     training microbatch's shapes (M = 1024: each MLP GEMM forward, which
     is also the other GEMM's dX shape, and each dW, Xᵀ @ dY) and B2 over
     2 rows of 512 tokens, each against its plain version and timed
     beside ``torch.matmul`` / SDPA and the bound; then gemma-2b at its
     published widths and all 18 layers (2.506 B parameters, AdamW state
     made on the card: fp32 master, mu and nu), ``TorchTokenPipeline``
     zipf batches of TRAIN_BATCH x TRAIN_SEQ tokens in TRAIN_ACCUM
     microbatches, remat "full", the wsd schedule.  Fatal: one microbatch
     through the kernels and through the plain versions gives every leaf
     a gradient (none missing or all zero) within TRAIN_GRAD_RTOL
     relative L2, and the loss within TRAIN_LOSS_RTOL; TRAIN_STEPS
     steps, a profiled one, then one under remat "none" and one under
     "dots", each with
     exact launches (``train_launches``: B1 432 and B2 72 a step under
     "full", 324 and 36 under "none", 324 and 72 under "dots"; B3 and B4
     none); the loss of the last "full" step TRAIN_LOSS_DROP below the
     first's.  Reported: each step's loss, wall and peak memory; step ms,
     tokens/s and the model-FLOP share of 989 TFLOP/s; the profiled
     step's device time by kernel group (TRAIN_GROUPS) and idle share;
     the optimizer's own time an update.  Then mamba2-780m at its
     published widths and TRAIN_SSM_LAYERS of its 48 layers with the same
     recipe, through B4 under grad (``SsdScanGrad``: one launch forward,
     the plain scan's gradient recomputed backward): the grad check
     against the plain path at TRAIN_SSM_SEEDS weight seeds x
     TRAIN_ACCUM microbatches, each reading under the fixed
     TRAIN_SSM_GRAD_CEILING and the largest within
     TRAIN_SSM_CONTROL_FACTOR times the largest one-ulp control measured
     beside them (the plain path with the last bit of its scans' y
     flipped on the share of entries where B4's y and the plain scan's
     differ), TRAIN_SSM_STEPS steps with exact launches
     (``train_ssm_launches``: B4 2 a layer a microbatch under "full", the
     rest none), the plain backward's device time a step between CUDA
     events, peak memory.  Failed checks are collected and the phase
     fails at its end.  The ``kernels`` line carries ``train_launches``
     (both models' steps).
 16. ``launch/serve``, after phase 15's state is freed: the port's serving
     entry point, called in process as a user runs ``python -m
     repro_torch.launch.serve --arch gemma-2b`` (the card by default),
     serves gemma-2b at its published widths and all 18 layers (random
     weights from a generator seeded 0, ≈5 GB of bf16) from a cold
     engine: SERVE_REQUESTS requests of SERVE_PROMPT tokens (the
     reference's prompt recipe), SERVE_MAX_NEW new tokens each over
     SERVE_SLOTS slots.  Fatal: every request finishes with its prompt's
     first token plus SERVE_MAX_NEW more (the reference engine's count),
     every token inside the vocabulary; B1 and B2 launched during the
     phase, B3 and B4 not.  Reported: the entry point's ``[serve]`` line,
     the launches, the phase's seconds.  The ``kernels`` line carries
     ``serve_launches``.
 17. the mesh layer, after phase 16's engine is freed.  (b):
     ``python -m repro_torch.launch.dryrun`` traces gemma-2b's
     ``decode_32k`` and ``train_4k`` cells over a fake world of 256 ranks
     (16 x 16), each in a subprocess of its own (a fake process group is
     one per process), on the host: they start before phase 1's build
     and trace beside phases 1, 2 and 8 (phase 8 runs right after phase
     2), none of which reads a host time, and are collected before
     phase 3, so no phase whose host time is reported runs beside them
     (the train cell's trace takes 60-100 s of host time).  (a): an
     NCCL group
     of one rank (``tcp://localhost``, a free port) and
     ``make_debug_mesh()``, a 1 x 1 mesh on the card; phase 16's weights
     made again (generator seeded 0) and saved with the port's
     ``Checkpointer`` to a temporary directory under ``build/`` (removed
     at the phase's end, also on failure); ``reshard_plan`` of gemma-2b's
     AdamW train state from 16 x 16 to 2 x 16 x 16, printed;
     ``elastic_restore`` onto the 1 x 1 mesh under the serve rules.
     Fatal: every restored leaf a DTensor whose local tensor lies on the
     card and equals the saved leaf bit for bit; phase 16's recipe served
     from the restored weights gives phase 16's tokens with its launches
     (B1 1,296 and B2 432, B3 and B4 none).  (b) fatal: the decode cell
     ``ok`` on 256 devices with FLOPs, its arguments' bytes a device
     equal to ``device_bytes`` over the port's trees; the train cell's
     status, FLOPs, bytes a device against the card's 80 GB, collectives
     and seconds are reported.  Reported: the save's and the restore's
     GB/s, the phase's seconds.  The group is destroyed at (a)'s end.
     Both cells must be ``ok`` (the train cell too, since the
     tied embedding's two gradients meet placed alike:
     ``dist.placement.grad_in_place_of``).  The ``kernels`` line carries
     ``elastic_launches``.
 18. the examples (``repro_torch.examples``), after phase 17 (a): (a)
     ``quickstart``'s plain and speculative passes at gemma-2b's
     published widths and all 18 layers (the example's recipe: 8
     requests of 16 tokens, 12 new, 4 slots, ``max_len`` 48, fused quanta
     at the largest bucket), then ``quickstart.main()`` as shipped
     (reduced, on the card); (b) ``train_lm.main`` as shipped (reduced
     minicpm-2b, 20 steps: B1 and B2 under grad) and on mamba2-780m (10
     steps: B4 under grad); (c) ``multi_tenant_serving``'s card parts:
     ``online_engine_demo``, ``colocation_demo`` (planned on the card's
     spec) and ``speculative_demo``.  Each part's launch counters are
     zeroed just before it and read just after; what it prints is
     reported as ``examples <part> | ...``.  Fatal: a part that raises
     (a demo's own assertion), a speculative stream that differs from
     the plain one, a token outside the vocabulary, B1 or B2 not launched
     by the quickstart, a train_lm loss that does not fall or B4 not
     launched by the mamba2 run, an engine or train state off the card.
     Reported: the quickstart's tokens/s and ``spec_stats`` (its
     speculative rate only where a draft landed: at full width the
     recipe's random prompts repeat no n-gram, and the speculative pass
     is then a plain serve on a speculative engine), launches and seconds
     per part.  The ``kernels`` line carries ``example_launches``.

The line before the last is the ``{"kernels": [...]}`` record; the last
line is ``{"ok": true, "device": {...}}``.  Details land in
``chiprun_out/chip_smoke.json``.  Imports nothing of JAX or of the JAX
package.
"""
from __future__ import annotations

import argparse
import atexit
import collections
import dataclasses
import gc
import itertools
import json
import math
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
# the single-engine paths' depth cuts, widths unchanged, to keep the
# script well inside its time limit (each warmup captures 121 graphs of
# every layer; the host-bound phases ran up to 2.5x slower on one host
# than on another): phases 3-7 and 10 serve gemma-2b at 9 of its 18
# layers, phase 6 mamba2-780m at 6 of its 48, phase 11 recurrentgemma-2b
# at 8 of its 26 ((rec, rec, attn) x 2 + (rec, rec): the plan's groups
# and its epilogue), phase 12 deepseek-v2-lite-16b at 5 of its 27 (pro_0
# + 4 moe_ds); phase 9 serves gemma-2b and mamba2-780m at full depth
EARLY_LAYERS = {"gemma-2b": 9, "mamba2-780m": 6, "recurrentgemma-2b": 8,
                "deepseek-v2-lite-16b": 5}
# deepseek-v2-lite-16b's B1 GEMMs (K, N): layer 0's dense MLP, then the
# shared experts' MLP of every moe_ds layer
MOE_GEMMS = ((2048, 10944), (10944, 2048), (2048, 2816), (2816, 2048))
# phase 13's token configs, in the order they serve (one config's weights
# resident at a time), at their published widths: arctic-480b at 2 of its
# 35 layers (the most whose weights fit: 55.4 GB), llama3-405b at 4 of
# 126 (33.9 GB), minicpm-2b at 20 of 40 (for the script's time, as
# EARLY_LAYERS)
LATE_LAYERS = {"arctic-480b": 2, "llama3-405b": 4, "minicpm-2b": 20}
# their B1 GEMMs (K, N): arctic's dense residual, llama3's and minicpm's
# MLP, each gate/up then down
LATE_GEMMS = {"arctic-480b": ((7168, 4864), (4864, 7168)),
              "llama3-405b": ((16384, 53248), (53248, 16384)),
              "minicpm-2b": ((2304, 5760), (5760, 2304))}
# their attention (query heads, KV heads, head_dim): KV groups of 7, 16
# and 1
LATE_HEADS = {"arctic-480b": (56, 8, 128), "llama3-405b": (128, 8, 128),
              "minicpm-2b": (36, 36, 64)}
# phase 14's frontend configs, in the order they serve, at their published
# widths and full depth: qwen2-vl-2b (28 layers, 3.09 GB) and
# musicgen-large (48 layers, 4.85 GB)
FRONT_ARCHS = ("qwen2-vl-2b", "musicgen-large")
# their B1 GEMMs (K, N): qwen2-vl-2b's gated MLP (K 8960: 140 tiles of 64,
# uneven across a cluster of 8), musicgen-large's plain gelu MLP (two
# GEMMs a layer, the biases added outside the kernel)
FRONT_GEMMS = {"qwen2-vl-2b": ((1536, 8960), (8960, 1536)),
               "musicgen-large": ((2048, 8192), (8192, 2048))}
# their attention (query heads, KV heads, head_dim): a KV group of 6 (a
# 16-token chunk is 96 rows: a 64-row tile splits position 10's heads)
# and MHA at D 64
FRONT_HEADS = {"qwen2-vl-2b": (12, 2, 128), "musicgen-large": (32, 32, 64)}
# the shapes phases 2 and 8 hold and time for phases 13 and 14
CONFIG_GEMMS = {**LATE_GEMMS, **FRONT_GEMMS}
CONFIG_HEADS = {**LATE_HEADS, **FRONT_HEADS}


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
    # the serves' GEMMs at M = 1, 4 and 16 (gemma-2b's MLP, then
    # starcoder2-3b's); gemma-2b's MLP at M = 20, a speculative verify's
    # 4 rows x (d + 1) tokens (a partial 16-row tile); K = 16576 = 259
    # tiles of 64, which a cluster of 8 cannot split evenly; ragged shapes
    shapes = [(m, k, n) for m in (1, 4, 16)
              for k, n in ((2048, 16384), (16384, 2048), (3072, 12288),
                           (12288, 3072))]
    shapes += [(BATCH_SLOTS * (SPEC_DEPTH + 1), k, n)
               for k, n in ((2048, 16384), (16384, 2048))]
    # recurrentgemma-2b's MLP (2560 -> 7680 -> 2560: 40 and 120 tiles of
    # 64, uneven split-K ranges) at a decode step's M = 4, a chunk's 16
    # and a verify's 20
    shapes += [(m, k, n) for m in (BATCH_SLOTS, 16,
                                   BATCH_SLOTS * (SPEC_DEPTH + 1))
               for k, n in ((2560, 7680), (7680, 2560))]
    # deepseek-v2-lite-16b: layer 0's dense MLP (2048 -> 10944: 85.5 N
    # tiles of 128, the last one ragged; 10944 -> 2048: 171 K tiles of 64,
    # uneven split-K ranges) and the shared experts' (2048 <-> 2816 = 22
    # tiles of 128) at a step's, a chunk's and a verify's M
    shapes += [(m, k, n) for m in (BATCH_SLOTS, 16,
                                   BATCH_SLOTS * (SPEC_DEPTH + 1))
               for k, n in MOE_GEMMS]
    # phase 13's GEMMs (arctic's dense residual 7168 <-> 4864: 112 and 76
    # K tiles; llama3's 16384 <-> 53248: 416 N tiles of 128, 832 K tiles
    # of 64, 1.745 GB a weight; minicpm's 2304 <-> 5760: 36 and 90 K
    # tiles, uneven across a cluster of 8) and phase 14's (qwen2-vl-2b's
    # 1536 <-> 8960, musicgen-large's 2048 <-> 8192) at a step's, a
    # chunk's and a verify's M
    shapes += [(m, k, n) for m in (BATCH_SLOTS, 16,
                                   BATCH_SLOTS * (SPEC_DEPTH + 1))
               for gemms in CONFIG_GEMMS.values() for k, n in gemms]
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
    # (label, B, S, H, KH, D, offsets, kv_valid): gemma-2b's 8 query heads
    # at D 256, MQA and GQA (K = 2), decode rows at positions 0 and 511;
    # starcoder2-3b's 24 query heads over 2 KV heads at D 128 (12:1)
    cases = [
        ("prefill chunk", 1, 16, 8, 1, 256, [32], [48]),
        ("prefill chunk at 240", 1, 16, 8, 1, 256, [240], [256]),
        ("decode", 4, 1, 8, 1, 256, [5, 100, 300, 511], [6, 101, 301, 512]),
        ("decode at 0 and 511", 2, 1, 8, 1, 256, [0, 511], [1, 512]),
        ("GQA K=2 decode", 4, 1, 8, 2, 256, [0, 100, 300, 511],
         [1, 101, 301, 512]),
        ("GQA K=2 prefill chunk", 2, 16, 8, 2, 256, [0, 240], [16, 256]),
        ("starcoder2-3b decode", 4, 1, 24, 2, 128, [5, 100, 300, 511],
         [6, 101, 301, 512]),
        ("starcoder2-3b prefill chunk", 1, 16, 24, 2, 128, [32], [48]),
        ("starcoder2-3b prefill chunk at 240", 1, 16, 24, 2, 128, [240],
         [256]),
        # a speculative verify pass: d + 1 = 5 queries per row at the
        # serve's positions
        ("verify", 4, 5, 8, 1, 256, [68, 140, 260, 300],
         [73, 145, 265, 305]),
    ]
    plain_only = len(cases)
    # phase 13's groups (arctic G 7 at D 128: a 64-row tile splits a
    # query position's heads; llama3 G 16: a chunk is 256 rows, 4 tiles;
    # minicpm G 1 at D 64 over 36 KV heads: one row a decode block) and
    # phase 14's (qwen2-vl-2b G 6 at D 128: a chunk's 96 rows make two
    # 64-row tiles, position 10 split across them; musicgen-large G 1 at
    # D 64 over 32 KV heads): decode at positions 0 and 511, 16-token
    # chunks and a verify
    for arch, (h, kh, d) in CONFIG_HEADS.items():
        cases += [
            (f"{arch} decode", 4, 1, h, kh, d, [0, 100, 300, 511],
             [1, 101, 301, 512]),
            (f"{arch} prefill chunk", 1, 16, h, kh, d, [32], [48]),
            (f"{arch} prefill chunk at 240", 1, 16, h, kh, d, [240], [256]),
            (f"{arch} verify", 4, 5, h, kh, d, [68, 140, 260, 300],
             [73, 145, 265, 305])]
    for i, (name, b, s, h, kh, d, offs, kvls) in enumerate(cases):
        q = torch.randn(b, s, h, d, generator=gen, device=dev).bfloat16()
        kk = torch.randn(b, MAX_LEN, kh, d, generator=gen,
                         device=dev).bfloat16()
        v = torch.randn(b, MAX_LEN, kh, d, generator=gen,
                        device=dev).bfloat16()
        off = torch.tensor(offs, device=dev)
        kvl = torch.tensor(kvls, device=dev)
        # phases 13 and 14's configs have no window and no softcap
        for window, softcap in ((None, None), (64, 50.0))[
                :2 if i < plain_only else 1]:
            want = attention_ref(q, kk, v, offset=off, kv_valid_len=kvl,
                                 window=window, softcap=softcap)
            case_abs = case_rel = 0.0
            used, q_tiles = set(), set()
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
                (tbq, _), split, blocks = fa.launch_geometry(
                    b, s, h, kh, MAX_LEN, **tiles)
                q_tiles.add(-(-s * (h // kh) // tbq))
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
            report(f"flash_attention {name} B={b} S={s} H={h} KV={kh} D={d} "
                   f"window={window} softcap={softcap}: {len(att_tiles)} "
                   f"tiles ok, bitwise equal across two launches, max abs "
                   f"err {case_abs:.4g}, max rel err {case_rel:.4g} ({tol}); "
                   f"(split, blocks) {sorted(used)}, row tiles "
                   f"{sorted(q_tiles)}")
    # recurrentgemma-2b's heads (10 over one KV head at D 256: 10
    # flattened rows a query) under its 2048-token window: a monolithic
    # prefill longer than the window (the window binds), and 16-token
    # chunks at the serve's offsets.  (label, B, S, T, offsets, window)
    for name, b, s, t, offs, window in (
            ("recurrentgemma-2b prefill past the window", 1, RING_PROMPT,
             RING_PROMPT, [0], HYBRID_WINDOW),
            ("recurrentgemma-2b 16-token chunks", BATCH_SLOTS, 16, MAX_LEN,
             [68, 140, 260, 300], HYBRID_WINDOW)):
        q = torch.randn(b, s, 10, 256, generator=gen, device=dev).bfloat16()
        kk = torch.randn(b, t, 1, 256, generator=gen, device=dev).bfloat16()
        v = torch.randn(b, t, 1, 256, generator=gen, device=dev).bfloat16()
        off = torch.tensor(offs, device=dev)
        kvl = off + s
        want = attention_ref(q, kk, v, offset=off, kv_valid_len=kvl,
                             window=window)
        case_abs = case_rel = 0.0
        used = set()
        for tiles in att_tiles:
            kw = dict(offset=off, kv_valid_len=kvl, window=window, **tiles)
            got = fa.flash_attention(q, kk, v, **kw)
            again = fa.flash_attention(q, kk, v, **kw)
            if b2_ref is not None:
                n_ref += 1
                require(torch.equal(got, with_b2(
                    b2_ref, lambda: fa.flash_attention(q, kk, v, **kw))),
                    f"flash_attention {name} tiles {tiles}: differs from "
                    "the reference build")
            torch.cuda.synchronize()
            _, split, blocks = fa.launch_geometry(b, s, 10, 1, t, **tiles)
            used.add((split, blocks))
            splits["flash_attention"][split] += 1
            ea, er, ok = errors(got, want)
            case_abs, case_rel = max(case_abs, ea), max(case_rel, er)
            n_checks += 1
            require(ok, f"flash_attention {name} window={window} tiles "
                    f"{tiles} split {split}: max abs err {ea:.4g}, max rel "
                    f"err {er:.4g} beyond {tol}")
            require(torch.equal(got, again), f"flash_attention {name} "
                    f"tiles {tiles} split {split}: two launches differ")
        worst["flash_attention"] = max(worst["flash_attention"], case_abs)
        report(f"flash_attention {name} B={b} S={s} H=10 KV=1 D=256 T={t} "
               f"window={window}: {len(att_tiles)} tiles ok, bitwise equal "
               f"across two launches, max abs err {case_abs:.4g}, max rel "
               f"err {case_rel:.4g} ({tol}); (split, blocks) "
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


def paged_inputs(gen, dev, b, h, kh, d, ps, kvl, garbage=1e3, s=1):
    """bf16 q (B,S,H,D), K/V pools of B * MAX_LEN / ps pages plus the trash
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
        mapped = min(-(-int(kvl[i]) // ps), n_slot)
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
    q = torch.randn(b, s, h, d, generator=gen, device=dev).bfloat16()
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
    cases = [c + (1,) for c in cases]
    # a speculative verify pass: d + 1 = 5 queries per row, at the serve's
    # positions (the last query at kv_valid - 1), and rows whose queries
    # run past a full slot (kv_valid beyond it, as a frozen row's may)
    kvls["verify"] = [73, 145, 265, 305]
    kvls["verify past the slot"] = [73, MAX_LEN + 3, 265, MAX_LEN + 4]
    cases += [(8, 1, 256, ps, 4, name, None, None, 5) for ps in (8, 16)
              for name in ("verify", "verify past the slot")]
    # phase 13's groups (7, 16 and 1) and phase 14's (6 and 1) on pages of
    # 16: decode steps over ragged rows and verifies (llama3's 5 x 16 = 80
    # rows: two row tiles; qwen2-vl-2b's 30)
    cases += [(h, kh, d, PAGE_SIZE, 4, name, None, None, sq)
              for h, kh, d in CONFIG_HEADS.values()
              for name, sq in (("ragged", 1), ("verify", 5),
                               ("verify past the slot", 5))]
    worst = worst_dense = 0.0
    splits = collections.Counter()
    for h, kh, d, ps, b, name, window, softcap, sq in cases:
        kvl = torch.tensor(kvls[name][:b], dtype=torch.int32, device=dev)
        q, kp, vp, table = paged_inputs(gen, dev, b, h, kh, d, ps, kvl,
                                        s=sq)
        off = kvl - sq
        kw = dict(offset=off, kv_valid_len=kvl, window=window,
                  softcap=softcap)
        got = fap.flash_attention_paged(q, kp, vp, table, **kw)
        again = fap.flash_attention_paged(q, kp, vp, table, **kw)
        torch.cuda.synchronize()
        split, blocks = fap.launch_geometry(b, sq, h, kh, ps,
                                           table.shape[1])
        splits[split] += 1
        want = paged_attention_ref(q, kp, vp, table, **kw)
        ea, er, ok = errors(got, want)
        rows = sq * (h // kh)
        label = (f"flash_attention_paged H={h} K={kh} D={d} page {ps} B={b} "
                 f"S={sq} {name} window={window} softcap={softcap} split "
                 f"{split} row tiles {-(-rows // min(rows, fap.MAX_ROWS))}")
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
    layout, as the model passes them) and per head (G = H).  The verify
    case runs a speculative verify's scan: 4 rows of d + 1 tokens from a
    carried state, dt zeroed past per-row budgets 0, 1, 3 and d + 1 (the
    restore pass's ``valid_len = n_emit``); its row at budget 0 must keep
    its state bit for bit.  The wrapper's shared-memory count is held to
    the kernel's.  Returns the worst |y| error."""
    import torch
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels.ref import ssd_ref

    # (label, B, L, H, G, P, N, chunk, initial state[, per-row budgets])
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
    cases += [(f"verify L={SPEC_DEPTH + 1}", BATCH_SLOTS, SPEC_DEPTH + 1, 48,
               1, 64, 128, 256, True, (0, 1, 3, SPEC_DEPTH + 1))]
    worst = 0.0
    tol = f"y {ATOL:.4g} + {RTOL:.4g}*|plain|, state {STATE_RTOL:.4g}*max"
    for label, bsz, l, h, g, p, n, chunk, init, *budgets in cases:
        x, dt, a, b, c, h0 = ssd_inputs(gen, dev, bsz, l, h, p, n, init, g)
        if budgets:
            real = (torch.arange(l, device=dev)[None, :] <
                    torch.tensor(budgets[0], device=dev)[:, None])
            dt = torch.where(real[..., None], dt, 0.0)
            label = f"{label} budgets {list(budgets[0])}"
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
        if budgets:
            frozen = [i for i, k in enumerate(budgets[0]) if k == 0]
            require(all(torch.equal(state[i], h0[i]) for i in frozen),
                    f"{what}: a row at budget 0 changed its state")
            what += f"; rows {frozen} at budget 0 keep their state bit for bit"
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
          engine_kw=None, after=None, warmup_kw=None,
          levels=(0, 5, 9)) -> dict:
    """Serve ``prompts`` x MAX_NEW tokens after ``warmup()``.  ``counters``
    maps each kernel of the path to its launch counter, zeroed just before
    the serve and read just after; ``expected(decode_steps, chunks)``
    gives each kernel's launch count for the decode steps and prefill
    chunk sizes run, and a line that says why (a kernel expected to run
    must run; one expected at 0 must not).  ``engine_kw`` goes to the
    engine (the paged cache's options, ``chunked_prefill``), ``warmup_kw``
    to its ``warmup()`` (default: the full level grid); ``after`` maps a
    request's index to the index of one that must be resident, its prompt
    prefilled, before it is admitted (admission stays FIFO: a held
    request holds the ones behind it).  The level cycles over the grid
    points ``levels``, one a quantum."""
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
    stats = engine.warmup(**(warmup_kw or {}))
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
    levels = [cm.grid_point(i) for i in levels]
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
            # a monolithic admission prefills and syncs in the call
            finishing_prefills += not engine.chunked_prefill
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
    require(engine.level_switches - switches0 >= min(3, len(levels) - 1),
            f"{engine.level_switches - switches0} level switches")
    want, why = expected(decode_steps, chunks)
    for name, per_tile in launches.items():
        n = sum(per_tile.values())
        require(n > 0 or want[name] == 0, f"{name} never launched")
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


def mlp_gemms(cfg) -> int:
    """B1 launches of one layer's MLP: gate, up and down for a gated
    activation, up and down for the plain gelu MLP (musicgen-large)."""
    return 3 if cfg.activation in ("swiglu", "geglu") else 2


def dense_launches(cfg):
    """Every forward pass (a decode step or a prefill chunk) runs each
    layer's MLP GEMMs (``mlp_gemms``) and its attention through the
    kernels."""
    def expected(decode_steps, chunks):
        passes = decode_steps + len(chunks)
        per = {"block_matmul": mlp_gemms(cfg) * cfg.num_layers,
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
    the MLP GEMMs of each layer (``mlp_gemms``)."""
    def expected(decode_steps, chunks):
        n, passes = cfg.num_layers, decode_steps + len(chunks)
        g = mlp_gemms(cfg)
        return ({"block_matmul": g * n * passes,
                 "flash_attention": n * len(chunks),
                 "flash_attention_paged": n * decode_steps},
                {"block_matmul": f"{g * n} per forward pass x {passes} "
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
    spans = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.name] += e.time_range.elapsed_us()
            n_device_ops += 1
            spans.append((e.time_range.start, e.time_range.end))
    by_group: dict[str, float] = collections.Counter()
    for name, us in by_kernel.items():
        by_group[next((g for g, sub in groups.items() if sub in name),
                      "other")] += us
    others = sorted(((us, n) for n, us in by_kernel.items()
                     if not any(sub in n for sub in groups.values())),
                    reverse=True)
    merged = merge_intervals(spans)
    gaps = [b[0] - a[1] for a, b in zip(merged, merged[1:])]
    return {"wall_us": wall_us, "busy_us": sum(by_kernel.values()),
            "n_device_ops": n_device_ops, "by_group": by_group,
            "others": others,
            "node_gap_us_mean": (sum(gaps) / len(gaps) if gaps else None),
            "node_gap_us_median": (statistics.median(gaps) if gaps
                                   else None)}


def merge_intervals(spans: list) -> list:
    """The union of (start, end) intervals, as disjoint sorted ones."""
    out: list = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


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
           "node_gap_us_mean": prof["node_gap_us_mean"],
           "node_gap_us_median": prof["node_gap_us_median"],
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
           f"{out['device_ops_per_step']:.0f} device ops per step, gap "
           f"between consecutive device ops {out['node_gap_us_mean']:.3f} "
           f"us mean, {out['node_gap_us_median']:.3f} us median; device ms "
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
    # the cost of a level switch between two captured versions (a
    # dictionary swap of graphs), alternating the extreme levels
    lo, hi = cm.grid_point(0), cm.grid_point(cm.NUM_LEVELS - 1)
    require(engine.tiles_for_level(lo) != engine.tiles_for_level(hi),
            "level sweep: the extreme levels share a version")
    t0 = time.perf_counter()
    for i in range(SWITCHES):
        engine.set_interference_level(hi if i % 2 == 0 else lo)
    switch_us = (time.perf_counter() - t0) * 1e6 / SWITCHES
    require(vc.traces == traces0, "level switches built a call")
    report(f"{engine.cfg.name}{' paged' if engine.paged else ''} level "
           f"sweep over {cm.NUM_LEVELS} levels after warmup: 0 captures, "
           f"{replays} graph replays; a level switch between captured "
           f"versions takes {switch_us:.2f} us (mean of {SWITCHES})")
    return {"levels": cm.NUM_LEVELS, "captures": 0, "replays": replays,
            "switch_us": switch_us}


# level switches timed after a sweep
SWITCHES = 200


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


def engine_pairs(engines: dict, prompts, report, groups, *,
                 chunk: bool) -> dict:
    """Alternating runs of two engines of one model in one call (``engines``
    maps a label, e.g. "eager" and "graphs", to an engine), PAIRS of
    each: an 8-step decode quantum of four rows at level 0 (and, with
    ``chunk``, a 16-token prefill chunk that ends in the admission's
    first-token sync).  Each run is timed alone (the wall) and again
    under torch.profiler (device busy); the idle share is 1 - busy /
    wall.  Pair i runs the first engine first when i is even, the second
    first when odd."""
    from repro_torch.core import cost_model as cm
    from repro_torch.serving.engine import Request

    first = next(iter(engines.values()))
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
            report(f"pairs {first.cfg.name}{' paged' if first.paged else ''}"
                   f" {kind} {name} ({PAIRS} runs, median [min, max]): "
                   + "; ".join(f"{k} {v['median']:.4g} [{v['min']:.4g}, "
                               f"{v['max']:.4g}]" for k, v in sm.items()))
    for eng in engines.values():
        for slot, req in enumerate(eng.slot_req):
            if req is not None and req.rid >= 700:
                eng.release_slot(slot)
    return out


def stream_pairs(engine, cfg, params, prompts, dev, report, groups) -> dict:
    """The graphed engine on its own stream (every engine's default)
    against one built on the caller's current stream, alternating in one
    call: what running on a stream of its own costs a chunk and a
    quantum."""
    import torch
    from repro_torch.core import cost_model as cm
    from repro_torch.serving.engine import ServingEngine

    cur = ServingEngine(cfg, params, batch_slots=BATCH_SLOTS,
                        max_len=MAX_LEN, device=dev,
                        stream=torch.cuda.current_stream(dev))
    require(cur.stream == torch.cuda.current_stream(dev)
            and engine.stream != cur.stream,
            "stream pairs: the engines' streams are not the ones asked for")
    cur.warmup(levels=[cm.grid_point(0)])
    out = engine_pairs({"own stream": engine, "current stream": cur},
                       prompts, report, groups, chunk=True)
    del cur
    gc.collect()
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
    verify_m = BATCH_SLOTS * (SPEC_DEPTH + 1)
    for label, (m, k, n) in (("decode gate/up", (4, 2048, 16384)),
                             ("decode down", (4, 16384, 2048)),
                             ("prefill-chunk gate/up", (16, 2048, 16384)),
                             ("prefill-chunk down", (16, 16384, 2048)),
                             ("recurrentgemma-2b decode gate/up",
                              (4, 2560, 7680)),
                             ("recurrentgemma-2b decode down",
                              (4, 7680, 2560)),
                             ("recurrentgemma-2b prefill-chunk gate/up",
                              (16, 2560, 7680)),
                             ("recurrentgemma-2b prefill-chunk down",
                              (16, 7680, 2560)),
                             ("recurrentgemma-2b verify gate/up",
                              (verify_m, 2560, 7680)),
                             ("recurrentgemma-2b verify down",
                              (verify_m, 7680, 2560)),
                             *((f"deepseek-v2-lite-16b {what} {gemm}",
                                (m, k, n))
                               for what, m in (("decode", BATCH_SLOTS),
                                               ("prefill-chunk", 16),
                                               ("verify", verify_m))
                               for gemm, (k, n) in zip(
                                   ("dense gate/up", "dense down",
                                    "shared gate/up", "shared down"),
                                   MOE_GEMMS)),
                             *((f"{arch} {what} {gemm}", (m, k, n))
                               for arch, gemms in CONFIG_GEMMS.items()
                               for what, m in (("decode", BATCH_SLOTS),
                                               ("prefill-chunk", 16),
                                               ("verify", verify_m))
                               for gemm, (k, n) in zip(
                                   ("up" if arch == "musicgen-large"
                                    else "gate/up", "down"), gemms))):
        x = torch.randn(m, k, generator=gen, device=dev).bfloat16()
        w = (torch.randn(k, n, generator=gen, device=dev)
             * k ** -0.5).bfloat16()
        # phases 13 and 14's shapes at the level-0 tile only, for the
        # script's time (each timing holds the stream for ~0.1 s first)
        late = label.split()[0] in CONFIG_GEMMS
        levels = H100_LEVEL_TILES[:1] if late else H100_LEVEL_TILES
        per_level = [cold_ms(lambda t=t: bm.block_matmul_2d(
            x, w, **t["matmul"]), 20, flush) for t in levels]
        geometry = [bm.launch_geometry(m, k, n, **t["matmul"])[1:]
                    for t in levels]
        nbytes = (m * k + k * n + m * n) * 2
        flops = 2 * m * k * n
        row = {"name": "block_matmul", "shape": label, "m": m, "k": k,
               "n": n, "ms": per_level[0], "ms_per_level": per_level,
               "split": geometry[0][0], "blocks": geometry[0][1],
               "split_blocks_per_level": geometry,
               "plain_ms": cold_ms(lambda: matmul_ref(x, w), 20, flush),
               "library_ms": cold_ms(lambda: torch.matmul(x, w), 20, flush),
               "ms_l2_clean": None if late else cold_ms(
                   lambda: bm.block_matmul_2d(x, w, **level0["matmul"]), 20,
                   read_flush),
               "library_ms_l2_clean": None if late else cold_ms(
                   lambda: torch.matmul(x, w), 20, read_flush),
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
               f"({row['bound_by']})" + ("" if late else
                                         f"; after a read-only L2 flush "
                                         f"kernel {row['ms_l2_clean']:.4f}, "
                                         f"torch.matmul "
                                         f"{row['library_ms_l2_clean']:.4f} "
                                         "ms; per level ms "
                                         + ", ".join(f"{v:.4f}"
                                                     for v in per_level)
                                         + "; per level (split, blocks) "
                                         + ", ".join(f"{g}"
                                                     for g in geometry)))
    # flash_attention: decode over the serve's positions, a prefill chunk
    # and a speculative verify pass (d + 1 = 5 queries per row), at
    # gemma-2b's heads (8 over 1 at D 256), at phase 13's (KV groups of
    # 7, 16 and 1) and at phase 14's (6 and 1); the bound counts the keys
    # this data makes visible.
    # SDPA reads K/V expanded to every query head (a view for one KV
    # head, a copy made before the timing for more)
    shapes = [(label, b, s, offs, 8, 1, 256, "")
              for label, b, s, offs in (("decode", 4, 1, [68, 140, 260, 300]),
                                        ("prefill chunk", 1, 16, [240]),
                                        ("verify", 4, 5, [68, 140, 260, 300]))]
    shapes += [(f"{arch} {label}", b, s, offs, h, kh, d, arch)
               for arch, (h, kh, d) in CONFIG_HEADS.items()
               for label, b, s, offs in (
                   ("decode", 4, 1, [68, 140, 260, 300]),
                   ("prefill chunk", 1, 16, [240]),
                   ("verify", 4, 5, [68, 140, 260, 300]))]
    for label, b, s, offs, h, kh, d, arch in shapes:
        t = MAX_LEN
        q = torch.randn(b, s, h, d, generator=gen, device=dev).bfloat16()
        kk = torch.randn(b, t, kh, d, generator=gen, device=dev).bfloat16()
        v = torch.randn(b, t, kh, d, generator=gen, device=dev).bfloat16()
        off = torch.tensor(offs, device=dev)
        kvl = off + s
        # phases 13 and 14's heads at the level-0 tile only, as for B1
        levels = H100_LEVEL_TILES[:1] if arch else H100_LEVEL_TILES
        per_level = [cold_ms(lambda a=tl["attention"]: fa.flash_attention(
            q, kk, v, offset=off, kv_valid_len=kvl, **a), 20, flush)
            for tl in levels]
        geometry = [fa.launch_geometry(b, s, h, kh, t,
                                       **tl["attention"])[1:]
                    for tl in levels]
        qpos = off[:, None] + torch.arange(s, device=dev)
        mask = (torch.arange(t, device=dev)[None, None, :]
                <= qpos[:, :, None])[:, None]            # (B,1,S,T)
        qt = q.transpose(1, 2)
        kt, vt = (a.transpose(1, 2).expand(b, h, t, d) if kh == 1 else
                  a.transpose(1, 2).repeat_interleave(h // kh, dim=1)
                  for a in (kk, v))

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        keys = sum(o + s for o in offs)       # visible keys, per KV head
        nbytes = (2 * b * s * h * d + 2 * keys * kh * d) * 2 + 2 * b * 4
        flops = 4 * h * d * sum(
            sum(o + i + 1 for i in range(s)) for o in offs)
        row = {"name": "flash_attention", "shape": label, "arch": arch,
               "b": b, "s": s, "t": t, "h": h, "kh": kh, "d": d,
               "offsets": offs, "ms": per_level[0],
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
        report(f"time flash_attention {label} B={b} S={s} H={h} KV={kh} "
               f"D={d} T={t} offsets={offs}: kernel {row['ms']:.4f} ms "
               f"(level 0 tiles "
               f"{level0['attention']}, split {row['split']}, "
               f"{row['blocks']} blocks), plain {row['plain_ms']:.4f} ms, "
               f"sdpa {row['library_ms']:.4f} ms, bound "
               f"{row['bound_ms']:.5f} ms ({row['bound_by']}); per level ms "
               + ", ".join(f"{v:.4f}" for v in per_level)
               + "; per level (split, blocks) "
               + ", ".join(f"{g}" for g in geometry))
    # flash_attention at recurrentgemma-2b's heads (10 over 1, D 256) and
    # window (2048): its monolithic prefill past the window, and 16-token
    # chunks at the serve's offsets; the bound counts the keys the window
    # leaves visible
    for label, b, s, t, offs in (
            ("recurrentgemma-2b prefill past the window", 1, RING_PROMPT,
             RING_PROMPT, [0]),
            ("recurrentgemma-2b prefill chunk", BATCH_SLOTS, 16, MAX_LEN,
             [68, 140, 260, 300])):
        h, d, window = 10, 256, HYBRID_WINDOW
        q = torch.randn(b, s, h, d, generator=gen, device=dev).bfloat16()
        kk = torch.randn(b, t, 1, d, generator=gen, device=dev).bfloat16()
        v = torch.randn(b, t, 1, d, generator=gen, device=dev).bfloat16()
        off = torch.tensor(offs, device=dev)
        kvl = off + s
        per_level = [cold_ms(lambda a=tl["attention"]: fa.flash_attention(
            q, kk, v, offset=off, kv_valid_len=kvl, window=window, **a), 20,
            flush) for tl in H100_LEVEL_TILES]
        geometry = [fa.launch_geometry(b, s, h, 1, t, **tl["attention"])[1:]
                    for tl in H100_LEVEL_TILES]
        qpos = off[:, None] + torch.arange(s, device=dev)
        j = torch.arange(t, device=dev)[None, None, :]
        mask = ((j <= qpos[:, :, None])
                & (j > qpos[:, :, None] - window))[:, None]   # (B,1,S,T)
        qt = q.transpose(1, 2)
        kt, vt = (a.transpose(1, 2).expand(b, h, t, d) for a in (kk, v))

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        # keys read: each row's span [max(0, first query + 1 - window),
        # last query]; operations: each query's visible keys
        keys = sum(o + s - max(0, o + 1 - window) for o in offs)
        visible = sum(min(o + i + 1, window) for o in offs for i in range(s))
        nbytes = (2 * b * s * h * d + 2 * keys * d) * 2 + 2 * b * 4
        flops = 4 * h * d * visible
        row = {"name": "flash_attention", "shape": label, "b": b, "s": s,
               "t": t, "h": h, "window": window, "offsets": offs,
               "ms": per_level[0], "ms_per_level": per_level,
               "split": geometry[0][0], "blocks": geometry[0][1],
               "split_blocks_per_level": geometry,
               "plain_ms": cold_ms(lambda: attention_ref(
                   q, kk, v, offset=off, kv_valid_len=kvl, window=window),
                   20, flush),
               "library_ms": cold_ms(library, 20, flush),
               "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                               flops / BF16_FLOPS) * 1e3,
               "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                            >= flops / BF16_FLOPS else "operations")}
        rows.append(row)
        report(f"time flash_attention {label} B={b} S={s} H={h} KV=1 T={t} "
               f"window={window} offsets={offs}: kernel {row['ms']:.4f} ms "
               f"(level 0 tiles {level0['attention']}, split "
               f"{row['split']}, {row['blocks']} blocks), plain "
               f"{row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms, "
               f"bound {row['bound_ms']:.5f} ms ({row['bound_by']}); per "
               "level ms " + ", ".join(f"{v:.4f}" for v in per_level)
               + "; per level (split, blocks) "
               + ", ".join(f"{g}" for g in geometry))
    return rows


def paged_bound(offs, ps, h, kh, d, s=1) -> tuple[float, str, int, int]:
    """The least time for one call of the paged kernel (``s`` queries per
    row from position ``o``; kv_valid is ``o + s``): each row's visible
    keys, ``o + s`` of K and V (bf16), q and out (bf16), the
    ``ceil((o + s) / ps)`` table entries that address those keys and the
    row's offset and kv_valid (int32), each read or written once at
    3.35 TB/s, against 4*D FLOPs per query head and key that query sees
    (``o + i + 1`` for query i) at 989 TFLOP/s."""
    b = len(offs)
    keys = sum(o + s for o in offs)
    entries = sum(-(-(o + s) // ps) for o in offs)
    nbytes = keys * kh * d * 2 * 2 + 2 * b * s * h * d * 2 + entries * 4 + \
        2 * b * 4
    flops = 4 * h * d * sum(o + i + 1 for o in offs for i in range(s))
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
    separates the kernel's cost per tile from its fixed cost, and a
    speculative verify pass (five queries per row); then decode steps and
    verifies at phase 13's heads (KV groups of 7, 16 and 1) and phase
    14's (6 and 1)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention_paged as fap
    from repro_torch.kernels.ref import paged_attention_ref

    scratch = torch.empty(96 * 2**20, dtype=torch.uint8, device=dev)

    def flush():
        scratch.zero_()

    rows = []
    b, t = 4, MAX_LEN
    shapes = [(label, offs, s, 8, 1, 256)
              for label, offs, s in (("decode", [68, 140, 260, 300], 1),
                                     ("decode, one tile per row", [63] * 4,
                                      1),
                                     ("verify", [68, 140, 260, 300], 5))]
    # phase 13's and phase 14's groups: decode steps and verifies
    # (llama3's 80 rows a verify: two row tiles)
    shapes += [(f"{arch} {label}", [68, 140, 260, 300], s, h, kh, d)
               for arch, (h, kh, d) in CONFIG_HEADS.items()
               for label, s in (("decode", 1), ("verify", 5))]
    for label, offs, s, h, kh, d in shapes:
        off = torch.tensor(offs, dtype=torch.int32, device=dev)
        kvl = off + s
        q, kp, vp, table = paged_inputs(gen, dev, b, h, kh, d, PAGE_SIZE,
                                        kvl, s=s)
        kd = fap.gather_pages(kp, table)
        vd = fap.gather_pages(vp, table)
        qpos = off[:, None] + torch.arange(s, device=dev)
        mask = (torch.arange(t, device=dev)[None, None, :]
                <= qpos[:, :, None])[:, None]            # (B,1,S,T)
        qt = q.transpose(1, 2)
        kt, vt = (a.transpose(1, 2).expand(b, h, t, d) if kh == 1 else
                  a.transpose(1, 2).repeat_interleave(h // kh, dim=1)
                  for a in (kd, vd))
        bound_ms, bound_by, nbytes, flops = paged_bound(
            offs, PAGE_SIZE, h, kh, d, s)
        row = {"name": "flash_attention_paged", "shape": label, "b": b,
               "s": s, "h": h, "kh": kh, "d": d, "page_size": PAGE_SIZE,
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
            b, s, h, kh, PAGE_SIZE, table.shape[1])
        rows.append(row)
        report(f"time flash_attention_paged {label} B={b} S={s} H={h} "
               f"K={kh} D={d} page {PAGE_SIZE} offsets={offs}: kernel "
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
    from repro_torch.models.model import cache_batch_axis
    page_bytes = 0                                  # one page, all layers
    for path in engine._paged_paths:
        pool = engine.cache
        for key in path:
            pool = pool[key]
        page_bytes += pool.select(cache_batch_axis(path), 0).numel() * \
            pool.element_size()
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


def sharing_prompts(prompts, vocab: int, seed: int):
    """The paged serve's requests: ``prompts`` with two requests inserted
    third and fourth that share the PAGED_BASE prompt's pages (one borrows
    two full pages and adds 20 tokens, one borrows a page and a half, so
    its first decode copies the shared page).  -> (requests' prompts,
    each one's index in ``prompts`` or None)."""
    import numpy as np
    base = prompts[PAGED_BASE]
    tail = np.random.default_rng(seed + 1).integers(0, vocab, 20)
    sharers = [np.concatenate([base[:2 * PAGE_SIZE],
                               tail.astype(np.int32)]),
               base[:PAGE_SIZE + PAGE_SIZE // 2].copy()]
    rest = [i for i in range(len(prompts)) if i != PAGED_BASE]
    order = [PAGED_BASE, rest[0]] + [None, None] + rest[1:]
    return ([prompts[i] if i is not None else sharers.pop(0)
             for i in order], order)


def serve_paged(cfg, params, prompts, dense_streams, dev, report,
                seed, card) -> tuple[dict, dict]:
    """Serve the dense serve's prompts again on a paged engine
    (``page_size=PAGE_SIZE``, the default 128 usable pages), with two
    requests that share the PAGED_BASE prompt's pages, then profile one
    paged decode quantum.  Exact launch accounting for all three kernels
    of the path; the pool's counters are checked after the serve; the
    streams of the dense serve's prompts are compared, not gated (the
    paged and dense kernels sum in different orders)."""
    from repro_torch.kernels import block_matmul as bm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_paged as fap

    paged_prompts, order = sharing_prompts(prompts, cfg.vocab_size, seed)
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
    out["pairs"] = engine_pairs({"eager": eager, "graphs": engine}, prompts,
                                report, groups, chunk=False)
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


# ---------------------------------------------------------------------------
# Phase 9: co-location (ClusterRuntime over three full-width engines)

CL_ARCHS = ("gemma-2b", "starcoder2-3b", "mamba2-780m")
# starcoder2-3b's published widths, held before its engine is built
CL_STARCODER2 = {"num_layers": 30, "d_model": 3072, "num_heads": 24,
                 "num_kv_heads": 2, "head_dim": 128, "d_ff": 12288}
CL_QUERIES = 24
CL_QPS = 40.0
# the H100 plans select one version at every level (their efficiency curve
# is TPU_V5E_POD's, uncalibrated), so a serve under them never switches:
# phase 9 adds a second built tile to each plan's tile source, selected
# from grid level CL_SWITCH_LEVEL up (half the solo tile's bk and bn: a
# quarter of its shared memory, twice the blocks), so the co-located
# engines switch versions mid-serve
CL_SECOND_TILE = (128, 32, 64)
CL_SWITCH_LEVEL = 2
STREAM_ENTRIES = 10_000


def cluster_workload(seed: int):
    """Phase 9's traffic: Poisson arrivals over the three tenants, prompts
    of 5-250 tokens (drawn as the runtime phases draw them), MAX_NEW new
    tokens each."""
    from repro_torch.serving.runtime import Workload
    return Workload.poisson(list(CL_ARCHS), CL_QPS, CL_QUERIES,
                            prompt_len=250, prompt_len_spread=245,
                            max_new_tokens=MAX_NEW, seed=seed)


def two_version_plans(plans: dict, hw) -> dict:
    """Each plan with its tile source's version set (the layer of the
    largest solo-version FLOPs, as the engine picks it) holding
    CL_SECOND_TILE beside its solo version, selected from grid level
    CL_SWITCH_LEVEL up."""
    from repro_torch.core import cost_model as cm
    from repro_torch.core import schedule_space as ss

    out = {}
    for arch, plan in plans.items():
        vsets = list(plan.version_sets)
        i = max(range(len(vsets)),
                key=lambda j: vsets[j].solo_version().flops)
        second = [v for v in ss.enumerate_versions(plan.layers[i], hw)
                  if (v.bm, v.bk, v.bn) == CL_SECOND_TILE]
        solo = vsets[i].solo_version()
        require(len(second) == 1 and solo.key() != second[0].key(),
                f"cluster: {arch}'s tile source {vsets[i].layer_name} has "
                f"no version {CL_SECOND_TILE} apart from its solo version")
        vsets[i] = dataclasses.replace(
            vsets[i], versions=[solo, second[0]],
            level_table=[0] * CL_SWITCH_LEVEL
            + [1] * (cm.NUM_LEVELS - CL_SWITCH_LEVEL))
        out[arch] = dataclasses.replace(plan, version_sets=vsets)
    return out


def cluster_launches(cfgs: dict):
    """Launches a cluster serve makes: each forward pass (decode step or
    prefill chunk) of a dense engine runs its MLP GEMMs (three per layer
    gated, two plain) and its attention through the kernels; mamba2 runs
    the scan once per layer for every prefill chunk of two or more
    tokens.  ``expected(passes)`` takes arch -> (decode steps, chunk
    sizes)."""
    def expected(passes):
        want = collections.Counter()
        why = collections.defaultdict(list)
        for arch, (steps, chunks) in passes.items():
            cfg = cfgs[arch]
            if cfg.ssm is not None:
                scan = sum(c >= 2 for c in chunks)
                want["ssd_scan"] += cfg.num_layers * scan
                why["ssd_scan"].append(f"{arch} {cfg.num_layers} x {scan} "
                                       "chunks of >= 2 tokens")
                continue
            mats = 3 if cfg.activation in ("swiglu", "geglu") else 2
            n = steps + len(chunks)
            want["block_matmul"] += mats * cfg.num_layers * n
            want["flash_attention"] += cfg.num_layers * n
            why["block_matmul"].append(
                f"{arch} {mats * cfg.num_layers} x {n} passes")
            why["flash_attention"].append(
                f"{arch} {cfg.num_layers} x {n} passes")
        return want, {k: "; ".join(v) for k, v in why.items()}
    return expected


class ClusterCalls:
    """Wraps every engine's device-facing calls for one cluster serve
    (instance attributes that shadow the methods; ``close()`` restores
    them): the host time inside the engines, each engine's decode
    K-buckets, prefill chunk sizes, decode quanta and finished prompts
    (the launch and host-sync accounting), per request the code version
    and the steps of every chunk and decode quantum it ran in (the solo
    replay), and, on the card, a pair of CUDA events on the engine's
    stream around every chunk and quantum it dispatches (its stream's
    activity: ``stream_activity``)."""

    TIMED = ("admit_request", "set_interference_level", "prefill_step",
             "begin_quantum", "finish_quantum")

    def __init__(self, tenants):
        import torch
        self.tenants = tenants
        self.inside_s = 0.0
        self.buckets = {t.name: [] for t in tenants}
        self.chunks = {t.name: [] for t in tenants}
        self.finished_prompts = {t.name: 0 for t in tenants}
        self.ops: dict[int, list] = collections.defaultdict(list)
        self.versions = {t.name: [] for t in tenants}
        self.cuda = torch.cuda.is_available()
        self.spans: list[tuple] = []        # (stream, start, end events)
        self.origin = None
        if self.cuda:
            self.origin = torch.cuda.Event(enable_timing=True)
            self.origin.record()
        for t in tenants:
            for name in self.TIMED:
                setattr(t.engine, name,
                        self._wrap(t.name, t.engine, name,
                                   getattr(t.engine, name)))

    def _event(self, stream):
        import torch
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    def _wrap(self, tenant, engine, name, fn):
        spans = self.cuda and name in ("prefill_step", "begin_quantum")

        def call(*args, **kw):
            level, key = engine.interference_level, engine._entry.key
            t0 = time.perf_counter()
            start = self._event(engine.stream) if spans else None
            out = fn(*args, **kw)
            if spans and out is not None:
                self.spans.append((engine.stream, tenant, start,
                                   self._event(engine.stream)))
            self.inside_s += time.perf_counter() - t0
            if name in ("prefill_step", "begin_quantum") and out is not None:
                self.versions[tenant].append(key)
            if name == "prefill_step" and out is not None:
                self.chunks[tenant].append(out.chunk)
                self.finished_prompts[tenant] += out.finished
                self.ops[out.rid].append(("chunk", level, key, out.chunk))
            elif name == "begin_quantum" and out is not None:
                self.buckets[tenant].append(out.bucket)
                for i in out.active:
                    self.ops[engine.slot_req[i].rid].append(
                        ("decode", level, key, int(out.n_left[i])))
            return out
        return call

    def close(self) -> None:
        for t in self.tenants:
            for name in self.TIMED:
                t.engine.__dict__.pop(name, None)

    def stream_activity(self) -> dict | None:
        """After the serve has synchronized: each stream's active time
        (the union of the spans from a dispatch's first event to its last
        on that stream: the engine's work in flight, its kernels and the
        gaps between them) and the union over all streams, in ms."""
        if not self.spans:
            return None
        by_stream = collections.defaultdict(list)
        names = collections.defaultdict(set)
        for stream, tenant, start, end in self.spans:
            by_stream[id(stream)].append(
                (self.origin.elapsed_time(start),
                 self.origin.elapsed_time(end)))
            names[id(stream)].add(tenant)
        per = {"+".join(sorted(names[k])): sum(
            b - a for a, b in merge_intervals(v))
            for k, v in by_stream.items()}
        union = merge_intervals([x for v in by_stream.values() for x in v])
        return {"union_active_ms": sum(b - a for a, b in union),
                "stream_active_ms": per,
                "sum_stream_active_ms": sum(per.values())}


def stream_busy(prof) -> dict:
    """From a torch.profiler trace of the card: the union of its busy
    intervals (ms), each stream's busy time (ms, the union of its own
    intervals) and their sum.  Read from the profiler's raw results."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    raw = getattr(prof.profiler, "kineto_results", None)
    spans = collections.defaultdict(list)
    if raw is not None:
        for e in raw.events():
            if e.device_type() == cuda:
                s = e.start_ns()
                spans[e.device_resource_id()].append((s, s + e.duration_ns()))
    union = merge_intervals([x for v in spans.values() for x in v])
    per_stream = {str(k): sum(b - a for a, b in merge_intervals(v)) / 1e6
                  for k, v in spans.items()}
    return {"union_busy_ms": sum(b - a for a, b in union) / 1e6,
            "stream_busy_ms": per_stream,
            "sum_stream_busy_ms": sum(per_stream.values())}


def cluster_serve(tenants, hw, policy, seed, counters, *, wall_clock=False,
                  profile=False) -> dict:
    """One serve of ``cluster_workload(seed)`` through ClusterRuntime over
    ``tenants`` with ``policy`` (a class taking the spec): oracle counters
    in virtual time, measured counters in wall-clock mode.  The launch
    counters are zeroed just before the serve and read just after;
    ``profile`` runs it under torch.profiler's CUDA activity and adds the
    busy union and per-stream busy."""
    import torch
    from repro_torch.serving.cluster import ClusterRuntime

    rt = ClusterRuntime(tenants, policy(hw), hw, wall_clock=wall_clock,
                        counter_source="measured" if wall_clock
                        else "oracle")
    wl = cluster_workload(seed)
    engines = {t.name: t.engine for t in tenants}
    traces0 = {n: e.version_cache.traces for n, e in engines.items()}
    syncs0 = {n: e.host_syncs for n, e in engines.items()}
    tokens0 = {n: e.tokens_decoded for n, e in engines.items()}
    calls = ClusterCalls(tenants)
    busy = None
    torch.cuda.synchronize()
    for c in counters.values():
        c.clear()
    t0 = time.perf_counter()
    try:
        if profile:
            from torch.profiler import ProfilerActivity, profile as tprof
            with tprof(activities=[ProfilerActivity.CUDA]) as prof:
                metrics = rt.serve(wl)
                torch.cuda.synchronize()
                wall_s = time.perf_counter() - t0
            busy = stream_busy(prof)
        else:
            metrics = rt.serve(wl)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
    finally:
        calls.close()
    trace_s = time.perf_counter() - t0 - wall_s
    return {"runtime": rt, "metrics": metrics, "workload": wl,
            "calls": calls, "wall_s": wall_s, "trace_s": trace_s,
            "activity": calls.stream_activity(),
            "launches": {name: sum(c.values())
                         for name, c in counters.items()},
            "builds": {n: e.version_cache.traces - traces0[n]
                       for n, e in engines.items()},
            "host_syncs": {n: e.host_syncs - syncs0[n]
                           for n, e in engines.items()},
            "tokens": {n: e.tokens_decoded - tokens0[n]
                       for n, e in engines.items()},
            "busy": busy}


def check_cluster_serve(what, run, hw, expected, report) -> dict:
    """The checks every cluster serve must pass: every query served with
    all its tokens, every tick's grants within the SMs and the pool whole
    after, a quantum and a level per quantum for every engine, nothing
    built, one host sync per decode quantum and per finished prompt, and
    launches equal to the forward passes each engine ran."""
    rt, m, wl, calls = (run["runtime"], run["metrics"], run["workload"],
                        run["calls"])
    require(m.aggregate.n_queries == wl.n_queries == len(rt.outputs),
            f"{what}: {m.aggregate.n_queries} of {wl.n_queries} served")
    require(all(len(toks) == wl.max_new_tokens + 1
                for toks in rt.outputs.values()),
            f"{what}: a request ended short")
    sums = [sum(p.values()) for p in m.partition_trace]
    require(max(sums) <= hw.n_units and m.pool_peak_used <= hw.n_units,
            f"{what}: a tick granted {max(sums)} of {hw.n_units} SMs")
    require(rt.pool.free == rt.pool.total, f"{what}: the pool holds "
            f"{rt.pool.total - rt.pool.free} units after the serve")
    names = [t.name for t in rt.tenants]
    require(all(m.quanta[a] >= 1 and len(m.level_traces[a]) == m.quanta[a]
                for a in names), f"{what}: quanta {m.quanta}, level traces "
            f"{ {a: len(v) for a, v in m.level_traces.items()} }")
    require(not any(run["builds"].values()),
            f"{what}: builds (captures) during the serve {run['builds']}")
    for a in names:
        want = len(calls.buckets[a]) + calls.finished_prompts[a]
        require(run["host_syncs"][a] == want,
                f"{what}: {a} {run['host_syncs'][a]} host syncs for "
                f"{len(calls.buckets[a])} decode quanta + "
                f"{calls.finished_prompts[a]} finished prompts")
    passes = {a: (sum(calls.buckets[a]), calls.chunks[a]) for a in names}
    want, why = expected(passes)
    for name, n in run["launches"].items():
        require(n == want[name], f"{what}: {name} {n} launches, expected "
                f"{want[name]} ({why.get(name)})")
    levels = {a: dict(sorted(collections.Counter(
        cm_idx(x) for x in m.level_traces[a]).items())) for a in names}
    # the code versions each engine ran its chunks and quanta in, and how
    # often it switched between them mid-serve
    versions = {a: len(set(calls.versions[a])) for a in names}
    switches = {a: sum(x != y for x, y in zip(calls.versions[a],
                                              calls.versions[a][1:]))
                for a in names}
    out = {"queries": m.aggregate.n_queries, "ticks": rt.ticks,
           "quanta": dict(m.quanta), "prefill_quanta": m.prefill_quanta,
           "decode_quanta": {a: len(calls.buckets[a]) for a in names},
           "decode_steps": {a: sum(calls.buckets[a]) for a in names},
           "prefill_chunks": {a: len(calls.chunks[a]) for a in names},
           "host_syncs": run["host_syncs"], "launches": run["launches"],
           "expected_launches": dict(want), "levels": levels,
           "versions_run": versions, "version_switches": switches,
           "max_partition": max(sums),
           "partition_ticks": len(m.partition_trace),
           "counter_sources": dict(rt.counter_sources),
           "serve_wall_s": run["wall_s"]}
    report(f"{what}: {m.aggregate.n_queries} served over {rt.ticks} ticks; "
           f"quanta {out['quanta']}, prefill chunks "
           f"{out['prefill_chunks']}, decode steps {out['decode_steps']}; "
           f"at most {max(sums)} of {hw.n_units} SMs granted in a tick, "
           "pool whole after; 0 captures; host syncs "
           f"{run['host_syncs']}; levels (grid index: quanta) {levels}; "
           f"versions run {versions}, switched mid-serve {switches} times; "
           "launches " + ", ".join(f"{k} {v} ({why.get(k)})"
                                   for k, v in run["launches"].items()))
    return out


def solo_replay(tenants, run, report) -> dict:
    """Each request of a co-located serve served again alone on its own
    (idle) engine, through the code versions and the steps it met in the
    serve: its chunks one by one, then a decode quantum of the steps it
    took in each quantum it ran in.  Its token stream must be the one the
    co-located serve gave it."""
    from repro_torch.serving.engine import Request

    rt, wl, calls = run["runtime"], run["workload"], run["calls"]
    prompts = rt.tenant_prompts(wl)
    lens = wl.prompt_lengths()
    tenant_of = {rid: name for rid, (_, name) in
                 enumerate(sorted(wl.arrivals))}
    engines = {t.name: t.engine for t in tenants}
    t0 = time.perf_counter()
    same = 0
    for rid in sorted(rt.outputs):
        name = tenant_of[rid]
        eng = engines[name]
        require(eng.active_slots == 0, f"replay: {name} is not idle")
        req = Request(rid=rid, prompt=prompts[name][rid, :lens[rid]],
                      max_new_tokens=wl.max_new_tokens)
        require(eng.admit_request(req), f"replay: {rid} not admitted")
        for kind, level, key, steps in calls.ops[rid]:
            eng.set_interference_level(level)
            require(eng._entry.key == key, f"replay: {rid} at level {level} "
                    "selects another version")
            if kind == "chunk":
                pq = eng.prefill_step()
                require(pq is not None and pq.chunk == steps,
                        f"replay: {rid} chunk {steps} ran as {pq}")
                continue
            handle = eng.begin_quantum(steps)
            require(handle is not None and int(handle.n_left.sum()) == steps,
                    f"replay: {rid} quantum of {steps} steps")
            eng.finish_quantum(handle)
        require(req.done, f"replay: request {rid} did not finish")
        same += req.output == rt.outputs[rid]
    replay_s = time.perf_counter() - t0
    require(same == len(rt.outputs),
            f"replay: {same} of {len(rt.outputs)} co-located token streams "
            "equal the streams served alone")
    report(f"cluster solo replay: {same} of {len(rt.outputs)} co-located "
           "token streams equal the streams each request gives served alone "
           f"on its engine through the same versions and steps "
           f"({replay_s:.1f} s)")
    return {"equal": same, "requests": len(rt.outputs),
            "replay_s": replay_s}


def cluster_wall_report(what, run, busy_run, card, report) -> dict:
    """What a wall-clock cluster serve measured: per-engine level traces,
    wall per tick, the runtime's own host time per tick, latencies per
    tenant, qos_rate and qps_at_qos against the plans' QoS (derived from
    the H100 spec's analytic solo latency), tokens/s per engine; from the
    serve's own CUDA events the streams' activity: the device's idle
    share (1 - the union of the streams' active time over the wall) and
    the overlap (the sum of each stream's active time over their union:
    1.0 when nothing overlapped); and from a profiled rerun ``busy_run``
    (None: not profiled) the same two from the kernels' busy time."""
    rt, m = run["runtime"], run["metrics"]
    ticks = max(rt.ticks, 1)
    levels = {a: dict(sorted(collections.Counter(
        cm_idx(x) for x in tr).items())) for a, tr in m.level_traces.items()}
    per = {}
    for a, tm in m.per_tenant.items():
        per[a] = {"queries": tm.n_queries,
                  "avg_latency_ms": tm.avg_latency_s * 1e3,
                  "p99_latency_ms": tm.p99_latency_s * 1e3,
                  "avg_ttft_ms": tm.avg_ttft_s * 1e3,
                  "qos_rate": tm.qos_rate, "qps_at_qos": tm.qps_at_qos,
                  "qos_ms": rt.tenants[[t.name for t in rt.tenants].index(
                      a)].plan.qos_s * 1e3,
                  "tokens_per_s": run["tokens"][a] / run["wall_s"]}
    agg = m.aggregate
    out = {"card": card, "serve_wall_s": run["wall_s"], "ticks": rt.ticks,
           "wall_per_tick_ms": run["wall_s"] * 1e3 / ticks,
           "runtime_host_ms_per_tick": (run["wall_s"] - run["calls"].inside_s)
           * 1e3 / ticks,
           "levels": levels,
           "levels_leave_0": {a: any(x > 0 for x in tr)
                              for a, tr in m.level_traces.items()},
           "counter_sources": dict(rt.counter_sources),
           "proxy_refits": agg.refit_count,
           "aggregate": {"avg_latency_ms": agg.avg_latency_s * 1e3,
                         "p99_latency_ms": agg.p99_latency_s * 1e3,
                         "qos_rate": agg.qos_rate,
                         "qps_at_qos": agg.qps_at_qos},
           "per_tenant": per, "quanta": dict(m.quanta)}
    act = run["activity"]
    if act and act["union_active_ms"]:
        out["activity"] = {
            "union_active_ms": act["union_active_ms"],
            "stream_active_ms": act["stream_active_ms"],
            "device_idle_share": max(0.0, 1.0 - act["union_active_ms"]
                                     / (run["wall_s"] * 1e3)),
            "overlap": act["sum_stream_active_ms"] / act["union_active_ms"]}
    busy = busy_run["busy"] if busy_run else None
    if busy and busy["union_busy_ms"]:
        out["profiled"] = {
            "device_busy_ms": busy["union_busy_ms"],
            "stream_busy_ms": busy["stream_busy_ms"],
            "device_idle_share_profiled": max(
                0.0, 1.0 - busy["union_busy_ms"] / (busy_run["wall_s"] * 1e3)),
            "device_idle_share": max(0.0, 1.0 - busy["union_busy_ms"]
                                     / (run["wall_s"] * 1e3)),
            "overlap": busy["sum_stream_busy_ms"] / busy["union_busy_ms"],
            "profiled_wall_s": busy_run["wall_s"],
            "profiled_ticks": busy_run["runtime"].ticks,
            "trace_processing_s": busy_run["trace_s"]}
    report(f"{what} [{card}]: {agg.n_queries} served in "
           f"{run['wall_s']:.3f} s over {rt.ticks} ticks: wall per tick "
           f"{out['wall_per_tick_ms']:.3f} ms, runtime host "
           f"{out['runtime_host_ms_per_tick']:.3f} ms per tick; latency avg "
           f"{out['aggregate']['avg_latency_ms']:.2f} ms, p99 "
           f"{out['aggregate']['p99_latency_ms']:.2f} ms, qos_rate "
           f"{agg.qos_rate:.4f}, qps_at_qos {agg.qps_at_qos:.3f}; "
           f"counter sources {out['counter_sources']}, proxy refits "
           f"{agg.refit_count}")
    report(f"{what} [{card}]: per tenant " + "; ".join(
        f"{a} n {v['queries']} avg {v['avg_latency_ms']:.2f} ms p99 "
        f"{v['p99_latency_ms']:.2f} ms ttft {v['avg_ttft_ms']:.2f} ms "
        f"qos {v['qos_ms']:.3f} ms qos_rate {v['qos_rate']:.4f} "
        f"qps_at_qos {v['qps_at_qos']:.3f} tokens/s "
        f"{v['tokens_per_s']:.1f}" for a, v in per.items()))
    report(f"{what} [{card}]: levels (grid index: quanta) {levels}; leave "
           f"level 0: {out['levels_leave_0']}")
    a = out.get("activity")
    if a:
        report(f"{what} [{card}]: stream activity (CUDA events around each "
               f"dispatch): union {a['union_active_ms']:.1f} ms of "
               f"{run['wall_s'] * 1e3:.1f} ms wall: idle share "
               f"{a['device_idle_share']:.4f}; per stream " + ", ".join(
                   f"{k} {v:.1f}" for k, v in a["stream_active_ms"].items())
               + f" ms: overlap {a['overlap']:.4f}")
    else:
        report(f"{what} [{card}]: no stream activity recorded (idle share "
               "and overlap not measured)")
    b = out.get("profiled")
    if b:
        report(f"{what} [{card}]: profiled rerun ({b['profiled_ticks']} "
               f"ticks, {b['profiled_wall_s']:.3f} s under torch.profiler): "
               f"kernel busy {b['device_busy_ms']:.1f} ms (union): idle share "
               f"{b['device_idle_share_profiled']:.4f} of the profiled wall, "
               f"{b['device_idle_share']:.4f} against the unprofiled serve's "
               "wall; per stream " + ", ".join(
                   f"{k} {v:.1f}" for k, v in b["stream_busy_ms"].items())
               + f" ms: overlap {b['overlap']:.4f} (reading the trace took "
               f"{b['trace_processing_s']:.1f} s)")
    elif busy_run is not None:
        report(f"{what} [{card}]: torch.profiler recorded no device time "
               "(kernel busy not measured)")
    return out


def serve_cluster(dev, counters, report, seed, card) -> dict:
    """Phase 9: gemma-2b, starcoder2-3b and mamba2-780m at full width on
    one card, each engine on its own CUDA stream, under ClusterRuntime
    with the H100 spec's plans."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import cost_model as cm
    from repro_torch.core.multiversion import V_MAX
    from repro_torch.core.scheduler import PremaPolicy, VeltairPolicy
    from repro_torch.kernels import block_matmul as bmk
    from repro_torch.serving.cluster import ClusterRuntime, build_cluster
    from repro_torch.serving.engine import H100_LEVEL_TILES
    from repro_torch.serving.tenants import cluster_plans

    out: dict = {}
    t_phase = time.perf_counter()
    hw = cm.hardware_spec_for(dev)
    report(f"cluster: {hw.name} spec matches the card: {hw.n_units} SMs, "
           f"{hw.private_cache_bytes} bytes of shared memory per block, L2 "
           f"{hw.shared_cache_bytes} bytes; level switch "
           f"{hw.realloc_overhead_s * 1e6:.2f} us, node gap "
           f"{hw.serial_overhead_s * 1e6:.3f} us")
    plans = cluster_plans(list(CL_ARCHS), hw)
    run_plans = two_version_plans(plans, hw)
    built = {(m, k, n) for m in bmk.BM_CHOICES for k in bmk.BK_CHOICES
             for n in bmk.BN_CHOICES}
    # the tiles check_kernels held against the plain version
    checked = {(t["matmul"]["bm"], t["matmul"]["bk"], t["matmul"]["bn"])
               for t in H100_LEVEL_TILES}
    out["plans"], out["run_plans"] = {}, {}
    for key, table, what in (("plans", plans, "plan"),
                             ("run_plans", run_plans, "run plan")):
        for arch, plan in table.items():
            src = max(plan.version_sets,
                      key=lambda vs: vs.solo_version().flops)
            versions = [(v.bm, v.bk, v.bn) for v in src.versions]
            per_level = [src.select(cm.level_interference(cm.grid_point(i)))
                         for i in range(cm.NUM_LEVELS)]
            per_level = [(v.bm, v.bk, v.bn) for v in per_level]
            require(set(versions) <= built and len(versions) <= V_MAX,
                    f"cluster: {arch}'s versions {versions} are not built "
                    "tiles")
            require(set(versions) <= checked, f"cluster: {arch}'s versions "
                    f"{versions} were not held against the plain version")
            out[key][arch] = {"qos_ms": plan.qos_s * 1e3,
                              "tile_source": src.layer_name,
                              "versions": versions,
                              "tile_per_level": per_level}
            report(f"cluster {what} {arch}: qos {plan.qos_s * 1e3:.3f} ms "
                   f"(3x the analytic solo latency on {hw.name}); tile "
                   f"source {src.layer_name} versions (bm, bk, bn) "
                   f"{versions}; level 0..9 selects {per_level}")
    cfgs = {a: get_config(a) for a in CL_ARCHS}
    sc2 = cfgs["starcoder2-3b"]
    require(all(getattr(sc2, k) == v for k, v in CL_STARCODER2.items()),
            f"cluster: starcoder2-3b is not at full width: {sc2}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tenants = build_cluster(list(CL_ARCHS), hw, batch_slots=BATCH_SLOTS,
                            max_len=MAX_LEN, seed=seed, plans=run_plans,
                            configs=cfgs, device=dev)
    torch.cuda.synchronize()
    engines = {t.name: t.engine for t in tenants}
    streams = {t.engine.stream for t in tenants}
    require(len(streams) == len(tenants) and None not in streams,
            "cluster: the engines do not run on streams of their own")
    # the host cost of entering an engine's stream (every device-facing
    # engine call does)
    s0 = tenants[0].engine.stream
    t0 = time.perf_counter()
    for _ in range(STREAM_ENTRIES):
        with torch.cuda.stream(s0):
            pass
    out["stream_entry_us"] = ((time.perf_counter() - t0) * 1e6
                              / STREAM_ENTRIES)
    report(f"cluster: entering and leaving an engine's stream costs "
           f"{out['stream_entry_us']:.2f} us of host (mean of "
           f"{STREAM_ENTRIES})")
    weights = {t.name: sum(a.numel() * a.element_size() for a in
                           _leaves(t.engine.params)) for t in tenants}
    out["build"] = {"seconds": time.perf_counter() - t0,
                    "weight_bytes": weights,
                    "max_memory_allocated": torch.cuda.max_memory_allocated()}
    report(f"cluster: {len(tenants)} engines built in "
           f"{out['build']['seconds']:.1f} s (weights made on the card: "
           + ", ".join(f"{a} {b / 1e9:.2f} GB" for a, b in weights.items())
           + "); peak device memory "
           f"{out['build']['max_memory_allocated'] / 2**30:.2f} GiB")
    warm = {}
    for t in tenants:
        fn = t.engine.warmup

        def timed_warmup(*args, _fn=fn, _t=t, **kw):
            torch.cuda.synchronize()
            m0, w0 = torch.cuda.memory_allocated(), time.perf_counter()
            stats = _fn(*args, **kw)
            torch.cuda.synchronize()
            vc = _t.engine.version_cache
            warm[_t.name] = {
                "seconds": time.perf_counter() - w0,
                "captures": sum(c.graph is not None
                                for c in vc._calls.values()),
                "capture_s": vc.capture_s, "stats": stats,
                "allocated_bytes_delta": torch.cuda.memory_allocated() - m0}
            return stats
        t.engine.warmup = timed_warmup
    # starcoder2-3b at full width, kernels against plain versions on the
    # cluster's weights (gemma-2b's and mamba2-780m's run in phases 3-5)
    sc2_prompt = np.random.default_rng(seed).integers(
        0, sc2.vocab_size, 16).astype(np.int32)
    out["whole_model_starcoder2"] = whole_model_check(
        sc2, engines["starcoder2-3b"].params, sc2_prompt, dev, report)
    try:
        ClusterRuntime(tenants, VeltairPolicy(hw), hw).warmup()
    finally:
        for t in tenants:
            t.engine.__dict__.pop("warmup", None)
    for t in tenants:
        distinct = {str(t.engine.tiles_for_level(cm.grid_point(i)))
                    for i in range(cm.NUM_LEVELS)}
        w = warm[t.name]
        per_version = (1 + len(t.engine.quantum_buckets)
                       + len(t.engine.prefill_buckets))
        require(len(distinct) == 2 and
                w["captures"] == len(distinct) * per_version,
                f"cluster: {t.name} captured {w['captures']} graphs for "
                f"{len(distinct)} versions")
    out["warmup"] = warm
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    report("cluster warmup: " + "; ".join(
        f"{a} {w['captures']} CUDA graphs ({w['stats']['entries']} "
        f"versions) in {w['seconds']:.2f} s, +"
        f"{w['allocated_bytes_delta'] / 2**20:.1f} MiB"
        for a, w in warm.items())
        + f"; peak device memory {out['max_memory_allocated'] / 2**30:.2f} "
        "GiB")
    expected = cluster_launches(cfgs)

    run_a = cluster_serve(tenants, hw, VeltairPolicy, seed, counters)
    out["virtual"] = check_cluster_serve(
        "cluster virtual time (Veltair, oracle counters)", run_a, hw,
        expected, report)
    out["virtual"]["metrics_workload_time"] = {
        a: metrics_summary(v) for a, v in run_a["metrics"].per_tenant.items()}
    out["launches"] = dict(run_a["launches"])
    switched = out["virtual"]["versions_run"]
    require(all(n == 2 for n in switched.values()),
            f"cluster virtual time: versions run {switched}: an engine "
            "never switched its version mid-serve")
    out["solo_replay"] = solo_replay(tenants, run_a, report)

    def wall_pair(what, tenants, policy, profile=False):
        run = cluster_serve(tenants, hw, policy, seed, counters,
                            wall_clock=True)
        checks = check_cluster_serve(what, run, hw, expected, report)
        prof = (cluster_serve(tenants, hw, policy, seed, counters,
                              wall_clock=True, profile=True)
                if profile else None)
        res = cluster_wall_report(what, run, prof, card, report)
        res["checks"] = checks
        return run, res

    _, out["veltair"] = wall_pair("cluster wall clock (Veltair, measured "
                                  "counters, a stream per engine)", tenants,
                                  VeltairPolicy, profile=True)
    prema, out["prema"] = wall_pair("cluster wall clock (PREMA, measured "
                                    "counters, a stream per engine)",
                                    tenants, PremaPolicy)
    exclusive = all(sum(1 for g in part.values() if g > 0) <= 1
                    for part in prema["runtime"].partition_trace)
    require(exclusive, "cluster PREMA: a tick granted units to two engines")
    out["prema"]["exclusive"] = exclusive
    report("cluster: PREMA's quanta exclusive (one engine granted per tick)")
    # the serialized serve: the same weights and plans in three engines
    # built on one shared stream, warmed before they serve
    shared = torch.cuda.Stream(dev)
    one = build_cluster(list(CL_ARCHS), hw, batch_slots=BATCH_SLOTS,
                        max_len=MAX_LEN, seed=seed, plans=run_plans,
                        configs=cfgs, device=dev, stream=shared,
                        params={t.name: t.engine.params for t in tenants})
    require({t.engine.stream for t in one} == {shared},
            "cluster: the serialized engines do not share one stream")
    t0 = time.perf_counter()
    ClusterRuntime(one, VeltairPolicy(hw), hw).warmup()
    torch.cuda.synchronize()
    out["serialized_warmup_s"] = time.perf_counter() - t0
    # serve A again on them: the same traces and token streams as on
    # separate streams, and counter banks as warm as serve B's engines'
    # (a cold bank reads oracle counters)
    run_one = cluster_serve(one, hw, VeltairPolicy, seed, counters)
    check_cluster_serve("cluster virtual time (Veltair, oracle counters, "
                        "one stream)", run_one, hw, expected, report)
    for what in ("outputs", "sched_trace"):
        require(getattr(run_one["runtime"], what)
                == getattr(run_a["runtime"], what),
                f"cluster: one stream's {what} differ from separate streams'")
    require(run_one["metrics"].partition_trace
            == run_a["metrics"].partition_trace,
            "cluster: one stream's partition trace differs")
    report("cluster virtual time: one stream gives separate streams' "
           "outputs, schedule and partition traces")
    _, out["serialized"] = wall_pair(
        "cluster wall clock (Veltair, measured counters, one stream)", one,
        VeltairPolicy)
    out["phase_s"] = time.perf_counter() - t_phase
    report(f"cluster: the one-stream engines warmed in "
           f"{out['serialized_warmup_s']:.1f} s; phase 9 took "
           f"{out['phase_s']:.1f} s")
    del tenants, engines, one, prema, run_a, run_one
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 10: speculative decode quanta (n-gram drafts, one batched verify
# pass, per-family rollback), one CUDA graph per (version, K-bucket, depth)
SPEC_DEPTH = 4
# the levels the earlier phases cycle, and the K-buckets 8-step quanta
# reach (a verify at k = 8 runs bucket 8; plain quanta run 1-8)
SPEC_LEVELS = (0, 5, 9)
SPEC_BUCKETS = (1, 2, 4, 8)
# the repetitive arm, prompts whose greedy continuation the drafter can
# track, 128 new tokens: on gemma-2b constant-token prompts (one token
# each, drawn from the seed), whose random-weight continuation settles
# into repeats; on mamba2-780m, whose random-weight continuation of such a
# prompt never repeats an n-gram (constant-token prompts drafted in none of
# 32 quanta on an H100, PERF.md), echo prompts s + g + s, where g is the
# plain engine's greedy continuation of a random s (the SSM's state
# forgets within a few tokens, so after the second s it continues with g
# again, which the drafter finds after the first s); the adversarial
# arm: the serve's random prompts, 32 new tokens
SPEC_REP_LENS = (20, 48, 100, 180, 250, 64)
SPEC_ECHO_LENS = (24, 32, 40, 48, 56, 64)
SPEC_REP_NEW = 128
# alternating plain/spec serves per arm and configuration
SPEC_PAIRS = 3
# where a speculative stream may part from the plain one: a tie of the
# plain logits, the top two within SPEC_TIE_ULPS bf16 ulps of the top
# logit.  gemma-2b: two ulps.  mamba2-780m: eight; a verify scans its
# d + 1 tokens in one chunk where the plain path steps them one at a
# time, each layer's output then differs by a bf16 ulp here and there (at
# most 0.4% of its largest entry with the same input), and 24 residual
# layers of random weights carry that into the logits: its repetitive arm
# parted in 6 of 6 streams at gaps of 5, 2, 1, 1, 5 and 7 ulps on an H100
# (the phase's report).  Partings beyond two ulps are counted apart.
SPEC_TIE_ULPS = {"attention": 2, "ssm": 8}


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 numbers at ``x`` (8 significand bits)."""
    import math
    return 2.0 ** (math.floor(math.log2(max(abs(x), 1e-30))) - 7)


def drain(engine) -> None:
    """Run an engine's requests out in 8-step quanta (buckets its warmup
    built)."""
    while engine.active_slots:
        while engine.prefill_pending:
            engine.prefill_step()
        engine.step_quantum(QUANTUM)


class AlwaysDraft:
    """A drafter that always proposes d copies of the row's last token:
    makes a verify happen where a check or a profile needs one."""

    def propose(self, history, depth):
        import numpy as np
        return np.full(depth, int(history[-1]), np.int32)


class RejectedDraft:
    """A drafter that proposes d copies of the token after the row's last
    one in the vocabulary: the model's own next token almost never, even
    where its greedy stream repeats one token, so the verify rolls back."""

    def __init__(self, vocab: int):
        self.vocab = vocab

    def propose(self, history, depth):
        import numpy as np
        return np.full(depth, (int(history[-1]) + 1) % self.vocab, np.int32)


def one_step_logits(model, params, tokens, dev):
    """Logits of the token after ``tokens``: the prefix through 16-token
    prefill chunks into a batch-1 row, then one decode step with the last
    token (the plain path's numerics at that position)."""
    import torch
    row = model.init_cache(1, MAX_LEN, dev)
    toks = torch.as_tensor(tokens, dtype=torch.int64, device=dev)
    n = len(tokens) - 1
    t0 = 0
    while t0 < n:
        valid = min(16, n - t0)
        c = 1 << (valid - 1).bit_length()
        chunk = torch.zeros((1, c), dtype=torch.int64, device=dev)
        chunk[0, :valid] = toks[t0:t0 + valid]
        model.prefill_chunk(params, {"tokens": chunk}, row, t0, valid)
        t0 += valid
    logits, _ = model.decode_step(params, {"tokens": toks[n:]}, row,
                                  torch.tensor([n], device=dev))
    return logits[0].float()


def spec_partings(what, cfg, params, prompts, got, want, dev, report, *,
                  label="spec", other="the plain engine's") -> int:
    """``got`` (spec streams) equals ``want`` (plain streams) stream by
    stream, or parts where the plain logits at that position, recomputed
    through a one-step decode, have their top two tied and both tokens
    there: within SPEC_TIE_ULPS bf16 ulps of the top logit (the
    family's entry).  ``label`` starts the report line, ``other`` names
    ``want``.  Returns the partings."""
    import numpy as np
    from repro_torch.models.model import Model
    model = Model(cfg)
    ulps = SPEC_TIE_ULPS["attention" if cfg.ssm is None else "ssm"]
    parted = []
    for rid, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        t = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b),
                 min(len(g), len(w)))
        require(0 < t < min(len(g), len(w)),
                f"{what} request {rid}: streams of {len(g)} and {len(w)} "
                f"tokens part at {t}")
        hist = np.concatenate([np.asarray(prompts[rid]),
                               np.asarray(w[:t])])
        lg = one_step_logits(model, params, hist, dev)
        top2 = lg.topk(2).values.tolist()
        tie = ulps * bf16_ulp(top2[0])
        ok = (top2[0] - top2[1] <= tie and
              lg[g[t]].item() >= top2[0] - tie and
              lg[w[t]].item() >= top2[0] - tie)
        require(ok, f"{what} request {rid} parts at token {t} ({g[t]} "
                f"speculative, {w[t]} plain) where the plain logits are "
                f"not tied: top two {top2}, the tokens' "
                f"{lg[g[t]].item():.6g} / {lg[w[t]].item():.6g}, the tie "
                f"{tie:.3g}")
        parted.append({"rid": rid, "at": t, "top2": top2,
                       "gap_ulps": (top2[0] - top2[1]) / bf16_ulp(top2[0])})
    wide = sum(p["gap_ulps"] > 2 for p in parted)
    report(f"{label} {what}: {len(got) - len(parted)} of {len(got)} streams "
           f"equal {other}; {len(parted)} part, each at a tie "
           f"of the plain logits within {ulps} bf16 ulps, {wide} of them "
           f"beyond two ulps (gaps in bf16 ulps: "
           f"{[round(p['gap_ulps'], 2) for p in parted]})")
    return parted


def spec_engine(cfg, params, dev, report, *, speculative=True, graphs=True,
                levels=SPEC_LEVELS, **kw):
    """A 4-slot engine at the first of ``levels``, warmed (with graphs) at
    ``levels`` and SPEC_BUCKETS: captures and their seconds are
    reported."""
    import torch
    from repro_torch.core import cost_model as cm
    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine(cfg, params, batch_slots=BATCH_SLOTS,
                        max_len=MAX_LEN, device=dev, cuda_graphs=graphs,
                        speculative=speculative, spec_depth=SPEC_DEPTH,
                        **kw)
    eng.set_interference_level(cm.grid_point(levels[0]))
    what = (f"{cfg.name}{' paged' if eng.paged else ''} "
            f"{'spec' if speculative else 'plain'}")
    if graphs:
        t0 = time.perf_counter()
        eng.warmup(levels=[cm.grid_point(i) for i in levels],
                   quantum_buckets=SPEC_BUCKETS)
        torch.cuda.synchronize()
        calls = eng.version_cache._calls
        spec = sum(k[1] == "spec" for k in calls)
        report(f"spec warmup {what}: {time.perf_counter() - t0:.2f} s, "
               f"{sum(c.graph is not None for c in calls.values())} CUDA "
               f"graphs ({spec} verify graphs) captured in "
               f"{eng.version_cache.capture_s:.2f} s")
    return eng


def spec_serve(engine, prompts, n_new, counters, levels=SPEC_LEVELS) -> dict:
    """Serve ``prompts`` x ``n_new`` tokens in 8-step quanta while the
    level cycles over ``levels``, from the first of them (the version
    that prefills the first prompts is the same in every serve); the
    launch counters are zeroed just before and read just after.  Counts
    the verify passes, the plain quanta's decode steps and the prefill
    chunks run."""
    import torch
    from repro_torch.core import cost_model as cm
    from repro_torch.serving.engine import Request

    require(engine.active_slots == 0, "spec serve: the engine is not idle")
    reqs = [Request(rid=i, prompt=p, max_new_tokens=n_new)
            for i, p in enumerate(prompts)]
    levels = [cm.grid_point(i) for i in levels]
    engine.set_interference_level(levels[0])
    stats0 = dict(engine.spec_stats)
    syncs0, builds0 = engine.host_syncs, engine.version_cache.traces
    tokens0 = engine.tokens_decoded
    torch.cuda.synchronize()
    for c in counters.values():
        c.clear()
    pending = collections.deque(reqs)
    verifies = decode_steps = quanta = finishing = 0
    chunks: list[int] = []
    turn = 0
    t0 = time.perf_counter()
    while pending or engine.active_slots:
        while pending and engine.admit_request(pending[0]):
            pending.popleft()
        while engine.prefill_pending:
            pq = engine.prefill_step()
            chunks.append(pq.chunk)
            finishing += pq.finished
        engine.set_interference_level(levels[turn % len(levels)])
        turn += 1
        handle = engine.begin_quantum(QUANTUM)
        engine.finish_quantum(handle)
        if handle is not None:
            quanta += 1
            if handle.kind == "spec":
                verifies += 1
            else:
                decode_steps += handle.bucket
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: sum(c.values()) for name, c in counters.items()}
    for r in reqs:
        require(r.done and len(r.output) == n_new + 1,
                f"spec serve: request {r.rid} ended with {len(r.output)} "
                "tokens")
    syncs = engine.host_syncs - syncs0
    require(syncs == quanta + finishing, f"spec serve: {syncs} host syncs "
            f"for {quanta} quanta + {finishing} finishing prefills")
    if engine.version_cache.graphs is not None:
        require(engine.version_cache.traces == builds0,
                "spec serve: the graphed serve captured after warmup")
    stats = {k: engine.spec_stats[k] - stats0[k] for k in stats0
             if k != "draft_hit_rate"}
    stats["draft_hit_rate"] = (stats["tokens_accepted"]
                               / max(stats["tokens_drafted"], 1))
    tokens = engine.tokens_decoded - tokens0
    return {"streams": [list(r.output) for r in reqs], "wall_s": wall,
            "tokens": tokens, "tokens_per_s": tokens / wall,
            "quanta": quanta, "verifies": verifies,
            "decode_steps": decode_steps, "chunks": chunks,
            "host_syncs": syncs, "launches": launches, "spec_stats": stats}


def spec_expected(kind: str, cfg, out) -> dict:
    """Each kernel's launches for the serve ``out``: a verify pass is one
    forward of d + 1 tokens (B1 and B2, or B3 on a paged cache, once per
    layer; B4 once per layer in pass 1 and again in the restore pass);
    a plain quantum runs its bucket's decode steps; a prefill chunk one
    forward (the ssm family's scan for chunks of two or more tokens)."""
    n, v, steps = cfg.num_layers, out["verifies"], out["decode_steps"]
    chunks = len(out["chunks"])
    if kind == "ssm":
        return {"ssd_scan": n * (2 * v + sum(c >= 2 for c in out["chunks"]))}
    passes = v + steps + chunks
    if kind == "paged":
        return {"block_matmul": mlp_gemms(cfg) * n * passes,
                "flash_attention": n * chunks,
                "flash_attention_paged": n * (v + steps)}
    return {"block_matmul": mlp_gemms(cfg) * n * passes,
            "flash_attention": n * passes}


def spec_profile(what, engine, plain, prompts, groups, report) -> dict:
    """One verify quantum (a drafter that always drafts) under
    torch.profiler against a 1-step plain quantum of the plain engine,
    four rows each at level 0."""
    from repro_torch.core import cost_model as cm
    from repro_torch.serving.engine import Request

    out = {}
    for label, eng, k in (("verify", engine, QUANTUM), ("plain 1-step",
                                                        plain, 1)):
        eng.set_interference_level(cm.grid_point(0))
        drafter = eng.drafter
        if label == "verify":
            eng.drafter = AlwaysDraft()
        for i, p in enumerate(prompts[:BATCH_SLOTS]):
            require(eng.admit_request(Request(
                rid=900 + i, prompt=p, max_new_tokens=6 * QUANTUM),
                drain=True), "spec profile: no free slot")
        kinds = []

        def one():
            handle = eng.begin_quantum(k)
            kinds.append(handle.kind)
            eng.finish_quantum(handle)
        unprofiled_us = timed(one)
        prof = device_profile(one, groups)
        require(kinds == ["spec" if label == "verify" else "decode"] * 2,
                f"spec profile {what}: quanta {kinds}")
        out[label] = profile_summary(f"spec {what} one {label} quantum, 4 "
                                     "rows", unprofiled_us, prof, 1, report)
        eng.drafter = drafter
        drain(eng)
    v, p = out["verify"], out["plain 1-step"]
    out["busy_ratio"] = (v["device_busy_ms"] / p["device_busy_ms"]
                         if p["device_busy_ms"] else None)
    out["wall_ratio"] = v["wall_ms"] / p["wall_ms"]
    report(f"spec {what}: a verify quantum against a 1-step plain quantum: "
           f"wall {v['wall_ms']:.3f} / {p['wall_ms']:.3f} ms "
           f"({out['wall_ratio']:.3f}x), device busy "
           + ("not measured" if out["busy_ratio"] is None else
              f"{v['device_busy_ms']:.3f} / {p['device_busy_ms']:.3f} ms "
              f"({out['busy_ratio']:.3f}x)"))
    return out


def spec_index_check(what, engine, cfg, report) -> dict:
    """One verify with a row at ``MAX_LEN - 1 - d`` (its d + 1 writes end
    on the row's last position) beside a slot mid-prefill at MAX_LEN - 2
    (a frozen row whose d + 1 positions run past the row): no device
    fault, and the mid-prefill slot's cache (its dense row, or its pages)
    is unchanged bit for bit.  Both requests then run out."""
    import numpy as np
    import torch
    from repro_torch.models.params import tree_leaves_with_path
    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(5)
    near = Request(rid=950, prompt=rng.integers(
        0, cfg.vocab_size, MAX_LEN - 1 - SPEC_DEPTH).astype(np.int32),
        max_new_tokens=4 * SPEC_DEPTH)
    mid = Request(rid=951, prompt=rng.integers(
        0, cfg.vocab_size, MAX_LEN - 2).astype(np.int32), max_new_tokens=1)
    require(engine.admit_request(near, drain=True), "index check: no slot")
    require(engine.admit_request(mid), "index check: no slot")
    engine.prefill_step()
    slot = next(s for s, r in enumerate(engine.slot_req) if r is mid)
    require(slot in engine._prefill, "index check: the slot is not "
            "mid-prefill")

    def snapshot():
        torch.cuda.synchronize()
        if engine.paged:
            pages = torch.as_tensor([int(p) for p in engine._page_table[slot]
                                     if p], device=engine.device)
            return [leaf[:, pages].clone() for path, leaf in
                    tree_leaves_with_path(engine.cache)
                    if path != ("page_table",)]
        return [leaf.clone() for _, leaf in
                tree_leaves_with_path(engine._slice_row(slot))]
    before = snapshot()
    drafter, engine.drafter = engine.drafter, AlwaysDraft()
    handle = engine.begin_quantum(QUANTUM)
    engine.drafter = drafter
    require(handle is not None and handle.kind == "spec",
            f"index check {what}: no verify dispatched")
    engine.finish_quantum(handle)
    after = snapshot()
    same = all(torch.equal(a, b) for a, b in zip(before, after))
    require(same, f"index check {what}: the mid-prefill slot's cache "
            "changed")
    drain(engine)
    require(near.done and mid.done, "index check: requests did not finish")
    report(f"spec index check {what}: a verify with a row at position "
           f"{MAX_LEN - 1 - SPEC_DEPTH} beside a slot mid-prefill at "
           f"{MAX_LEN - 2} ran without a fault; the mid-prefill slot's "
           "cache is unchanged bit for bit")
    return {"ok": True}


def spec_restore_check(cfg, params, dev, report) -> dict:
    """mamba2's restore pass on the card, four rows prefilled with 16
    random tokens, budgets 0, 1, 3 and d + 1 (drafts are the verify's own
    continuation, fixed by verifying d + 1 times, so each row emits its
    budget).

    The model's verify: B4 launches twice per layer (pass 1 and the
    restore pass), the row that emits nothing keeps its conv and SSD
    state bit for bit in every layer.  Its state against plain decode
    steps over the same tokens is reported, not gated: from layer 1 on,
    the two paths' residual streams differ (bf16 roundings of a chunk
    against single steps, amplified layer by layer), so the states do.

    Layer by layer on the plain path's residual stream (both paths given
    the same input): the mixer's pass 1 (no state written) and restore
    pass (``valid_len = n_emit``) against ``n_emit`` single steps: conv
    state within two bf16 ulps, SSD state within STATE_RTOL of its
    largest entry, and bit-equal to the state carried in where ``n_emit``
    is 0."""
    import numpy as np
    import torch
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as S
    from repro_torch.models.model import Model
    from repro_torch.models.params import tree_map_with_path

    model = Model(cfg)
    rng = np.random.default_rng(6)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 16)),
                           device=dev)
    cache = model.init_cache(4, MAX_LEN, dev)
    logits, _ = model.prefill_chunk(params, {"tokens": toks}, cache, 0, 16)
    first = logits.argmax(-1)
    pos = torch.full((4,), 16, dtype=torch.int64, device=dev)

    def clone(tree):
        return tree_map_with_path(lambda _, a: a.clone(), tree)
    full = torch.full_like(pos, SPEC_DEPTH + 1)
    drafts = torch.zeros((4, SPEC_DEPTH), dtype=torch.int64, device=dev)
    for _ in range(SPEC_DEPTH + 1):
        block, _, accepted, _, _ = model.verify_quantum(
            params, first, drafts, clone(cache), pos, full)
        drafts = block.T[:, :SPEC_DEPTH].contiguous()
    require(accepted.tolist() == [SPEC_DEPTH] * 4, f"restore check: the "
            f"verify's own continuation accepted {accepted.tolist()}")
    budget = torch.tensor([0, 1, 3, SPEC_DEPTH + 1], device=dev)
    spec = clone(cache)
    before = ssd.launch_count()
    _, n_emit, _, _, _ = model.verify_quantum(params, first, drafts, spec,
                                              pos, budget)
    torch.cuda.synchronize()
    launched = ssd.launch_count() - before
    require(launched == 2 * cfg.num_layers, f"restore check: {launched} "
            f"ssd_scan launches for one verify, expected "
            f"{2 * cfg.num_layers}")
    require(torch.equal(n_emit, budget), f"restore check: emitted "
            f"{n_emit.tolist()}, budgets {budget.tolist()}")
    seq = torch.cat([first[:, None], drafts], dim=1)
    plain = clone(cache)
    for j in range(SPEC_DEPTH + 1):
        model.decode_step(params, {"tokens": seq[:, j]}, plain, pos + j,
                          live=n_emit > j)
    torch.cuda.synchronize()
    out = {"n_emit": n_emit.tolist(), "model": {}, "layers": {}}
    for name in ("conv", "ssd"):
        got = spec["blocks"]["ssm"][name].float()
        want = plain["blocks"]["ssm"][name].float()
        start = cache["blocks"]["ssm"][name].float()
        require(torch.equal(got[:, 0], start[:, 0]) and bool(
            torch.isfinite(got).all()), f"restore check: the row that "
            f"emitted nothing changed its {name} state, or a state is not "
            "finite")
        dims = tuple(range(1, got.ndim))
        out["model"][name] = ((got - want).abs().amax(dim=dims)
                              / want.abs().amax(dim=dims)).tolist()
    # layer by layer, both paths on the plain path's residual stream
    x = L.embed(params["embed"], seq, cfg)
    blocks, caches = params["blocks"]["ssm"], cache["blocks"]["ssm"]
    worst = {"conv": 0.0, "ssd": 0.0, "output": 0.0}
    none = torch.zeros(4, dtype=torch.bool, device=dev)
    for i in range(cfg.num_layers):
        p = tree_map_with_path(lambda _, a: a[i], blocks)["mixer"]
        c = tree_map_with_path(lambda _, a: a[i], caches)
        xa = L.apply_norm(tree_map_with_path(
            lambda _, a: a[i], blocks)["ln1"], x, cfg.norm_type)
        restored = clone(c)
        y1 = S.mamba2_block(p, xa, cfg=cfg, cache=restored, live=none)
        S.mamba2_block(p, xa, cfg=cfg, cache=restored, valid_len=n_emit,
                       live=n_emit > 0)
        stepped, ys = clone(c), []
        for j in range(SPEC_DEPTH + 1):
            ys.append(S.mamba2_block(p, xa[:, j:j + 1], cfg=cfg,
                                     cache=stepped, live=n_emit > j))
        torch.cuda.synchronize()
        # pass 1's outputs against single steps on the row that steps all
        # d + 1 tokens (reported: bf16 roundings, which the layers after
        # carry on)
        y_step = torch.cat(ys, dim=1)[3].float()
        worst["output"] = max(worst["output"], (
            (y1[3].float() - y_step).abs().max() / y_step.abs().max()).item())
        for name in ("conv", "ssd"):
            a, b = restored[name].float(), stepped[name].float()
            require(torch.equal(a[0], c[name][0].float()),
                    f"restore check layer {i}: the row that emitted nothing "
                    f"changed its {name} state")
            diff = (a - b).abs()
            ok = (bool((diff <= ATOL + RTOL * b.abs()).all()) if name ==
                  "conv" else bool(diff.max() <= STATE_RTOL * b.abs().max()))
            rel = (diff.max() / b.abs().max()).item()
            worst[name] = max(worst[name], rel)
            require(ok, f"restore check layer {i}: {name} state after the "
                    f"restore pass differs from {n_emit.tolist()} single "
                    f"steps by {rel:.4g} of its largest entry")
        x = x + torch.cat(ys, dim=1)
    out["layers"] = worst
    report(f"spec restore check {cfg.name}: a verify emitting "
           f"{n_emit.tolist()} tokens ({launched} ssd_scan launches); the "
           "row that emits nothing keeps its conv and SSD state bit for bit "
           "in every layer; layer by layer on one residual stream, the "
           f"restore pass against single steps: max |diff| / max |state| "
           f"conv {worst['conv']:.4g} (two bf16 ulps), SSD "
           f"{worst['ssd']:.4g} (tolerance {STATE_RTOL}); pass 1's outputs "
           f"against single steps, largest over layers (not gated): "
           f"{worst['output']:.4g}; whole model "
           f"against single steps (not gated: the residual streams part): "
           f"conv {max(out['model']['conv']):.4g}, SSD "
           f"{max(out['model']['ssd']):.4g} of the largest entry")
    return out


def serve_spec(cfg, params, plain, prompts, dev, report, seed) -> dict:
    """Phase 10 for one model: gemma-2b on a dense and on a paged cache
    (``plain`` is the phase-3 graphed engine; the paged config builds its
    own plain paged engine), or mamba2-780m (``plain`` from phase 6).
    Speculative engines (depth SPEC_DEPTH) graphed and eager, both arms,
    checks and pairs as the module docstring says."""
    import numpy as np
    from repro_torch.kernels import block_matmul as bm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_paged as fap
    from repro_torch.kernels import ssd_scan as ssd

    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 10)
    if cfg.ssm is None:
        repetitive = [np.full(n, int(rng.integers(cfg.vocab_size)), np.int32)
                      for n in SPEC_REP_LENS]
    else:
        seeds = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                 for n in SPEC_ECHO_LENS]
        cont = spec_serve(plain, seeds, SPEC_REP_NEW + SPEC_DEPTH, {})
        repetitive = [np.concatenate([s, np.asarray(g, np.int32), s])
                      for s, g in zip(seeds, cont["streams"])]
    arms = {"repetitive": (repetitive, SPEC_REP_NEW),
            "adversarial": (prompts, MAX_NEW)}
    if cfg.ssm is not None:
        configs = {"mamba2": ("ssm", {}, {"ssd_scan": ssd.LAUNCHES},
                              {"ssd_scan": "ssd_scan_kernel"})}
    else:
        dense = {"block_matmul": bm.LAUNCHES, "flash_attention": fa.LAUNCHES}
        groups = {"block_matmul": "block_matmul_kernel",
                  "flash_attention": "flash_attention_kernel"}
        configs = {
            "dense": ("dense", {}, dense, groups),
            "paged": ("paged", {"page_size": PAGE_SIZE},
                      {**dense, "flash_attention_paged": fap.LAUNCHES},
                      {**groups,
                       "flash_attention_paged": "paged_flash_kernel"})}
    out = {}
    for label, (kind, kw, counters, groups) in configs.items():
        what = f"{cfg.name} {label}"
        engines = {"spec": spec_engine(cfg, params, dev, report, **kw)}
        engines["plain"] = (plain if kind != "paged" else spec_engine(
            cfg, params, dev, report, speculative=False, **kw))
        res = {"arms": {}}
        first_spec, first_plain = {}, {}
        totals = collections.Counter()
        for arm, (arm_prompts, n_new) in arms.items():
            runs = {"plain": [], "spec": []}
            for i in range(SPEC_PAIRS):
                order = ["plain", "spec"] if i % 2 == 0 else \
                    ["spec", "plain"]
                for which in order:
                    r = spec_serve(engines[which], arm_prompts, n_new,
                                   counters)
                    runs[which].append(r)
                    require(r["streams"] == runs[which][0]["streams"],
                            f"spec {what} {arm}: the {which} serve's "
                            "streams changed between runs")
                    want = spec_expected(kind, cfg, r)
                    require(r["launches"] == want, f"spec {what} {arm} "
                            f"{which}: launches {r['launches']}, expected "
                            f"{want}")
            spec0 = first_spec[arm] = runs["spec"][0]
            first_plain[arm] = runs["plain"][0]
            for key in ("spec_quanta", "tokens_accepted", "spec_rollbacks"):
                totals[key] += spec0["spec_stats"][key]
            parted = spec_partings(
                f"{what} {arm}", cfg, params, arm_prompts, spec0["streams"],
                runs["plain"][0]["streams"], dev, report)
            walls = {k: statistics.median(r["wall_s"] for r in v)
                     for k, v in runs.items()}
            tps = {k: statistics.median(r["tokens_per_s"] for r in v)
                   for k, v in runs.items()}
            res["arms"][arm] = {
                "partings": len(parted), "parted": parted, "wall_s": walls, "tokens_per_s": tps,
                "wall_s_runs": {k: [r["wall_s"] for r in v]
                                for k, v in runs.items()},
                "speedup": tps["spec"] / tps["plain"],
                "spec_stats": spec0["spec_stats"],
                "verifies": spec0["verifies"],
                "plain_quanta_in_spec_serve": spec0["quanta"]
                - spec0["verifies"],
                "decode_steps": {k: v[0]["decode_steps"]
                                 for k, v in runs.items()},
                "launches": {k: v[0]["launches"] for k, v in runs.items()},
                "quanta": {k: v[0]["quanta"] for k, v in runs.items()}}
            st = spec0["spec_stats"]
            report(f"spec {what} {arm} ({len(arm_prompts)} requests x "
                   f"{n_new + 1} tokens, {SPEC_PAIRS} alternating pairs, "
                   f"median): plain {walls['plain']:.3f} s "
                   f"{tps['plain']:.1f} tokens/s, spec {walls['spec']:.3f} "
                   f"s {tps['spec']:.1f} tokens/s, spec/plain "
                   f"{res['arms'][arm]['speedup']:.3f}x; {st['spec_quanta']} "
                   f"verifies and {st['spec_fallbacks']} fallbacks, draft "
                   f"hit rate {st['draft_hit_rate']:.3f} "
                   f"({st['tokens_accepted']} of {st['tokens_drafted']}), "
                   f"{st['spec_rollbacks']} rollbacks; launches "
                   f"{spec0['launches']} (exact)")
        paths = ("spec_quanta", "tokens_accepted", "spec_rollbacks")
        if not all(totals[k] > 0 for k in paths):
            # the random model's n-gram drafts all held (or none came): one
            # more serve of the adversarial prompts drafts, every quantum,
            # tokens the model does not pick, as phase 11 serves echo
            # prompts where constant ones draft nothing
            arm_prompts, n_new = arms["adversarial"]
            drafter, engines["spec"].drafter = (engines["spec"].drafter,
                                                RejectedDraft(cfg.vocab_size))
            r = spec_serve(engines["spec"], arm_prompts, n_new, counters)
            engines["spec"].drafter = drafter
            want = spec_expected(kind, cfg, r)
            require(r["launches"] == want, f"spec {what} rejected drafts: "
                    f"launches {r['launches']}, expected {want}")
            for key in paths:
                totals[key] += r["spec_stats"][key]
            parted = spec_partings(
                f"{what} rejected drafts", cfg, params, arm_prompts,
                r["streams"], first_plain["adversarial"]["streams"], dev,
                report)
            st = r["spec_stats"]
            res["arms"]["rejected drafts"] = {
                "partings": len(parted), "parted": parted,
                "spec_stats": st, "verifies": r["verifies"],
                "launches": {"spec": r["launches"]}}
            report(f"spec {what} rejected drafts ({len(arm_prompts)} "
                   f"requests x {n_new + 1} tokens, one serve): "
                   f"{st['spec_quanta']} "
                   f"verifies, draft hit rate {st['draft_hit_rate']:.3f} "
                   f"({st['tokens_accepted']} of {st['tokens_drafted']}), "
                   f"{st['spec_rollbacks']} rollbacks; launches "
                   f"{r['launches']} (exact)")
        require(all(totals[k] > 0 for k in paths),
                f"spec {what}: over the arms {dict(totals)}: the "
                "acceptance and the rollback path must both run")
        # eager equals graphed, on the repetitive arm
        eager = spec_engine(cfg, params, dev, report, graphs=False, **kw)
        arm_prompts, n_new = arms["repetitive"]
        er = spec_serve(eager, arm_prompts, n_new, counters)
        gr = first_spec["repetitive"]
        require(er["streams"] == gr["streams"]
                and er["spec_stats"] == gr["spec_stats"]
                and er["launches"] == gr["launches"],
                f"spec {what}: the eager serve differs from the graphed "
                f"one: {er['spec_stats']} / {gr['spec_stats']}, launches "
                f"{er['launches']} / {gr['launches']}")
        res["eager"] = {"wall_s": er["wall_s"], "tokens_per_s":
                        er["tokens_per_s"], "spec_stats": er["spec_stats"]}
        report(f"spec {what}: the eager serve (cuda_graphs=False) gives the "
               f"graphed serve's streams, launches and spec_stats "
               f"({er['wall_s']:.3f} s eager)")
        del eager
        if kind == "paged":
            pool = engines["spec"].pool
            require(pool.used_pages == 0 and pool.committed == 0,
                    f"spec {what}: {pool.used_pages} pages used, "
                    f"{pool.committed} committed after the serves")
        if kind != "ssm":
            res["index_check"] = spec_index_check(what, engines["spec"],
                                                  cfg, report)
        res["profile"] = spec_profile(what, engines["spec"],
                                      engines["plain"], prompts, groups,
                                      report)
        out[label] = res
        del engines
        gc.collect()
    if cfg.ssm is not None:
        out["restore_check"] = spec_restore_check(cfg, params, dev, report)
    out["phase_s"] = time.perf_counter() - t_phase
    report(f"spec {cfg.name}: phase 10 part took {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 11: the hybrid family, recurrentgemma-2b (RG-LRU recurrence and a
# ring of the last 2048 keys per attention layer) at full width
HYBRID = "recurrentgemma-2b"
HYBRID_WINDOW = 2048
# the ring-wrap check's prompt: longer than the window, so B2's window
# binds in the monolithic prefill and the 16-token chunks wrap the ring;
# its cache row (the ring is O(window): the row's length costs nothing)
RING_PROMPT = 2100
RING_MAX_LEN = 2112
RING_STEPS = 8
# ring-wrap logits, monolithic against chunked, relative to the largest
# logit (the logits are bf16 products cast to fp32: an absolute 2e-2 is
# below one bf16 ulp at the largest logits of a 256,000-word vocabulary)
RING_RTOL = 2e-2


def hybrid_launches(cfg, monolithic: int = 0):
    """Every forward pass (a decode step, a prefill chunk, a monolithic
    prefill) runs each layer's three MLP GEMMs through B1; attention runs
    over the ring in plain ops, except in a monolithic prefill, which runs
    B2 once per attention layer; B3 and B4 never run.  ``monolithic``:
    the serve's monolithic admissions."""
    from repro_torch.core.profiles import block_kinds
    n = cfg.num_layers
    attn = sum(k == "attn_local" for k in block_kinds(cfg))

    def expected(decode_steps, chunks):
        passes = decode_steps + len(chunks) + monolithic
        return ({"block_matmul": 3 * n * passes,
                 "flash_attention": attn * monolithic,
                 "flash_attention_paged": 0, "ssd_scan": 0},
                {"block_matmul": f"{3 * n} per forward pass x {passes} "
                 f"passes = {decode_steps} decode steps + {len(chunks)} "
                 f"prefill chunks + {monolithic} monolithic prefills",
                 "flash_attention": f"{attn} per monolithic prefill x "
                 f"{monolithic}; the ring's attention runs in plain ops",
                 "flash_attention_paged": "no pageable leaf",
                 "ssd_scan": "no SSD layer"})
    return expected


def _clone(tree):
    from repro_torch.models.params import tree_map_with_path
    return tree_map_with_path(lambda _, a: a.clone(), tree)


def hybrid_ring_check(cfg, params, dev, report) -> dict:
    """One RING_PROMPT-token prompt through the model in a RING_MAX_LEN
    row: once as a monolithic prefill (B2 with the 2048-token window
    binding, then the ring filled with the last 2048 keys), once as
    16-token chunks (the ring wraps); RING_STEPS greedy decode steps
    follow from each, fed the monolithic side's tokens.  Logits within
    RING_RTOL of the largest, the greedy tokens equal where the
    monolithic side's top two are more than two bf16 ulps apart, the ring
    positions equal."""
    import numpy as np
    import torch
    from repro_torch.core.profiles import block_kinds
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.model import Model
    from repro_torch.models.params import tree_leaves_with_path

    model = Model(cfg)
    rng = np.random.default_rng(12)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, RING_PROMPT),
                             device=dev)
    t0 = time.perf_counter()
    mono = model.init_cache(1, RING_MAX_LEN, dev)
    b2 = fa.launch_count()
    lg_mono, _ = model.prefill(params, {"tokens": prompt[None]}, mono)
    torch.cuda.synchronize()
    b2 = fa.launch_count() - b2
    mono_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    chunked = model.init_cache(1, RING_MAX_LEN, dev)
    for start in range(0, RING_PROMPT, 16):
        valid = min(16, RING_PROMPT - start)
        toks = torch.zeros((1, 16), dtype=torch.int64, device=dev)
        toks[0, :valid] = prompt[start:start + valid]
        lg_chunk, _ = model.prefill_chunk(params, {"tokens": toks}, chunked,
                                          start, valid)
    torch.cuda.synchronize()
    chunk_s = time.perf_counter() - t0
    require(b2 == sum(k == "attn_local" for k in block_kinds(cfg)),
            f"ring check: {b2} flash_attention launches in the monolithic "
            "prefill")
    rel, unclear, tokens = [], 0, []
    lgs = [lg_mono[0].float(), lg_chunk[0].float()]
    for step in range(RING_STEPS + 1):
        top2 = lgs[0].topk(2).values.tolist()
        scale = lgs[0].abs().max().item()
        rel.append((lgs[0] - lgs[1]).abs().max().item() / scale)
        tok = int(lgs[0].argmax())
        clear = top2[0] - top2[1] > 2 * bf16_ulp(top2[0])
        unclear += not clear
        require(not clear or int(lgs[1].argmax()) == tok,
                f"ring check step {step}: monolithic token {tok}, chunked "
                f"{int(lgs[1].argmax())}, top two {top2}")
        tokens.append(tok)
        if step == RING_STEPS:
            break
        pos = torch.tensor([RING_PROMPT + step], device=dev)
        nxt = torch.tensor([tok], device=dev)
        lgs = [model.decode_step(params, {"tokens": nxt}, c, pos)[0][0]
               .float() for c in (mono, chunked)]
    torch.cuda.synchronize()
    same_pos = all(torch.equal(a, b) for (p, a), (_, b) in zip(
        tree_leaves_with_path(mono), tree_leaves_with_path(chunked))
        if p[-1] == "pos")
    require(same_pos, "ring check: the ring positions differ")
    require(max(rel) <= RING_RTOL, f"ring check: logits differ by "
            f"{max(rel):.4g} of the largest logit (tolerance {RING_RTOL})")
    report(f"hybrid ring check: a {RING_PROMPT}-token prompt in a "
           f"{RING_MAX_LEN}-token row, monolithic ({b2} flash_attention "
           f"launches, window {cfg.rglru.window_size} binding; {mono_s:.2f} s) "
           f"against {-(-RING_PROMPT // 16)} 16-token chunks (the ring "
           f"wraps; {chunk_s:.2f} s), then {RING_STEPS} decode steps: max "
           f"|diff| / max |logit| per step "
           f"{[round(r, 5) for r in rel]} (tolerance {RING_RTOL}), tokens "
           f"equal ({unclear} steps within two bf16 ulps at the top), ring "
           "positions equal")
    return {"rel_diff": rel, "tokens": tokens, "unclear_steps": unclear,
            "flash_attention_launches": b2, "monolithic_s": mono_s,
            "chunked_s": chunk_s}


def whole_model_check_hybrid(cfg, params, prompt, dev, report) -> dict:
    """Kernels against plain versions on the same weights: a monolithic
    prefill of ``prompt`` (B2 and B1), a decode step after it, and a
    16-token chunk on top (B1; the ring in plain ops on both sides)."""
    import torch
    from repro_torch.models.model import Model

    kern, plain = Model(cfg), Model(cfg, use_kernels=False)
    toks = torch.as_tensor(prompt, dtype=torch.int64, device=dev)[None]
    n = toks.shape[1]
    rows = {m: m.init_cache(1, MAX_LEN, dev) for m in (kern, plain)}
    lg = {"monolithic prefill": {
        m: m.prefill(params, {"tokens": toks}, rows[m])[0]
        for m in (kern, plain)}}
    nxt = lg["monolithic prefill"][plain].argmax(dim=-1)
    pos = torch.tensor([n], device=dev)
    lg["decode step"] = {m: m.decode_step(params, {"tokens": nxt}, rows[m],
                                          pos)[0] for m in (kern, plain)}
    chunk = toks[:, :16]
    lg["prefill chunk"] = {m: m.prefill_chunk(params, {"tokens": chunk},
                                              rows[m], n + 1, 16)[0]
                           for m in (kern, plain)}
    results = {}
    for name, pair in lg.items():
        diff = (pair[kern] - pair[plain]).abs().max().item()
        scale = pair[plain].abs().max().item()
        same_top = bool((pair[kern].argmax(-1)
                         == pair[plain].argmax(-1)).all())
        results[name] = {"max_abs_diff": diff, "max_abs_logit": scale,
                         "same_argmax": same_top}
        report(f"whole model {cfg.name} {name}: max |kernels - plain| "
               f"{diff:.4g} (max |logit| {scale:.4g}, tolerance "
               f"{LOGIT_RTOL} x max |logit|), same argmax: {same_top}")
        require(diff <= LOGIT_RTOL * scale,
                f"whole-model {cfg.name} {name} logits drift {diff:.4g}")
    return results


def _hybrid_mixer(model, kind, p, xa, positions, cache, t, live, valid_len):
    """One hybrid layer's mixer (the RG-LRU block or the ring attention)
    on ``xa``, updating ``cache`` in place."""
    from repro_torch.models import rglru as R
    if kind == "rec":
        return R.recurrent_block(p["mixer"], xa, cfg=model.cfg, cache=cache,
                                 valid_len=valid_len, live=live)
    return model._windowed_attention(p["attn"], xa, positions=positions,
                                     cache=cache, t=t, live=live,
                                     valid_len=valid_len)


def hybrid_restore_check(cfg, params, dev, report) -> dict:
    """The hybrid's restore pass on the card, four rows prefilled with 16
    random tokens, budgets 0, 1, 3 and d + 1 (drafts are the verify's own
    continuation, so each row emits its budget).

    The model's verify: B1 launches 3 x layers x 2 times (pass 1 and the
    restore pass) and B2 none; the row that emits nothing keeps every
    leaf bit for bit.  Its state against plain decode steps is reported,
    not gated (the two paths' residual streams part by bf16 roundings,
    which the layers carry on).

    Layer by layer on the plain path's residual stream (both paths given
    the same input): pass 1 writes nothing; the restore pass against
    ``n_emit`` single steps: RG-LRU state h within STATE_RTOL of its
    largest entry, conv state and ring keys and values within two bf16
    ulps, ring positions equal; the row at 0 bit-equal to the state
    carried in."""
    import numpy as np
    import torch
    from repro_torch.kernels import block_matmul as bm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers as L
    from repro_torch.models.model import Model, cache_batch_axis
    from repro_torch.models.params import tree_leaves_with_path

    model = Model(cfg)
    rng = np.random.default_rng(6)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 16)),
                           device=dev)
    cache = model.init_cache(4, MAX_LEN, dev)
    logits, _ = model.prefill_chunk(params, {"tokens": toks}, cache, 0, 16)
    first = logits.argmax(-1)
    pos = torch.full((4,), 16, dtype=torch.int64, device=dev)
    full = torch.full_like(pos, SPEC_DEPTH + 1)
    drafts = torch.zeros((4, SPEC_DEPTH), dtype=torch.int64, device=dev)
    for _ in range(SPEC_DEPTH + 1):
        block, _, accepted, _, _ = model.verify_quantum(
            params, first, drafts, _clone(cache), pos, full)
        drafts = block.T[:, :SPEC_DEPTH].contiguous()
    require(accepted.tolist() == [SPEC_DEPTH] * 4, f"hybrid restore "
            f"check: the verify's own continuation accepted "
            f"{accepted.tolist()}")
    budget = torch.tensor([0, 1, 3, SPEC_DEPTH + 1], device=dev)
    spec = _clone(cache)
    b1, b2 = bm.launch_count(), fa.launch_count()
    _, n_emit, _, _, _ = model.verify_quantum(params, first, drafts, spec,
                                              pos, budget)
    torch.cuda.synchronize()
    b1, b2 = bm.launch_count() - b1, fa.launch_count() - b2
    require(b1 == 2 * 3 * cfg.num_layers and b2 == 0, f"hybrid restore "
            f"check: {b1} block_matmul and {b2} flash_attention launches "
            "for one verify")
    require(torch.equal(n_emit, budget), f"hybrid restore check: emitted "
            f"{n_emit.tolist()}, budgets {budget.tolist()}")
    seq = torch.cat([first[:, None], drafts], dim=1)
    plain = _clone(cache)
    for j in range(SPEC_DEPTH + 1):
        model.decode_step(params, {"tokens": seq[:, j]}, plain, pos + j,
                          live=n_emit > j)
    torch.cuda.synchronize()
    whole = {}
    for path, got in tree_leaves_with_path(spec):
        ax = cache_batch_axis(path)
        start = dict(tree_leaves_with_path(cache))[path]
        require(torch.equal(got.select(ax, 0), start.select(ax, 0)),
                f"hybrid restore check: the row that emitted nothing "
                f"changed {'/'.join(path)}")
        if path[-1] != "pos":
            want = dict(tree_leaves_with_path(plain))[path].float()
            kind = path[-1]
            whole[kind] = max(whole.get(kind, 0.0), (
                (got.float() - want).abs().max()
                / want.abs().max().clamp_min(1e-30)).item())
    # layer by layer, both paths on the plain path's residual stream
    s = SPEC_DEPTH + 1
    x = L.embed(params["embed"], seq, cfg)
    positions = model._default_positions(4, s, pos, dev)
    none = torch.zeros(4, dtype=torch.bool, device=dev)
    worst = {"h": 0.0, "conv": 0.0, "k": 0.0, "v": 0.0}
    for i, (kind, p, c) in enumerate(model._plan_blocks(params, cache)):
        xa = L.apply_norm(p["ln1"], x, cfg.norm_type)
        restored = _clone(c)
        _hybrid_mixer(model, kind, p, xa, positions, restored, pos, none, s)
        require(all(torch.equal(a, b) for (_, a), (_, b) in zip(
            tree_leaves_with_path(restored), tree_leaves_with_path(c))),
            f"hybrid restore check layer {i} ({kind}): pass 1 wrote state")
        _hybrid_mixer(model, kind, p, xa, positions, restored, pos,
                      n_emit > 0, n_emit)
        stepped, ys = _clone(c), []
        for j in range(s):
            ys.append(_hybrid_mixer(model, kind, p, xa[:, j:j + 1],
                                    positions[:, j:j + 1], stepped, pos + j,
                                    n_emit > j, None))
        torch.cuda.synchronize()
        for (name, a), (_, b), (_, c0) in zip(
                tree_leaves_with_path(restored),
                tree_leaves_with_path(stepped), tree_leaves_with_path(c)):
            name = name[-1]
            require(torch.equal(a[0], c0[0]), f"hybrid restore check layer "
                    f"{i} ({kind}): the row that emitted nothing changed "
                    f"its {name}")
            if name == "pos":
                require(torch.equal(a, b), f"hybrid restore check layer "
                        f"{i}: ring positions differ from single steps")
                continue
            a, b = a.float(), b.float()
            diff = (a - b).abs()
            ok = (bool(diff.max() <= STATE_RTOL * b.abs().max())
                  if name == "h" else
                  bool((diff <= ATOL + RTOL * b.abs()).all()))
            rel = (diff.max() / b.abs().max().clamp_min(1e-30)).item()
            worst[name] = max(worst[name], rel)
            require(ok, f"hybrid restore check layer {i} ({kind}): {name} "
                    f"after the restore pass differs from "
                    f"{n_emit.tolist()} single steps by {rel:.4g} of its "
                    "largest entry")
        x = x + torch.cat(ys, dim=1)
        x = x + L.apply_mlp(p["mlp"], L.apply_norm(p["ln2"], x,
                                                   cfg.norm_type),
                            cfg.activation)
    report(f"hybrid restore check: a verify emitting {n_emit.tolist()} "
           f"tokens ({b1} block_matmul, {b2} flash_attention launches); the "
           "row that emits nothing keeps every leaf bit for bit; layer by "
           "layer on one residual stream, pass 1 writes nothing and the "
           "restore pass against single steps: max |diff| / max |state| h "
           f"{worst['h']:.4g} (tolerance {STATE_RTOL}), conv "
           f"{worst['conv']:.4g}, ring k {worst['k']:.4g}, v "
           f"{worst['v']:.4g} (two bf16 ulps), ring positions equal; whole "
           "model against single steps (not gated: the residual streams "
           "part): " + ", ".join(f"{k} {v:.4g}" for k, v in
                                 sorted(whole.items())))
    return {"n_emit": n_emit.tolist(), "layers": worst, "model": whole}


def hybrid_spec(cfg, params, plain, prompts, dev, report, seed,
                counters) -> dict:
    """A graphed speculative engine (depth SPEC_DEPTH) against the graphed
    plain engine ``plain`` on the repetitive arm (constant-token prompts,
    SPEC_REP_NEW new tokens), one serve each: exact launches (B1 3 x layers
    per plain step and chunk, twice that per verify; B2, B3, B4 none),
    streams equal or parting at two-ulp ties, verifies, acceptances and
    rollbacks all above 0.  When constant prompts draft nothing, echo
    prompts s + g + s (g the plain engine's continuation of s) are served
    too, as phase 10 does for mamba2."""
    import numpy as np
    rng = np.random.default_rng(seed + 10)
    spec = spec_engine(cfg, params, dev, report)
    arms = {"repetitive": [np.full(n, int(rng.integers(cfg.vocab_size)),
                                   np.int32) for n in SPEC_REP_LENS]}
    n = cfg.num_layers
    out = {"arms": {}}
    totals = collections.Counter()
    for arm in ("repetitive", "echo"):
        if arm == "echo":
            if all(totals[k] > 0 for k in ("spec_quanta", "tokens_accepted",
                                            "spec_rollbacks")):
                break
            seeds = [rng.integers(0, cfg.vocab_size, m).astype(np.int32)
                     for m in SPEC_ECHO_LENS]
            cont = spec_serve(plain, seeds, SPEC_REP_NEW + SPEC_DEPTH, {})
            arms["echo"] = [np.concatenate([s_, np.asarray(g, np.int32),
                                            s_])
                            for s_, g in zip(seeds, cont["streams"])]
        runs = {which: spec_serve(eng, arms[arm], SPEC_REP_NEW, counters)
                for which, eng in (("plain", plain), ("spec", spec))}
        for which, r in runs.items():
            passes = r["decode_steps"] + len(r["chunks"])
            want = {"block_matmul": 3 * n * (passes + 2 * r["verifies"]),
                    "flash_attention": 0, "flash_attention_paged": 0,
                    "ssd_scan": 0}
            require(r["launches"] == want, f"hybrid spec {arm} {which}: "
                    f"launches {r['launches']}, expected {want}")
        st = runs["spec"]["spec_stats"]
        for key in ("spec_quanta", "tokens_accepted", "spec_rollbacks"):
            totals[key] += st[key]
        parted = spec_partings(f"{cfg.name} {arm}", cfg, params, arms[arm],
                               runs["spec"]["streams"],
                               runs["plain"]["streams"], dev, report)
        out["arms"][arm] = {
            "partings": len(parted), "parted": parted,
            "spec_stats": st, "verifies": runs["spec"]["verifies"],
            "wall_s": {k: r["wall_s"] for k, r in runs.items()},
            "tokens_per_s": {k: r["tokens_per_s"] for k, r in runs.items()},
            "launches": {k: r["launches"] for k, r in runs.items()}}
        report(f"spec {cfg.name} {arm} ({len(arms[arm])} requests x "
               f"{SPEC_REP_NEW + 1} tokens, one serve each): plain "
               f"{runs['plain']['wall_s']:.3f} s, spec "
               f"{runs['spec']['wall_s']:.3f} s; {st['spec_quanta']} "
               f"verifies and {st['spec_fallbacks']} fallbacks, draft hit "
               f"rate {st['draft_hit_rate']:.3f} ({st['tokens_accepted']} of "
               f"{st['tokens_drafted']}), {st['spec_rollbacks']} rollbacks; "
               f"launches {runs['spec']['launches']} (exact)")
    require(all(totals[k] > 0 for k in ("spec_quanta", "tokens_accepted",
                                        "spec_rollbacks")),
            f"hybrid spec: over the arms {dict(totals)}: verifies, "
            "acceptances and rollbacks must all run")
    out["totals"] = dict(totals)
    del spec
    gc.collect()
    return out


def serve_hybrid(dev, counters, report, seed) -> dict:
    """Phase 11 (see the module docstring).  Each check that fails is
    reported and the phase goes on with the checks that do not depend on
    it; the phase fails at its end if any did."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import cost_model as cm
    from repro_torch.core.profiles import block_kinds
    from repro_torch.models.model import Model

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(HYBRID),
                              num_layers=EARLY_LAYERS[HYBRID])
    require(torch.backends.cuda.matmul.allow_tf32 is False,
            "TF32 is on: the RG-LRU gates' fp32 products must not use it")
    t0 = time.perf_counter()
    params = Model(cfg).init(torch.Generator(device=dev).manual_seed(seed),
                             dev)
    torch.cuda.synchronize()
    rg = cfg.rglru
    report(f"{HYBRID}: {cfg.num_layers} layers {block_kinds(cfg)[:3]} x "
           f"{cfg.num_layers // 3} + {block_kinds(cfg)[-2:]}, d_model "
           f"{cfg.d_model}, lru_width {rg.lru_width}, {cfg.num_heads} heads "
           f"over {cfg.num_kv_heads} KV head of {cfg.head_dim}, window "
           f"{rg.window_size}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; "
           f"weights made on the card in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(seed + 11)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPT_LENS]
    warm = {"levels": [cm.grid_point(i) for i in SPEC_LEVELS],
            "quantum_buckets": SPEC_BUCKETS}
    # B1 and B2, then what runs outside the port's kernels by family:
    # cuBLAS's bf16 products (the projections, the unembedding), its fp32
    # ones (the RG-LRU gates' block-diagonal products, the ring's scores
    # and context), PyTorch's elementwise, concatenation and reduction
    # kernels
    groups = {"block_matmul": "block_matmul_kernel",
              "flash_attention": "flash_attention_kernel",
              "cublas bf16": "nvjet", "cublas fp32": "gemmSN",
              "elementwise": "elementwise_kernel",
              "cat": "CatArrayBatchedCopy", "reduce": "reduce_kernel"}
    out: dict = {"failures": [], "seconds": {}}

    def attempt(name, fn):
        t = time.perf_counter()
        try:
            return fn()
        except SmokeFailure as e:
            out["failures"].append(f"{name}: {e}")
            report(f"hybrid {name} FAILED: {e}")
            return None
        finally:
            out["seconds"][name] = time.perf_counter() - t

    expected = hybrid_launches(cfg)
    eager = attempt("eager serve", lambda: serve(
        cfg, params, prompts, dev, report, counters, expected,
        engine_kw={"cuda_graphs": False}, warmup_kw=warm))
    graphed = attempt("graphed serve", lambda: serve(
        cfg, params, prompts, dev, report, counters, expected,
        warmup_kw=warm))
    engine = graphed[0] if graphed else None
    if graphed:
        out["serve"] = graphed[1]
    if eager and graphed:
        out["eager"] = eager[1]
        attempt("eager against graphed", lambda: same_streams(
            HYBRID, graphed[1], eager[1], report))
    del eager
    mono = attempt("monolithic serve", lambda: serve(
        cfg, params, prompts, dev, report, counters,
        hybrid_launches(cfg, monolithic=len(prompts)),
        engine_kw={"cuda_graphs": False, "chunked_prefill": False},
        warmup_kw={**warm, "prompt_lens": PROMPT_LENS}))
    if mono:
        out["monolithic"] = mono[1]
        if graphed:
            parted = attempt("monolithic against chunked", lambda:
                             spec_partings(
                                 f"{HYBRID} monolithic", cfg, params,
                                 prompts, mono[1]["streams"],
                                 graphed[1]["streams"], dev, report,
                                 label="hybrid",
                                 other="the chunked serve's"))
            out["monolithic_partings"] = parted
    del mono
    gc.collect()
    out["ring"] = attempt("ring check", lambda: hybrid_ring_check(
        cfg, params, dev, report))
    out["whole_model"] = attempt("whole model", lambda:
                                 whole_model_check_hybrid(
                                     cfg, params, prompts[3], dev, report))
    out["restore"] = attempt("restore check", lambda: hybrid_restore_check(
        cfg, params, dev, report))
    if engine is not None:
        out["spec"] = attempt("spec", lambda: hybrid_spec(
            cfg, params, engine, prompts, dev, report, seed, counters))
        out["profile_chunk"] = attempt("chunk profile", lambda:
                                       profile_prefill_chunk(
                                           engine, prompts[1], report,
                                           groups))
        out["profile_quantum"] = attempt("quantum profile", lambda:
                                         profile_quantum(engine, prompts,
                                                         report, groups))
    del engine, graphed, params
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    report(f"hybrid: phase 11 took {out['phase_s']:.1f} s ("
           + ", ".join(f"{k} {v:.1f}" for k, v in out["seconds"].items())
           + ")")
    require(not out["failures"], "phase 11: " + "; ".join(out["failures"]))
    return out


# ---------------------------------------------------------------------------
# Phase 12: the moe family, deepseek-v2-lite-16b (MLA latent cache, capacity
# MoE with 64 routed and 2 shared experts, a dense first layer) at its
# published widths and 5 of its 27 layers (EARLY_LAYERS: pro_0 and 4
# moe_ds blocks)
MOE = "deepseek-v2-lite-16b"
# the whole-model check: where the kernels' and the plain path's logits
# drift past LOGIT_RTOL, the drift is put down to a router decision only
# if the first layer whose top-k choice differs has that token's k-th and
# (k+1)-th probabilities (plain side) within ROUTER_TIE.  Set from the
# readings: first flips at gaps of 7.5e-5 to 1.06e-3 over four runs (the
# ulp-level drift of B1 against its plain version, carried through up to
# four layers before a router flips), ten times the largest
ROUTER_TIE = 1e-2


def moe_launches(cfg, monolithic: int = 0):
    """Every forward pass (a decode step, a prefill chunk, a monolithic
    prefill, a verify) runs the three MLP GEMMs of each dense layer
    (``ds_dense0``) and of each ``moe_ds`` block's shared experts through
    B1: 15 a pass at deepseek-v2-lite-16b's 5 layers (81 at all 27; and
    at its MoE-free clone's).  MLA runs in plain ops (no B2; no B3 on a paged cache,
    where the latents are gathered through the page table), the routed
    experts in PyTorch products, and B4 never.  ``monolithic``: the
    serve's monolithic admissions."""
    dense = cfg.first_dense_layers
    shared = (cfg.num_layers - dense) * bool(cfg.moe.num_shared_experts)
    per = 3 * (dense + shared)

    def expected(decode_steps, chunks, verifies=0):
        passes = decode_steps + len(chunks) + monolithic + verifies
        return ({"block_matmul": per * passes, "flash_attention": 0,
                 "flash_attention_paged": 0, "ssd_scan": 0},
                {"block_matmul": f"{per} per forward pass x {passes} "
                 f"passes = {decode_steps} decode steps + {len(chunks)} "
                 f"prefill chunks + {monolithic} monolithic prefills + "
                 f"{verifies} verifies",
                 "flash_attention": "MLA runs in plain ops",
                 "flash_attention_paged": "paged MLA gathers its latents "
                 "in plain ops",
                 "ssd_scan": "no SSD layer"})
    return expected


def mla_only(cfg):
    """The MoE-free clone of deepseek (the reference's ``_mla_only``):
    every layer ``ds_dense0``, MLA and a dense MLP of d_ff 10944, at the
    same widths and depth; no router can flip."""
    return dataclasses.replace(cfg, name=cfg.name + "-mla-only",
                               first_dense_layers=cfg.num_layers)


def stream_partings(got, want) -> list:
    """(request, first differing token) of each stream of ``got`` that
    differs from ``want``'s."""
    return [(rid, next((i for i, (a, b) in enumerate(zip(g, w)) if a != b),
                       min(len(g), len(w))))
            for rid, (g, w) in enumerate(zip(got, want)) if g != w]


class RouterLog:
    """Records every routing of ``repro_torch.models.moe`` (probabilities
    and chosen experts per token) while it is active."""

    def __enter__(self):
        from repro_torch.models import moe as moe_mod
        self.mod, self.real, self.calls = moe_mod, moe_mod.route_tokens, []

        def recording(params, xg, moe):
            out = self.real(params, xg, moe)
            self.calls.append((out[0].float(), out[1].argmax(-1),
                               xg.float()))
            return out
        moe_mod.route_tokens = recording
        return self

    def __exit__(self, *exc):
        self.mod.route_tokens = self.real


def router_flips(kern: RouterLog, plain: RouterLog, k: int) -> list:
    """Each (call, token) whose chosen expert set differs between the two
    runs, in layer order, with the plain side's gap between its k-th and
    (k+1)-th probabilities."""
    import torch
    flips = []
    for layer, ((_, ki, _), (pp, pi, _)) in enumerate(zip(kern.calls,
                                                          plain.calls)):
        diff = (torch.sort(ki, -1).values != torch.sort(pi, -1).values)
        for g, t in diff.any(-1).nonzero().tolist():
            top = torch.sort(pp[g, t], descending=True).values
            flips.append({"layer": layer, "token": t,
                          "gap": (top[k - 1] - top[k]).item()})
    return flips


def whole_model_check_moe(cfg, params, prompt, dev, report) -> dict:
    """Kernels against plain versions on the same weights: a 16-token
    chunk of ``prompt``, a decode step after it, and a monolithic prefill
    of all of ``prompt``.  Logits within LOGIT_RTOL of the largest; each
    router decision that differs between the two paths is reported
    (layer, token, the plain side's probability gap), and a drift past
    the tolerance passes only if its first flip is within ROUTER_TIE.  The
    decode step reads the cache the chunk wrote on its own path, so its
    first flip is the chunk's first, where the chunk has one."""
    import torch
    from repro_torch.models.model import Model

    kern, plain = Model(cfg), Model(cfg, use_kernels=False)
    toks = torch.as_tensor(prompt, dtype=torch.int64, device=dev)[None]
    n = toks.shape[1]
    rows = {m: m.init_cache(1, MAX_LEN, dev) for m in (kern, plain)}
    lg, logs = {}, {}

    def run(name, fn):
        lg[name], logs[name] = {}, {}
        for m in (kern, plain):
            with RouterLog() as log:
                lg[name][m] = fn(m)[0].float()
            logs[name][m] = log
    run("prefill chunk", lambda m: m.prefill_chunk(
        params, {"tokens": toks[:, :16]}, rows[m], 0, 16))
    nxt = lg["prefill chunk"][plain].argmax(dim=-1)
    run("decode step", lambda m: m.decode_step(
        params, {"tokens": nxt}, rows[m], torch.tensor([16], device=dev)))
    fresh = {m: m.init_cache(1, MAX_LEN, dev) for m in (kern, plain)}
    run("monolithic prefill", lambda m: m.prefill(params, {"tokens": toks},
                                                  fresh[m]))
    results = {}
    fed_by = {"decode step": "prefill chunk"}
    for name, pair in lg.items():
        diff = (pair[kern] - pair[plain]).abs().max().item()
        scale = pair[plain].abs().max().item()
        same_top = bool((pair[kern].argmax(-1)
                         == pair[plain].argmax(-1)).all())
        flips = router_flips(logs[name][kern], logs[name][plain],
                             cfg.moe.top_k)
        # the run whose cache this one reads: its flips come first
        upstream = results.get(fed_by.get(name), {}).get("router_flips", [])
        # the routers' inputs on the two paths, layer by layer, up to the
        # first layer that flips: the kernels' own drift
        upto = flips[0]["layer"] + 1 if flips else None
        drift = [((a[2] - b[2]).abs().max()
                  / b[2].abs().max().clamp_min(1e-30)).item()
                 for a, b in zip(logs[name][kern].calls[:upto],
                                 logs[name][plain].calls[:upto])]
        results[name] = {"max_abs_diff": diff, "max_abs_logit": scale,
                         "same_argmax": same_top, "router_flips": flips,
                         "router_input_drift": drift}
        first = [(f["layer"], f["token"], round(f["gap"], 6))
                 for f in flips[:8]]
        report(f"whole model {cfg.name} {name}"
               f"{f' ({n} tokens)' if 'monolithic' in name else ''}: max "
               f"|kernels - plain| {diff:.4g} (max |logit| {scale:.4g}, "
               f"tolerance {LOGIT_RTOL} x max |logit|), same argmax: "
               f"{same_top}; {len(flips)} router decisions differ, the "
               f"first (layer, token, probability gap): {first}; the "
               f"routers' inputs up to the first flip differ by at most "
               f"{max(drift, default=0.0):.4g} of their largest entry")
        first = (upstream or flips)[:1]
        if upstream:
            report(f"whole model {cfg.name} {name}: reads the "
                   f"{fed_by[name]}'s cache, whose first router flip "
                   f"(layer, token, gap) is ({first[0]['layer']}, "
                   f"{first[0]['token']}, {first[0]['gap']:.6g})")
        if diff > LOGIT_RTOL * scale:
            require(bool(first) and first[0]["gap"] <= ROUTER_TIE,
                    f"whole-model {cfg.name} {name} logits drift "
                    f"{diff:.4g} without a router flip at a near tie "
                    f"(first flip {first})")
    return results


def moe_layer_times(cfg, params, dev, report) -> dict:
    """One decode step's routed-expert layers alone: every stacked MoE
    block's ``capacity_moe`` on 4 rows (one routing group of 4 tokens,
    capacity 1), CUDA-event timed over 20 runs after a warm one, against
    the bytes the reference's formulation reads (every expert's three
    matrices, the router) and the bytes the routed experts alone would
    read."""
    import torch
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.model import Model, _layer

    moe = cfg.moe
    x = torch.randn(BATCH_SLOTS, 1, cfg.d_model, device=dev).bfloat16()
    plan = Model(cfg).plan
    n = plan.n_groups
    layers = [_layer(params["blocks"][plan.scan_kinds[0]]["moe"], i)
              for i in range(n)]

    def step():
        for p in layers:
            moe_mod.capacity_moe(p, x, cfg, moe)
    step()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0.record()
    for _ in range(20):
        step()
    t1.record()
    torch.cuda.synchronize()
    ms = t0.elapsed_time(t1) / 20
    per_expert = 3 * cfg.d_model * moe.expert_d_ff * 2
    all_bytes = n * (moe.num_experts * per_expert
                     + cfg.d_model * moe.num_experts * 4)
    routed = min(moe.num_experts, BATCH_SLOTS * moe.top_k)
    routed_bytes = n * (routed * per_expert
                        + cfg.d_model * moe.num_experts * 4)
    out = {"ms": ms, "bytes_all_experts": all_bytes,
           "bound_ms_all_experts": all_bytes / HBM_BYTES_PER_S * 1e3,
           "bytes_routed": routed_bytes,
           "bound_ms_routed": routed_bytes / HBM_BYTES_PER_S * 1e3}
    report(f"time {cfg.name} routed experts, one decode step ({n} layers, "
           f"{BATCH_SLOTS} rows, capacity 1): {ms:.3f} ms (eager, CUDA "
           f"events over 20 steps); bound {out['bound_ms_all_experts']:.3f}"
           f" ms for the {all_bytes / 1e9:.2f} GB every expert's weights "
           f"take (the reference's formulation), "
           f"{out['bound_ms_routed']:.3f} ms for at most {routed} routed "
           f"experts a layer ({routed_bytes / 1e9:.2f} GB)")
    return out


def serve_mla_clone(cfg, prompts, dev, report, counters, seed) -> dict:
    """The MLA cache machinery held strictly on the MoE-free clone at
    full width and depth (seeded weights made on the card, eager engines,
    the first BATCH_SLOTS prompts):
    paged streams (``page_size=PAGE_SIZE``, the same requests) equal the
    dense chunked streams; monolithic streams, and a speculative serve's
    (every quantum a verify of the last token's copies: rollbacks) equal
    them or part at ties within SPEC_TIE_ULPS, phase 10's rule; exact
    launches everywhere; the whole clone through the kernels against the
    plain versions within LOGIT_RTOL (no router can flip)."""
    import torch
    from repro_torch.core import cost_model as cm
    from repro_torch.models.model import Model

    clone = mla_only(cfg)
    prompts = prompts[:BATCH_SLOTS]
    t0 = time.perf_counter()
    params = Model(clone).init(torch.Generator(device=dev).manual_seed(seed),
                               dev)
    torch.cuda.synchronize()
    n_params = sum(a.numel() for a in _leaves(params))
    report(f"{clone.name}: {clone.num_layers} layers ds_dense0 (MLA, dense "
           f"MLP of {clone.first_dense_d_ff}), {n_params / 1e9:.3f} B "
           f"parameters made on the card in {time.perf_counter() - t0:.1f} s")
    # one level: every serve warms one version and runs the same tiles
    one = (SPEC_LEVELS[0],)
    warm = {"levels": [cm.grid_point(i) for i in one],
            "quantum_buckets": SPEC_BUCKETS}
    eager = {"cuda_graphs": False}
    out = {}
    _, dense = serve(clone, params, prompts, dev, report, counters,
                     moe_launches(clone), engine_kw=eager, warmup_kw=warm,
                     levels=one)
    want = dense["streams"]
    # the same requests on a paged engine: the same schedule and levels,
    # so every row runs the same kernels on the same latents
    eng, paged = serve(clone, params, prompts, dev, report, counters,
                       moe_launches(clone),
                       engine_kw={**eager, "page_size": PAGE_SIZE},
                       warmup_kw=warm, levels=one)
    stats = eng.page_stats
    require(stats["stalls"] == 0 and stats["used_pages"] == 0
            and stats["committed"] == 0,
            f"{clone.name} paged: the pool after the serve {stats}")
    paged["page_stats"] = stats
    del eng
    same = [a == b for a, b in zip(paged["streams"], want)]
    require(all(same), f"{clone.name}: {sum(same)} of {len(same)} paged "
            "streams equal the dense streams")
    report(f"{clone.name} paged: {sum(same)} of {len(same)} streams equal "
           f"the dense serve's (strict); pool {stats}")
    _, mono = serve(clone, params, prompts, dev, report, counters,
                    moe_launches(clone, monolithic=len(prompts)),
                    engine_kw={**eager, "chunked_prefill": False},
                    warmup_kw={**warm, "prompt_lens": PROMPT_LENS},
                    levels=one)
    out["monolithic_partings"] = spec_partings(
        f"{clone.name} monolithic", clone, params, prompts,
        mono["streams"], want, dev, report, label="mla clone",
        other="the chunked serve's")
    spec = spec_engine(clone, params, dev, report, graphs=False,
                       levels=one)
    spec.drafter = AlwaysDraft()
    run = spec_serve(spec, prompts, MAX_NEW, counters, levels=one)
    del spec
    want_l, why = moe_launches(clone)(run["decode_steps"], run["chunks"],
                                      run["verifies"])
    require(run["launches"] == want_l, f"{clone.name} spec: launches "
            f"{run['launches']}, expected {want_l} ({why['block_matmul']})")
    st = run["spec_stats"]
    require(run["verifies"] > 0 and st["spec_rollbacks"] > 0,
            f"{clone.name} spec: {run['verifies']} verifies, "
            f"{st['spec_rollbacks']} rollbacks")
    out["spec_partings"] = spec_partings(
        f"{clone.name} always-draft", clone, params, prompts,
        run["streams"], want, dev, report, label="mla clone spec")
    report(f"{clone.name} spec (every quantum a verify of the last token's "
           f"copies): {run['verifies']} verifies, hit rate "
           f"{st['draft_hit_rate']:.3f} ({st['tokens_accepted']} of "
           f"{st['tokens_drafted']}), {st['spec_rollbacks']} rollbacks; "
           f"launches {run['launches']} (exact)")
    # no router: the kernels against the plain versions at LOGIT_RTOL,
    # with no exception, through all of the clone's layers
    report(f"{clone.name}: the whole model, kernels against plain versions")
    out["whole_model"] = whole_model_check(clone, params, prompts[1], dev,
                                           report)
    out.update({"params": n_params, "dense": dense, "paged": paged,
                "monolithic": mono, "spec": {k: v for k, v in run.items()
                                             if k != "streams"}})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def serve_moe(dev, counters, report, seed) -> dict:
    """Phase 12 (see the module docstring).  Each check that fails is
    reported and the phase goes on with the checks that do not depend on
    it; the phase fails at its end if any did."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import cost_model as cm
    from repro_torch.models.model import Model

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(MOE), num_layers=EARLY_LAYERS[MOE])
    t0 = time.perf_counter()
    params = Model(cfg).init(torch.Generator(device=dev).manual_seed(seed),
                             dev)
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated()
    n_params = sum(a.numel() for a in _leaves(params))
    moe, mla = cfg.moe, cfg.mla
    report(f"{MOE}: {cfg.num_layers} layers (ds_dense0 + moe_ds x "
           f"{cfg.num_layers - cfg.first_dense_layers}), d_model "
           f"{cfg.d_model}, {cfg.num_heads} heads, MLA kv_lora_rank "
           f"{mla.kv_lora_rank} qk_nope {mla.qk_nope_head_dim} qk_rope "
           f"{mla.qk_rope_head_dim} v {mla.v_head_dim}, {moe.num_experts} "
           f"experts of {moe.expert_d_ff} top-{moe.top_k} (capacity factor "
           f"{moe.capacity_factor}) + shared {moe.shared_d_ff}, dense d_ff "
           f"{cfg.first_dense_d_ff}, vocab {cfg.vocab_size}: "
           f"{n_params / 1e9:.3f} B parameters made on the card in "
           f"{time.perf_counter() - t0:.1f} s (peak device memory "
           f"{init_peak / 2**30:.2f} GiB while they were made)")
    rng = np.random.default_rng(seed + 12)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPT_LENS]
    warm = {"levels": [cm.grid_point(i) for i in SPEC_LEVELS],
            "quantum_buckets": SPEC_BUCKETS}
    # B1, then what runs outside the port's kernels: cuBLAS's bf16
    # products (projections, the experts' batched products, the
    # unembedding) and fp32 ones (MLA's scores and context, the router),
    # PyTorch's elementwise, sort (top-k), concatenation, reduction and
    # indexing kernels
    groups = {"block_matmul": "block_matmul_kernel",
              "cublas bf16": "nvjet", "cublas fp32": "gemmSN",
              "cublas other": "gemm", "elementwise": "elementwise_kernel",
              "sort": "ort", "softmax": "oftmax",
              "cat": "CatArrayBatchedCopy", "reduce": "reduce_kernel",
              "index": "ndex"}
    out: dict = {"failures": [], "seconds": {}, "params": n_params,
                 "init_peak_bytes": init_peak}

    def attempt(name, fn):
        t = time.perf_counter()
        try:
            return fn()
        except SmokeFailure as e:
            out["failures"].append(f"{name}: {e}")
            report(f"moe {name} FAILED: {e}")
            return None
        finally:
            out["seconds"][name] = time.perf_counter() - t

    eager = attempt("eager serve", lambda: serve(
        cfg, params, prompts, dev, report, counters, moe_launches(cfg),
        engine_kw={"cuda_graphs": False}, warmup_kw=warm))
    graphed = attempt("graphed serve", lambda: serve(
        cfg, params, prompts, dev, report, counters, moe_launches(cfg),
        warmup_kw=warm))
    engine = graphed[0] if graphed else None
    if graphed:
        out["serve"] = graphed[1]
    if eager and graphed:
        out["eager"] = eager[1]
        attempt("eager against graphed", lambda: same_streams(
            MOE, graphed[1], eager[1], report))
    del eager
    # the eager monolithic and paged serves at one level: they check their
    # paths' launches and the pool, not the level switch
    one = (SPEC_LEVELS[0],)
    warm_one = {"levels": [cm.grid_point(i) for i in one],
                "quantum_buckets": SPEC_BUCKETS}
    mono = attempt("monolithic serve", lambda: serve(
        cfg, params, prompts[:BATCH_SLOTS], dev, report, counters,
        moe_launches(cfg, monolithic=BATCH_SLOTS),
        engine_kw={"cuda_graphs": False, "chunked_prefill": False},
        warmup_kw={**warm_one, "prompt_lens": PROMPT_LENS[:BATCH_SLOTS]},
        levels=one))
    if mono:
        out["monolithic"] = mono[1]
        if graphed:
            parted = stream_partings(mono[1]["streams"],
                                     graphed[1]["streams"])
            out["monolithic_partings"] = parted
            report(f"{MOE} monolithic: {BATCH_SLOTS - len(parted)} of "
                   f"{BATCH_SLOTS} streams equal the chunked serve's; "
                   f"(request, token) of each parting {parted} (not gated: "
                   "a monolithic prefill routes its prompt in one group, a "
                   "chunk in groups of 16, so capacity drops differ)")
    del mono
    gc.collect()

    def paged_serve():
        paged_prompts, order = sharing_prompts(prompts, cfg.vocab_size, seed)
        eng, res = serve(cfg, params, paged_prompts, dev, report, counters,
                         moe_launches(cfg),
                         engine_kw={"page_size": PAGE_SIZE,
                                    "cuda_graphs": False},
                         after={2: 0, 3: 0}, warmup_kw=warm_one, levels=one)
        check_paged_serve(eng, res, report)
        if graphed:
            same = [res["streams"][j] == graphed[1]["streams"][i]
                    for j, i in enumerate(order) if i is not None]
            res["streams_equal_to_dense"] = sum(same)
            report(f"{MOE} paged: {sum(same)} of {len(same)} streams equal "
                   "the dense serve's (not gated: the sharers change the "
                   "rows that route together)")
        return res
    out["paged"] = attempt("paged serve", paged_serve)
    gc.collect()
    out["whole_model"] = attempt("whole model", lambda: whole_model_check_moe(
        cfg, params, prompts[1], dev, report))
    out["moe_layers"] = attempt("routed experts timing", lambda:
                                moe_layer_times(cfg, params, dev, report))
    if engine is not None:

        def spec_arm():
            # random deepseek's greedy stream does not repeat: the n-gram
            # drafter drafts nothing on constant-token or echo prompts, so
            # the spec engine drafts d copies of each row's last token
            # every quantum (AlwaysDraft): the verify, its acceptances and
            # its rollbacks run on every quantum
            rep = [np.full(n, int(rng.integers(cfg.vocab_size)), np.int32)
                   for n in SPEC_REP_LENS]
            spec = spec_engine(cfg, params, dev, report, levels=one)
            spec.drafter = AlwaysDraft()
            runs = {w: spec_serve(e, rep, MAX_NEW, counters, levels=one)
                    for w, e in (("plain", engine), ("spec", spec))}
            del spec
            for w, r in runs.items():
                want, why = moe_launches(cfg)(r["decode_steps"], r["chunks"],
                                              r["verifies"])
                require(r["launches"] == want, f"{MOE} spec {w}: launches "
                        f"{r['launches']}, expected {want} "
                        f"({why['block_matmul']})")
            st = runs["spec"]["spec_stats"]
            parted = stream_partings(runs["spec"]["streams"],
                                     runs["plain"]["streams"])
            ratio = (runs["spec"]["tokens_per_s"]
                     / runs["plain"]["tokens_per_s"])
            report(f"spec {MOE} ({len(rep)} constant prompts of "
                   f"{list(SPEC_REP_LENS)} tokens x {MAX_NEW + 1} tokens, "
                   f"level {one[0]}, every quantum a verify of the last "
                   f"token's copies, one serve each): plain "
                   f"{runs['plain']['wall_s']:.3f} s "
                   f"({runs['plain']['tokens_per_s']:.1f} tokens/s), spec "
                   f"{runs['spec']['wall_s']:.3f} s "
                   f"({runs['spec']['tokens_per_s']:.1f} tokens/s, "
                   f"{ratio:.3f}x); "
                   f"{st['spec_quanta']} verifies and {st['spec_fallbacks']} "
                   f"fallbacks, draft hit rate {st['draft_hit_rate']:.3f} "
                   f"({st['tokens_accepted']} of {st['tokens_drafted']}), "
                   f"{st['spec_rollbacks']} rollbacks; launches "
                   f"{runs['spec']['launches']} (exact); {len(parted)} of "
                   f"{len(rep)} streams part from the plain serve's at "
                   f"(request, token) {parted} (not gated: a verify routes "
                   "20-token groups, a step 4-token groups)")
            require(st["spec_quanta"] > 0, f"{MOE} spec: no verify ran")
            return {"partings": parted, "spec_stats": st,
                    **{f"{w}_{k}": r[k] for w, r in runs.items()
                       for k in ("wall_s", "tokens_per_s", "verifies",
                                 "launches")}}
        out["spec"] = attempt("spec", spec_arm)
        # the profiles leave requests resident: last on this engine
        out["profile_chunk"] = attempt("chunk profile", lambda:
                                       profile_prefill_chunk(
                                           engine, prompts[1], report,
                                           groups))
        out["profile_quantum"] = attempt("quantum profile", lambda:
                                         profile_quantum(engine, prompts,
                                                         report, groups))
    del engine, graphed, params
    gc.collect()
    torch.cuda.empty_cache()
    out["clone"] = attempt("mla clone", lambda: serve_mla_clone(
        cfg, prompts, dev, report, counters, seed))
    serves = [r["max_memory_allocated"] for r in (
        out.get("serve"), out.get("eager"), out.get("monolithic"),
        out.get("paged")) if r]
    out["serve_peak_bytes"] = max(serves, default=None)
    out["phase_s"] = time.perf_counter() - t_phase
    report(f"moe: phase 12 took {out['phase_s']:.1f} s ("
           + ", ".join(f"{k} {v:.1f}" for k, v in out["seconds"].items())
           + f"); peak device memory {init_peak / 2**30:.2f} GiB while the "
           "weights were made, "
           + ("not measured" if not serves else
              f"{max(serves) / 2**30:.2f} GiB")
           + " in the deepseek serves")
    require(not out["failures"], "phase 12: " + "; ".join(out["failures"]))
    return out


# ---------------------------------------------------------------------------
# Phase 13: the remaining token configs (arctic-480b's dense-residual MoE,
# llama3-405b, minicpm-2b) at their published widths
LATE_ARCHS = ("arctic-480b", "llama3-405b", "minicpm-2b")
# the levels phase 13's serves cycle (0/9, two versions: at 0/5/9 the
# script ran past the 1,080 s it aimed at, minicpm-2b's 40 layers paying
# for each version in capture and eager warmup) and the one level of its
# single-version serves
LATE_LEVELS = (0, 9)
LATE_ONE = (0,)


def late_launches(cfg, paged: bool = False):
    """``dense_launches`` (or ``paged_launches``) as they are, with the
    kernels the path never runs expected at 0: B3 on a dense cache, B4
    (no SSD layer) always."""
    base = (paged_launches if paged else dense_launches)(cfg)

    def expected(decode_steps, chunks):
        want, why = base(decode_steps, chunks)
        want, why = dict(want), dict(why)
        for name, reason in (("flash_attention_paged", "a dense cache"),
                             ("ssd_scan", "no SSD layer")):
            want.setdefault(name, 0)
            why.setdefault(name, reason)
        return want, why
    return expected


def late_spec_launches(kind: str, cfg, run) -> dict:
    """``spec_expected`` with the kernels it leaves out at 0."""
    want = spec_expected(kind, cfg, run)
    return {name: want.get(name, 0) for name in
            ("block_matmul", "flash_attention", "flash_attention_paged",
             "ssd_scan")}


def late_spec_paged(cfg, params, dev, report, counters, seed, *,
                    plain=None) -> dict:
    """A speculative serve on a paged engine (llama3-405b in phase 13,
    musicgen-large in phase 14): constant-token prompts (SPEC_REP_LENS) on
    a plain and a speculative paged engine, graphed at one level (the
    plain one ``plain``, warm at LATE_ONE and SPEC_BUCKETS, or built
    here); where the n-gram drafts never roll back, the speculative
    engine drafts the last token's copies and serves again, and where
    those never roll back either, tokens the model does not pick.  Streams
    equal the plain engine's or part at two-ulp ties; verifies and
    rollbacks above 0; exact launches (B3 once a layer a verify: at
    llama3-405b's G 16, 80 rows, two row tiles); the pool empty after."""
    import numpy as np
    rng = np.random.default_rng(seed + 13)
    rep = [np.full(n, int(rng.integers(cfg.vocab_size)), np.int32)
           for n in SPEC_REP_LENS]
    paged = {"page_size": PAGE_SIZE}
    if plain is None:
        plain = spec_engine(cfg, params, dev, report, speculative=False,
                            levels=LATE_ONE, **paged)
    want = spec_serve(plain, rep, MAX_NEW, counters, levels=LATE_ONE)
    del plain
    spec = spec_engine(cfg, params, dev, report, levels=LATE_ONE, **paged)
    run = spec_serve(spec, rep, MAX_NEW, counters, levels=LATE_ONE)
    drafter = "n-gram"
    if run["verifies"] == 0 or run["spec_stats"]["spec_rollbacks"] == 0:
        report(f"spec {cfg.name} paged: n-gram drafts gave {run['verifies']}"
               f" verifies, {run['spec_stats']['spec_rollbacks']} rollbacks;"
               " serving again with drafts of the last token's copies")
        spec.drafter, drafter = AlwaysDraft(), "last token's copies"
        run = spec_serve(spec, rep, MAX_NEW, counters, levels=LATE_ONE)
    if run["spec_stats"]["spec_rollbacks"] == 0:
        # the model's stream repeats the prompt's token, so its copies are
        # all accepted: draft tokens it does not pick, as phase 10 does
        report(f"spec {cfg.name} paged: drafts of the last token's copies "
               f"gave {run['verifies']} verifies, no rollback; serving "
               "again with drafts the model does not pick")
        spec.drafter = RejectedDraft(cfg.vocab_size)
        drafter = "tokens the model does not pick"
        run = spec_serve(spec, rep, MAX_NEW, counters, levels=LATE_ONE)
    stats = spec.page_stats
    del spec
    for what, r in (("plain", want), ("spec", run)):
        expected = late_spec_launches("paged", cfg, r)
        require(r["launches"] == expected, f"{cfg.name} paged {what}: "
                f"launches {r['launches']}, expected {expected}")
    require(stats["used_pages"] == 0 and stats["committed"] == 0,
            f"{cfg.name} paged spec: the pool after the serve {stats}")
    st = run["spec_stats"]
    require(run["verifies"] > 0 and st["spec_rollbacks"] > 0,
            f"{cfg.name} paged spec: {run['verifies']} verifies, "
            f"{st['spec_rollbacks']} rollbacks")
    parted = spec_partings(f"{cfg.name} paged", cfg, params, rep,
                           run["streams"], want["streams"], dev, report)
    report(f"spec {cfg.name} paged ({len(rep)} constant prompts, drafts: "
           f"{drafter}, level {LATE_ONE[0]}): plain {want['wall_s']:.3f} s "
           f"({want['tokens_per_s']:.1f} tokens/s), spec {run['wall_s']:.3f}"
           f" s ({run['tokens_per_s']:.1f} tokens/s, "
           f"{run['tokens_per_s'] / want['tokens_per_s']:.3f}x); "
           f"{run['verifies']} verifies, hit rate {st['draft_hit_rate']:.3f}"
           f" ({st['tokens_accepted']} of {st['tokens_drafted']}), "
           f"{st['spec_rollbacks']} rollbacks; launches {run['launches']} "
           "(exact)")
    return {"drafter": drafter, "partings": parted, "spec_stats": st,
            "page_stats": stats,
            **{f"{w}_{k}": r[k] for w, r in (("plain", want), ("spec", run))
               for k in ("wall_s", "tokens_per_s", "verifies", "launches")}}


def late_spec_moe(cfg, params, engine, dev, report, counters, seed) -> dict:
    """arctic-480b's speculative serve (graphed, one level): every quantum
    a verify of the last token's copies against the graphed plain
    engine; exact launches and at least one verify; partings reported,
    not gated (a verify routes 20 tokens together, a step 4)."""
    import numpy as np
    rng = np.random.default_rng(seed + 13)
    rep = [np.full(n, int(rng.integers(cfg.vocab_size)), np.int32)
           for n in SPEC_REP_LENS]
    spec = spec_engine(cfg, params, dev, report, levels=LATE_ONE)
    spec.drafter = AlwaysDraft()
    runs = {w: spec_serve(e, rep, MAX_NEW, counters, levels=LATE_ONE)
            for w, e in (("plain", engine), ("spec", spec))}
    del spec
    for w, r in runs.items():
        expected = late_spec_launches("dense", cfg, r)
        require(r["launches"] == expected, f"{cfg.name} spec {w}: launches "
                f"{r['launches']}, expected {expected}")
    st = runs["spec"]["spec_stats"]
    require(st["spec_quanta"] > 0, f"{cfg.name} spec: no verify ran")
    parted = stream_partings(runs["spec"]["streams"],
                             runs["plain"]["streams"])
    report(f"spec {cfg.name} ({len(rep)} constant prompts x "
           f"{MAX_NEW + 1} tokens, level {LATE_ONE[0]}, every quantum a "
           f"verify of the last token's copies): plain "
           f"{runs['plain']['wall_s']:.3f} s, spec "
           f"{runs['spec']['wall_s']:.3f} s "
           f"({runs['spec']['tokens_per_s'] / runs['plain']['tokens_per_s']:.3f}x"
           f" plain tokens/s); {st['spec_quanta']} verifies, hit rate "
           f"{st['draft_hit_rate']:.3f}, {st['spec_rollbacks']} rollbacks; "
           f"launches {runs['spec']['launches']} (exact); {len(parted)} of "
           f"{len(rep)} streams part from the plain serve's at (request, "
           f"token) {parted} (not gated: a verify routes 20-token groups, "
           "a step 4-token groups)")
    return {"partings": parted, "spec_stats": st,
            **{f"{w}_{k}": r[k] for w, r in runs.items()
               for k in ("wall_s", "tokens_per_s", "verifies", "launches")}}


def serve_late_config(arch, dev, counters, report, seed) -> dict:
    """One config of phase 13 (see the module docstring).  Each check that
    fails is reported and the config goes on with the checks that do not
    depend on it."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import cost_model as cm
    from repro_torch.models.model import Model

    t_arch = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(arch),
                              num_layers=LATE_LAYERS[arch])
    t0 = time.perf_counter()
    params = Model(cfg).init(torch.Generator(device=dev).manual_seed(seed),
                             dev)
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated()
    n_params = sum(a.numel() for a in _leaves(params))
    h, kh, d = LATE_HEADS[arch]
    widths = (f"a dense residual MLP of {cfg.d_ff} beside "
              f"{cfg.moe.num_experts} experts of {cfg.moe.expert_d_ff}, "
              f"top-{cfg.moe.top_k} (capacity factor "
              f"{cfg.moe.capacity_factor})" if cfg.moe else
              f"d_ff {cfg.d_ff}")
    report(f"{arch}: {cfg.num_layers} of {get_config(arch).num_layers} "
           f"layers, d_model {cfg.d_model}, {h} heads over {kh} KV heads of "
           f"{d} (G {h // kh}), {widths}, vocab {cfg.vocab_size}"
           f"{', tied' if cfg.tie_embeddings else ''}: {n_params / 1e9:.3f} "
           f"B parameters ({n_params * 2 / 1e9:.2f} GB) made on the card in "
           f"{time.perf_counter() - t0:.1f} s (peak device memory "
           f"{init_peak / 2**30:.2f} GiB while they were made)")
    rng = np.random.default_rng(seed + 13)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPT_LENS]
    warm = {"levels": [cm.grid_point(i) for i in LATE_LEVELS],
            "quantum_buckets": SPEC_BUCKETS}
    warm_one = {"levels": [cm.grid_point(i) for i in LATE_ONE],
                "quantum_buckets": SPEC_BUCKETS}
    groups = {"block_matmul": "block_matmul_kernel",
              "flash_attention": "flash_attention_kernel",
              "cublas bf16": "nvjet", "cublas fp32": "gemmSN",
              "cublas other": "gemm", "elementwise": "elementwise_kernel",
              "sort": "ort", "reduce": "reduce_kernel", "index": "ndex"}
    out: dict = {"failures": [], "seconds": {}, "layers": cfg.num_layers,
                 "params": n_params, "init_peak_bytes": init_peak}

    def attempt(name, fn):
        t = time.perf_counter()
        try:
            return fn()
        except SmokeFailure as e:
            out["failures"].append(f"{arch} {name}: {e}")
            report(f"late {arch} {name} FAILED: {e}")
            return None
        finally:
            out["seconds"][name] = time.perf_counter() - t

    eager = attempt("eager serve", lambda: serve(
        cfg, params, prompts, dev, report, counters, late_launches(cfg),
        engine_kw={"cuda_graphs": False}, warmup_kw=warm,
        levels=LATE_LEVELS))
    graphed = attempt("graphed serve", lambda: serve(
        cfg, params, prompts, dev, report, counters, late_launches(cfg),
        warmup_kw=warm, levels=LATE_LEVELS))
    engine = graphed[0] if graphed else None
    if graphed:
        out["serve"] = graphed[1]
    if eager and graphed:
        out["eager"] = eager[1]
        attempt("eager against graphed", lambda: same_streams(
            arch, graphed[1], eager[1], report))
    del eager
    gc.collect()

    def paged_serve():
        paged_prompts, order = sharing_prompts(prompts, cfg.vocab_size, seed)
        eng, res = serve(cfg, params, paged_prompts, dev, report, counters,
                         late_launches(cfg, paged=True),
                         engine_kw={"page_size": PAGE_SIZE},
                         after={2: 0, 3: 0}, warmup_kw=warm_one,
                         levels=LATE_ONE)
        check_paged_serve(eng, res, report)
        if graphed:
            same = [res["streams"][j] == graphed[1]["streams"][i]
                    for j, i in enumerate(order) if i is not None]
            res["streams_equal_to_dense"] = sum(same)
            report(f"{arch} paged: {sum(same)} of {len(same)} streams equal "
                   "the dense serve's (not gated: the paged and dense "
                   "kernels sum in different orders"
                   + ("; the sharers change the rows that route together)"
                      if cfg.moe else ")"))
        return res
    out["paged"] = attempt("paged serve", paged_serve)
    gc.collect()
    check = whole_model_check_moe if cfg.moe else whole_model_check
    out["whole_model"] = attempt("whole model", lambda: check(
        cfg, params, prompts[1], dev, report))
    if cfg.moe and engine is not None:
        out["spec"] = attempt("spec", lambda: late_spec_moe(
            cfg, params, engine, dev, report, counters, seed))
        out["moe_layers"] = attempt("routed experts timing", lambda:
                                    moe_layer_times(cfg, params, dev,
                                                    report))
    if engine is not None:
        # the profile leaves requests resident: last on this engine
        out["profile_quantum"] = attempt("quantum profile", lambda:
                                         profile_quantum(engine, prompts,
                                                         report, groups))
    del engine, graphed
    gc.collect()
    if arch == "llama3-405b":
        out["spec"] = attempt("paged spec", lambda: late_spec_paged(
            cfg, params, dev, report, counters, seed))
    serves = [r["max_memory_allocated"] for r in (
        out.get("serve"), out.get("eager"), out.get("paged")) if r]
    out["serve_peak_bytes"] = max(serves, default=None)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t_arch
    report(f"late {arch}: {out['s']:.1f} s ("
           + ", ".join(f"{k} {v:.1f}" for k, v in out["seconds"].items())
           + f"); peak device memory {init_peak / 2**30:.2f} GiB while the "
           "weights were made, "
           + ("not measured" if not serves else
              f"{max(serves) / 2**30:.2f} GiB")
           + " in the serves")
    return out


def serve_late(dev, counters, report, seed) -> dict:
    """Phase 13: each config of LATE_ARCHS in turn; the phase fails at its
    end if any check did."""
    t_phase = time.perf_counter()
    out = {arch: serve_late_config(arch, dev, counters, report, seed)
           for arch in LATE_ARCHS}
    failures = [f for arch in LATE_ARCHS for f in out[arch]["failures"]]
    out["phase_s"] = time.perf_counter() - t_phase
    report(f"late: phase 13 took {out['phase_s']:.1f} s ("
           + ", ".join(f"{a} {out[a]['s']:.1f}" for a in LATE_ARCHS)
           + f"); levels {'/'.join(map(str, LATE_LEVELS))}")
    require(not failures, "phase 13: " + "; ".join(failures))
    return out


# ---------------------------------------------------------------------------
# Phase 14: the frontends (qwen2-vl-2b: M-RoPE over patch embeddings;
# musicgen-large: sinusoidal positions over frame embeddings) at their
# published widths and full depth
FRONT_PROMPT = 256        # patches (a 16 x 16 grid) or frames a row
FRONT_GRID = 16           # the grid's width: h = i // FRONT_GRID
FRONT_ROWS = 2
FRONT_CHUNK = 16
FRONT_STEPS = 8           # decode steps after the embedding prompt


def front_positions(n, rows, dev):
    """(3, rows, n) M-RoPE positions of an image grid FRONT_GRID wide: t
    0, h i // FRONT_GRID, w i.  The w row is row-contiguous: the reference
    masks and offsets attention by it (ROADMAP queue C), so the kernels
    and the plain versions agree only there."""
    import torch
    i = torch.arange(n, device=dev)
    rows3 = torch.stack([torch.zeros_like(i), i // FRONT_GRID, i])
    return rows3[:, None, :].expand(3, rows, n).contiguous()


def front_step_inputs(cfg, logits, dev, seed, j):
    """The j-th decode step's input: qwen2-vl-2b decodes text tokens (the
    greedy token), musicgen-large frame embeddings (``make_sample_inputs``
    of a decode step)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.frontends import make_sample_inputs
    if cfg.frontend == "frames":
        return make_sample_inputs(
            cfg, ShapeConfig("step", 1, FRONT_ROWS, "decode"), device=dev,
            seed=seed + 100 + j)
    return {"tokens": logits.argmax(dim=-1)}


def logits_drift(what, got, want, report) -> dict:
    """``got`` against ``want``: the largest difference within LOGIT_RTOL
    of the largest logit, and the same greedy tokens."""
    import torch
    diff = (got - want).abs().max().item()
    scale = want.abs().max().item()
    same_top = bool((got.argmax(-1) == want.argmax(-1)).all())
    finite = bool(torch.isfinite(got).all())
    report(f"{what}: max |difference| {diff:.4g} (max |logit| {scale:.4g}, "
           f"tolerance {LOGIT_RTOL} x max |logit|), same argmax: "
           f"{same_top}, finite: {finite}")
    require(finite and diff <= LOGIT_RTOL * scale and same_top,
            f"{what}: logits drift {diff:.4g} of {scale:.4g}, same argmax "
            f"{same_top}, finite {finite}")
    return {"max_abs_diff": diff, "max_abs_logit": scale,
            "same_argmax": same_top}


def frontend_embedding_path(cfg, params, dev, report, seed) -> dict:
    """The embedding path through the model's entry points, eagerly:
    ``make_sample_inputs`` patch or frame embeddings, FRONT_ROWS rows of
    FRONT_PROMPT (qwen2-vl-2b with ``front_positions``), prefilled at
    once and in FRONT_CHUNK-position ``prefill_chunk`` calls, which must
    agree; FRONT_STEPS decode steps from the monolithic cache; the
    prefill and the first step through the plain versions too, within
    LOGIT_RTOL (the whole-model check)."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.frontends import make_sample_inputs
    from repro_torch.models.model import Model

    kern, plain = Model(cfg), Model(cfg, use_kernels=False)
    inputs = make_sample_inputs(
        cfg, ShapeConfig("phase 14", FRONT_PROMPT, FRONT_ROWS, "prefill"),
        device=dev, seed=seed + 14)
    if cfg.pos_embed == "mrope":
        inputs["positions"] = front_positions(FRONT_PROMPT, FRONT_ROWS, dev)
    out: dict = {"rows": FRONT_ROWS, "prompt": FRONT_PROMPT}

    def timed_call(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t) * 1e3

    cache = kern.init_cache(FRONT_ROWS, MAX_LEN, dev)
    (mono, _), out["prefill_ms"] = timed_call(
        lambda: kern.prefill(params, inputs, cache))
    chunked = kern.init_cache(FRONT_ROWS, MAX_LEN, dev)

    def chunks():
        for c in range(0, FRONT_PROMPT, FRONT_CHUNK):
            part = {k: (v[..., c:c + FRONT_CHUNK] if k == "positions"
                        else v[:, c:c + FRONT_CHUNK])
                    for k, v in inputs.items()}
            lg, _ = kern.prefill_chunk(params, part, chunked, c,
                                       FRONT_CHUNK)
        return lg
    last, out["chunks_ms"] = timed_call(chunks)
    what = f"{cfg.name} {FRONT_ROWS} x {FRONT_PROMPT} {cfg.frontend} embeds"
    out["chunked_vs_monolithic"] = logits_drift(
        f"{what}: {FRONT_PROMPT // FRONT_CHUNK} chunks of {FRONT_CHUNK} "
        "against one prefill (kernels)", last, mono, report)
    plain_cache = plain.init_cache(FRONT_ROWS, MAX_LEN, dev)
    plain_lg, _ = plain.prefill(params, inputs, plain_cache)
    out["prefill_vs_plain"] = logits_drift(
        f"whole model {what}: prefill through the kernels against the "
        "plain versions", mono, plain_lg, report)
    logits, steps_ms, kinds = mono, [], []
    for j in range(FRONT_STEPS):
        step_in = front_step_inputs(cfg, logits, dev, seed, j)
        kinds.append(next(iter(step_in)))
        pos = torch.full((FRONT_ROWS,), FRONT_PROMPT + j, device=dev)
        (logits, _), ms = timed_call(lambda: kern.decode_step(
            params, step_in, cache, pos))
        steps_ms.append(ms)
        require(logits.shape == (FRONT_ROWS, cfg.vocab_size) and
                bool(torch.isfinite(logits).all()),
                f"{what}: decode step {j} logits {tuple(logits.shape)}, "
                "not all finite")
        if j == 0:
            want, _ = plain.decode_step(params, step_in, plain_cache, pos)
            out["step_vs_plain"] = logits_drift(
                f"whole model {what}: a decode step on {kinds[0]} through "
                "the kernels against the plain versions", logits, want,
                report)
    out["steps_ms"] = steps_ms
    report(f"{what}: eager prefill {out['prefill_ms']:.1f} ms, "
           f"{FRONT_PROMPT // FRONT_CHUNK} chunks {out['chunks_ms']:.1f} ms,"
           f" {FRONT_STEPS} decode steps on {kinds[0]} "
           f"{sum(steps_ms):.1f} ms (median "
           f"{statistics.median(steps_ms):.1f} ms a step), logits finite")
    return out


def eager_against_graphed(cfg, params, graphed, prompts, dev, report,
                          counters) -> dict:
    """One prefill chunk a request and one 8-step quantum on an eager
    engine (no warmup) and on the warm graphed engine: BATCH_SLOTS
    requests of at most 16 tokens, prefilled at level 0, then one quantum
    at the last of LATE_LEVELS.  Streams and launches equal, each as
    ``late_launches`` counts them; the graphed engine captures nothing."""
    import torch
    from repro_torch.core import cost_model as cm
    from repro_torch.serving.engine import Request, ServingEngine

    eager = ServingEngine(cfg, params, batch_slots=BATCH_SLOTS,
                          max_len=MAX_LEN, device=dev, cuda_graphs=False)
    expected = late_launches(cfg)
    builds0 = graphed.version_cache.traces
    runs = {}
    for what, eng in (("eager", eager), ("graphed", graphed)):
        require(eng.active_slots == 0, f"{cfg.name} {what}: not idle")
        reqs = [Request(rid=200 + i, prompt=p[:16], max_new_tokens=QUANTUM)
                for i, p in enumerate(prompts[:BATCH_SLOTS])]
        eng.set_interference_level(cm.grid_point(0))
        torch.cuda.synchronize()
        for c in counters.values():
            c.clear()
        chunks = []
        for r in reqs:
            require(eng.admit_request(r), f"{cfg.name} {what}: no slot")
        while eng.prefill_pending:
            chunks.append(eng.prefill_step().chunk)
        eng.set_interference_level(cm.grid_point(LATE_LEVELS[-1]))
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.finish_quantum(eng.begin_quantum(QUANTUM))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        launches = {n: sum(c.values()) for n, c in counters.items()}
        want, why = expected(QUANTUM, chunks)
        require(launches == want, f"{cfg.name} {what} chunk and quantum: "
                f"launches {launches}, expected {want} ({why})")
        require(all(r.done and len(r.output) == QUANTUM + 1 for r in reqs),
                f"{cfg.name} {what}: the quantum left requests unfinished")
        runs[what] = {"streams": [list(r.output) for r in reqs],
                      "launches": launches, "chunks": chunks,
                      "quantum_ms": ms}
    require(graphed.version_cache.traces == builds0,
            f"{cfg.name}: the graphed engine built a version after warmup")
    same = sum(a == b for a, b in zip(runs["graphed"]["streams"],
                                      runs["eager"]["streams"]))
    require(runs["graphed"]["streams"] == runs["eager"]["streams"],
            f"{cfg.name}: {same} of {BATCH_SLOTS} graphed streams equal the "
            "eager ones")
    report(f"{cfg.name}: eager and graphed engines, {len(runs['eager']['chunks'])}"
           f" prefill chunks at level 0 and one {QUANTUM}-step quantum at "
           f"level {LATE_LEVELS[-1]}: {same} of {BATCH_SLOTS} streams equal, "
           f"launches equal ({runs['graphed']['launches']}, exact); the "
           f"quantum {runs['eager']['quantum_ms']:.1f} ms eager, "
           f"{runs['graphed']['quantum_ms']:.2f} ms graphed")
    del eager
    return runs


def serve_frontend_config(arch, dev, counters, report, seed) -> dict:
    """One config of phase 14 (see the module docstring).  Each check that
    fails is reported and the config goes on with the checks that do not
    depend on it."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import cost_model as cm
    from repro_torch.models.model import Model
    from repro_torch.models.params import param_count

    t_arch = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(arch)
    t0 = time.perf_counter()
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed), dev)
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated()
    n_params = param_count(model.param_specs())
    require(n_params == sum(a.numel() for a in _leaves(params)),
            f"{arch}: param_count disagrees with the tree made")
    h, kh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    require(FRONT_HEADS[arch] == (h, kh, d) and FRONT_GEMMS[arch][0] ==
            (cfg.d_model, cfg.d_ff), f"{arch}: phases 2 and 8 hold other "
            f"shapes than the config's")
    pos = (f"M-RoPE sections {cfg.mrope_sections}, theta {cfg.rope_theta:g}"
           if cfg.pos_embed == "mrope" else f"{cfg.pos_embed} positions")
    report(f"{arch}: all {cfg.num_layers} layers, d_model {cfg.d_model}, "
           f"{h} heads over {kh} KV heads of {d} (G {h // kh}), "
           f"{cfg.activation} MLP of {cfg.d_ff}, {cfg.norm_type}, {pos}, "
           f"vocab {cfg.vocab_size}{', tied' if cfg.tie_embeddings else ''}"
           f", {cfg.frontend} frontend: {n_params / 1e9:.3f} B parameters "
           f"({n_params * 2 / 1e9:.2f} GB) made on the card in "
           f"{time.perf_counter() - t0:.1f} s (peak device memory "
           f"{init_peak / 2**30:.2f} GiB while they were made)")
    rng = np.random.default_rng(seed + 14)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPT_LENS]
    warm = {"levels": [cm.grid_point(i) for i in LATE_LEVELS],
            "quantum_buckets": SPEC_BUCKETS}
    warm_one = {"levels": [cm.grid_point(i) for i in LATE_ONE],
                "quantum_buckets": SPEC_BUCKETS}
    groups = {"block_matmul": "block_matmul_kernel",
              "flash_attention": "flash_attention_kernel",
              "flash_attention_paged": "paged_flash_kernel",
              "cublas bf16": "nvjet", "cublas fp32": "gemmSN",
              "cublas other": "gemm", "elementwise": "elementwise_kernel",
              "reduce": "reduce_kernel", "index": "ndex"}
    out: dict = {"failures": [], "seconds": {}, "layers": cfg.num_layers,
                 "params": n_params, "init_peak_bytes": init_peak}

    def attempt(name, fn):
        t = time.perf_counter()
        try:
            return fn()
        except SmokeFailure as e:
            out["failures"].append(f"{arch} {name}: {e}")
            report(f"frontends {arch} {name} FAILED: {e}")
            return None
        finally:
            out["seconds"][name] = time.perf_counter() - t

    out["embeddings"] = attempt("embedding path", lambda:
                                frontend_embedding_path(cfg, params, dev,
                                                        report, seed))
    graphed = attempt("graphed serve", lambda: serve(
        cfg, params, prompts, dev, report, counters, late_launches(cfg),
        warmup_kw=warm, levels=LATE_LEVELS))
    engine = graphed[0] if graphed else None
    if graphed:
        out["serve"] = graphed[1]
        out["eager"] = attempt("eager against graphed", lambda:
                               eager_against_graphed(cfg, params, engine,
                                                     prompts, dev, report,
                                                     counters))
    gc.collect()
    paged_engine = None

    def paged_serve():
        nonlocal paged_engine
        paged_prompts, order = sharing_prompts(prompts, cfg.vocab_size, seed)
        paged_engine, res = serve(cfg, params, paged_prompts, dev, report,
                                  counters, late_launches(cfg, paged=True),
                                  engine_kw={"page_size": PAGE_SIZE},
                                  after={2: 0, 3: 0}, warmup_kw=warm_one,
                                  levels=LATE_ONE)
        check_paged_serve(paged_engine, res, report)
        if graphed:
            same = [res["streams"][j] == graphed[1]["streams"][i]
                    for j, i in enumerate(order) if i is not None]
            res["streams_equal_to_dense"] = sum(same)
            report(f"{arch} paged: {sum(same)} of {len(same)} streams equal "
                   "the dense serve's (not gated: the paged and dense "
                   "kernels sum in different orders)")
        return res
    out["paged"] = attempt("paged serve", paged_serve)
    if arch == "musicgen-large" and paged_engine is not None:
        out["spec"] = attempt("paged spec", lambda: late_spec_paged(
            cfg, params, dev, report, counters, seed, plain=paged_engine))
    paged_engine = None
    gc.collect()
    if engine is not None:
        # the profile leaves requests resident: last on this engine
        out["profile_quantum"] = attempt("quantum profile", lambda:
                                         profile_quantum(engine, prompts,
                                                         report, groups))
    del engine, graphed
    serves = [r["max_memory_allocated"] for r in (
        out.get("serve"), out.get("paged")) if r]
    out["serve_peak_bytes"] = max(serves, default=None)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t_arch
    report(f"frontends {arch}: {out['s']:.1f} s ("
           + ", ".join(f"{k} {v:.1f}" for k, v in out["seconds"].items())
           + f"); peak device memory {init_peak / 2**30:.2f} GiB while the "
           "weights were made, "
           + ("not measured" if not serves else
              f"{max(serves) / 2**30:.2f} GiB")
           + " in the serves")
    return out


def serve_frontends(dev, counters, report, seed) -> dict:
    """Phase 14: each config of FRONT_ARCHS in turn; the phase fails at
    its end if any check did."""
    t_phase = time.perf_counter()
    out = {arch: serve_frontend_config(arch, dev, counters, report, seed)
           for arch in FRONT_ARCHS}
    failures = [f for arch in FRONT_ARCHS for f in out[arch]["failures"]]
    out["phase_s"] = time.perf_counter() - t_phase
    report(f"frontends: phase 14 took {out['phase_s']:.1f} s ("
           + ", ".join(f"{a} {out[a]['s']:.1f}" for a in FRONT_ARCHS)
           + f"); levels {'/'.join(map(str, LATE_LEVELS))}")
    require(not failures, "phase 14: " + "; ".join(failures))
    return out


# ---------------------------------------------------------------------------
# Phase 15: the training path, gemma-2b at its published widths and all 18
# layers trained through B1 (forward, remat recompute and both backward
# products) and B2 (forward and remat recompute; its gradient is the plain
# version's, as in the reference)
TRAIN_ARCH = "gemma-2b"
TRAIN_BATCH = 4             # rows of TRAIN_SEQ tokens a step
TRAIN_SEQ = 512
TRAIN_ACCUM = 2             # microbatches a step, 2 rows each
TRAIN_STEPS = 6             # steps under remat "full", whose loss must fall
# AdamW's peak rate, reached at the first step (warmup 1): at 1e-3, the
# launcher's default, the random full-width model's loss rose
# (``python -m repro_torch.launch.train --arch gemma-2b --steps 3``: 12.94
# -> 18.83 on an H100); at 1e-4 it fell 12.89 -> 7.40 in six steps
TRAIN_LR = 1e-4
# the loss of the last "full" step below the first's by at least this
# much (nats; 5.49 at TRAIN_LR on an H100)
TRAIN_LOSS_DROP = 2.0
# the kernel path against the plain path on one microbatch: each leaf's
# gradient, relative L2 (largest reading 5.3e-3, blocks/dense/attn/wq,
# median 2.8e-3 on an H100), and the loss, relative (reading 3.6e-5);
# about four and fourteen times the readings
TRAIN_GRAD_RTOL = 2e-2
TRAIN_LOSS_RTOL = 5e-4
# B1 at the training microbatch's shapes (M = 2 x 512 tokens): each
# forward GEMM is also the other GEMM's dX shape (dY (M, N) @ Wᵀ), and
# dW is Xᵀ (K, M) @ dY (M, N)
TRAIN_B1_SHAPES = (
    ("gate/up forward, down dX", 1024, 2048, 16384),
    ("down forward, gate/up dX", 1024, 16384, 2048),
    ("gate/up dW", 2048, 1024, 16384),
    ("down dW", 16384, 1024, 2048))


# a train step's device time by kernel group (the first substring a
# kernel's name holds): the port's kernels, cuBLAS's products (the
# projections, the unembedding and its gradients, the plain attention
# backward's fp32 products), elementwise passes, reductions, copies
TRAIN_GROUPS = {"block_matmul": "block_matmul_kernel",
                "flash_attention": "flash_attention_kernel",
                "cublas": "gemm", "cublas nvjet": "nvjet",
                "elementwise": "elementwise_kernel", "reduce": "reduce_kernel",
                "copies": "Memcpy"}


def train_launches(cfg, remat: str, accum: int = TRAIN_ACCUM) -> dict:
    """Kernel launches of one train step: per microbatch every MLP GEMM
    once forward, again under remat "full" (saved under "dots"), and twice
    backward (dX, dW); B2 once a layer forward and again under any remat
    (its backward runs the plain version's gradient); B3 and B4 never."""
    gemms = mlp_gemms(cfg) * cfg.num_layers
    return {"block_matmul": accum * gemms * (3 + (remat == "full")),
            "flash_attention": accum * cfg.num_layers * (
                1 + (remat != "none")),
            "flash_attention_paged": 0, "ssd_scan": 0}


def train_kernel_times(dev, gen, report) -> dict:
    """B1 at the training shapes and B2 over a 512-token microbatch
    (forward): each against its plain version (and B1 bit for bit across
    two launches), then timed as the kernel table is (level-0 tiles,
    CUDA events after an L2 flush) beside one PyTorch call and the
    bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import block_matmul as bm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import attention_ref, matmul_ref
    from repro_torch.serving.engine import H100_LEVEL_TILES

    scratch = torch.empty(96 * 2**20, dtype=torch.uint8, device=dev)

    def flush():
        scratch.zero_()

    tiles = H100_LEVEL_TILES[0]
    out = {"block_matmul": [], "failures": []}
    for label, m, k, n in TRAIN_B1_SHAPES:
        x = torch.randn(m, k, generator=gen, device=dev).bfloat16()
        w = (torch.randn(k, n, generator=gen, device=dev)
             * k ** -0.5).bfloat16()
        got = bm.block_matmul_2d(x, w, **tiles["matmul"])
        err, rel, ok = errors(got, matmul_ref(x, w))
        same = torch.equal(got, bm.block_matmul_2d(x, w, **tiles["matmul"]))
        if not (ok and same):
            out["failures"].append(f"B1 {label}: max abs err {err}, "
                                   f"bit-equal relaunch {same}")
        (tbm, tbk, tbn), split, blocks = bm.launch_geometry(
            m, k, n, **tiles["matmul"])
        nbytes = (m * k + k * n + m * n) * 2
        flops = 2 * m * k * n
        row = {"shape": label, "m": m, "k": k, "n": n, "max_abs_err": err,
               "ms": cold_ms(lambda: bm.block_matmul_2d(
                   x, w, **tiles["matmul"]), 20, flush),
               "plain_ms": cold_ms(lambda: matmul_ref(x, w), 20, flush),
               "library_ms": cold_ms(lambda: torch.matmul(x, w), 20, flush),
               "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                               flops / BF16_FLOPS) * 1e3,
               "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                            >= flops / BF16_FLOPS else "operations"),
               "tile": (tbm, tbk, tbn), "split": split, "blocks": blocks}
        row["tflops"] = flops / row["ms"] / 1e9
        out["block_matmul"].append(row)
        report(f"train time block_matmul {label} ({m}, {k}) @ ({k}, {n}): "
               f"kernel {row['ms']:.4f} ms ({row['tflops']:.1f} TFLOP/s; "
               f"tile {row['tile']}, split {split}, {blocks} blocks), plain "
               f"{row['plain_ms']:.4f} ms, torch.matmul "
               f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
               f"({row['bound_by']}); max abs err {err:.4g} (rel {rel:.3g})")
    # B2 over a microbatch: 2 rows of 512 tokens from position 0, 8 query
    # heads over 1 KV head of 256; the bound counts the causal pairs
    b, s, h, kh, d = TRAIN_BATCH // TRAIN_ACCUM, TRAIN_SEQ, 8, 1, 256
    q = torch.randn(b, s, h, d, generator=gen, device=dev).bfloat16()
    kk = torch.randn(b, s, kh, d, generator=gen, device=dev).bfloat16()
    v = torch.randn(b, s, kh, d, generator=gen, device=dev).bfloat16()
    attn = tiles["attention"]
    got = fa.flash_attention(q, kk, v, offset=0, kv_valid_len=s, **attn)
    err, rel, ok = errors(got, attention_ref(q, kk, v, offset=0,
                                             kv_valid_len=s))
    if not ok:
        out["failures"].append(f"B2 at S {s}: max abs err {err}")
    qt = q.transpose(1, 2)
    kt, vt = (a.transpose(1, 2).expand(b, h, s, d) for a in (kk, v))
    nbytes = (2 * b * s * h * d + 2 * b * s * kh * d) * 2
    flops = 4 * h * d * b * s * (s + 1) // 2
    (tbq, tbkv), split, blocks = fa.launch_geometry(b, s, h, kh, s, **attn)
    row = {"b": b, "s": s, "h": h, "kh": kh, "d": d, "max_abs_err": err,
           "ms": cold_ms(lambda: fa.flash_attention(
               q, kk, v, offset=0, kv_valid_len=s, **attn), 20, flush),
           "plain_ms": cold_ms(lambda: attention_ref(
               q, kk, v, offset=0, kv_valid_len=s), 20, flush),
           "library_ms": cold_ms(lambda: F.scaled_dot_product_attention(
               qt, kt, vt, is_causal=True), 20, flush),
           "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                           flops / BF16_FLOPS) * 1e3,
           "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                        >= flops / BF16_FLOPS else "operations"),
           "block": (tbq, tbkv), "split": split, "blocks": blocks}
    out["flash_attention"] = row
    report(f"train time flash_attention B={b} S={s} H={h} KV={kh} D={d} "
           f"causal from 0: kernel {row['ms']:.4f} ms (block {row['block']}, "
           f"split {split}, {blocks} blocks), plain {row['plain_ms']:.4f} "
           f"ms, sdpa {row['library_ms']:.4f} ms, bound "
           f"{row['bound_ms']:.4f} ms ({row['bound_by']}); max abs err "
           f"{err:.4g}")
    del scratch
    return out


def microbatch(batch: dict, index: int) -> dict:
    """Microbatch ``index`` of a step's batch (TRAIN_ACCUM of them)."""
    n = TRAIN_BATCH // TRAIN_ACCUM
    return {k: v[index * n:(index + 1) * n] for k, v in batch.items()}


def train_grad_check(model, plain, state, batch, report,
                     mb_index: int = 0) -> dict:
    """Microbatch ``mb_index`` of ``batch`` through the kernels and
    through the plain versions (the same master, remat "full"): the loss
    and every leaf's gradient, none of which may be missing or all
    zeros."""
    import torch
    from repro_torch.models.params import path_str, tree_leaves_with_path
    from repro_torch.training.train_step import cast_params

    master = state["opt"]["master"]
    leaves = list(tree_leaves_with_path(master))
    specs = model.param_specs()
    mb = microbatch(batch, mb_index)
    out, grads = {}, {}
    for name, m in (("kernels", model), ("plain", plain)):
        loss, _ = m.loss(cast_params(master, specs), mb, remat="full")
        loss.backward()
        out[f"{name}_loss"] = float(loss.detach())
        grads[name] = {}
        for p, leaf in leaves:
            g = leaf.grad
            require(g is not None and bool(g.ne(0).any()),
                    f"phase 15: the {name} path gives {path_str(p)} "
                    f"{'no' if g is None else 'an all-zero'} gradient")
            grads[name][p] = g
            leaf.grad = None
    rel = {}
    for p, _ in leaves:
        gk, gp = grads["kernels"][p], grads["plain"][p]
        rel[path_str(p)] = float((gk - gp).norm() / gp.norm())
    out["grad_rel_l2"] = rel
    out["loss_rel"] = abs(out["kernels_loss"] - out["plain_loss"]) / \
        abs(out["plain_loss"])
    worst = max(rel, key=rel.get)
    out["worst_leaf"], out["worst"] = worst, rel[worst]
    report(f"train grads {model.cfg.name}, kernels against plain versions "
           f"on microbatch {mb_index} (2 x {TRAIN_SEQ} tokens, remat full): "
           f"loss "
           f"{out['kernels_loss']:.6f} / {out['plain_loss']:.6f} (relative "
           f"{out['loss_rel']:.3e}); per-leaf relative L2 largest "
           f"{out['worst']:.3e} ({worst}), median "
           f"{statistics.median(rel.values()):.3e} over {len(rel)} leaves; "
           f"tolerances {TRAIN_GRAD_RTOL} (grads), {TRAIN_LOSS_RTOL} "
           "(loss)")
    return out


# phase 15's second model: mamba2-780m at its published widths (d_inner
# 3072, 48 SSD heads of 64, state 128) and TRAIN_SSM_LAYERS of its 48
# layers, trained through B4 (the kernel forward, the plain scan's
# gradient recomputed: ``ssd_scan.SsdScanGrad``) with phase 15's recipe
TRAIN_SSM_ARCH = "mamba2-780m"
TRAIN_SSM_LAYERS = 6
TRAIN_SSM_STEPS = 3         # steps under remat "full" after the grad check
# The kernel path's gradients against the plain path's.  B4's y differs
# from the plain scan's by one bf16 ulp on ~0.2% of entries (the kernel's
# spec), and at random init mamba2's gradients amplify such flips layer
# by layer: with the last bit of the plain scan's y flipped on the same
# share of entries, the plain path's own gradients move about as far as
# the kernel path's.  So TRAIN_GRAD_RTOL (2e-2, set from gemma-2b's
# readings) is out of reach of any path with one-ulp differences here.
# The check reads TRAIN_SSM_SEEDS weight seeds (the run's and the next
# ones) x TRAIN_ACCUM microbatches; every reading's largest per-leaf
# relative L2 must stay under the fixed TRAIN_SSM_GRAD_CEILING, and the
# largest of them within TRAIN_SSM_CONTROL_FACTOR times the largest
# one-ulp control over the same readings.  Readings at seed 0 on an H100
# 80GB HBM3 (700 W), equal bit for bit in two passes: the kernel path's
# 3.50e-2 to 7.28e-2, the control's 3.80e-2 to 6.07e-2; the ceiling
# sits 1.37x above the largest kernel-path reading
TRAIN_SSM_SEEDS = 5
TRAIN_SSM_GRAD_CEILING = 0.1
TRAIN_SSM_CONTROL_FACTOR = 2.0


def train_ssm_launches(cfg, accum: int = TRAIN_ACCUM) -> dict:
    """Kernel launches of one mamba2 train step under remat "full": per
    microbatch every layer's chunked scan once forward and once more in
    the recompute (its backward launches nothing); no MLP, no attention."""
    return {"block_matmul": 0, "flash_attention": 0,
            "flash_attention_paged": 0,
            "ssd_scan": accum * cfg.num_layers * 2}


def ssm_ulp_control(plain, state, batch, share: float,
                    mb_index: int = 0) -> dict:
    """The plain path's gradients on microbatch ``mb_index`` (remat
    "full") with
    the last bit of every scan's bf16 y flipped on ``share`` of its
    entries (seeded; the gradient passes as the plain scan's), against
    the unperturbed plain path's: per-leaf relative L2."""
    import torch
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models.params import path_str, tree_leaves_with_path
    from repro_torch.training.train_step import cast_params

    master = state["opt"]["master"]
    leaves = list(tree_leaves_with_path(master))
    specs = plain.param_specs()
    mb = microbatch(batch, mb_index)
    scan = ssm_mod.ssd_ref
    gen = torch.Generator(device=mb["tokens"].device).manual_seed(1)

    def flipped(*args, **kw):
        y, st = scan(*args, **kw)
        bits = y.detach().view(torch.int16)
        flip = (torch.rand(bits.shape, generator=gen, device=y.device)
                < share).to(torch.int16)
        return y + ((bits ^ flip).view(torch.bfloat16) - y).detach(), st
    grads = []
    for fn in (scan, flipped):
        ssm_mod.ssd_ref = fn
        try:
            loss, _ = plain.loss(cast_params(master, specs), mb,
                                 remat="full")
            loss.backward()
        finally:
            ssm_mod.ssd_ref = scan
        grads.append({path_str(p): leaf.grad for p, leaf in leaves})
        for _, leaf in leaves:
            leaf.grad = None
    rel = {p: float((grads[1][p] - g).norm() / g.norm())
           for p, g in grads[0].items()}
    worst = max(rel, key=rel.get)
    return {"grad_rel_l2": rel, "worst": rel[worst], "worst_leaf": worst,
            "median": statistics.median(rel.values()), "share": share}


def ssm_grad_readings(model, plain, state, tc, batch, dev, seed,
                      report) -> list[dict]:
    """The grad check and its one-ulp control at TRAIN_SSM_SEEDS weight
    seeds (``state`` is the first's) x TRAIN_ACCUM microbatches of
    ``batch``: one reading each, with the share of the scan's y entries
    where B4 and the plain version differ (layer 0, at the model's own
    inputs)."""
    import torch
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.training import init_train_state

    seen = []
    launch = ssd._launch

    def recording(x, dt, a, b, c, chunk, init, tensors):
        y, st = launch(x, dt, a, b, c, chunk, init, tensors)
        if not seen:
            yp, _ = ssd.ssd_scan_plain(x, dt, a, b, c, chunk_size=chunk,
                                       initial_state=init)
            seen.append(float((y != yp).float().mean()))
        return y, st
    readings = []
    for k in range(TRAIN_SSM_SEEDS):
        st = state if k == 0 else init_train_state(
            model, torch.Generator(device=dev).manual_seed(seed + k), tc,
            dev)
        for j in range(TRAIN_ACCUM):
            seen.clear()
            ssd._launch = recording
            try:
                check = train_grad_check(model, plain, st, batch, report,
                                         mb_index=j)
            finally:
                ssd._launch = launch
            control = ssm_ulp_control(plain, st, batch, seen[0],
                                      mb_index=j)
            check.update(seed=seed + k, microbatch=j, y_flip_share=seen[0],
                         control=control)
            report(f"train grads {TRAIN_SSM_ARCH} seed {seed + k} "
                   f"microbatch {j}: B4's y differs from the plain scan's "
                   f"on {seen[0]:.4f} of entries (one bf16 ulp each); the "
                   f"kernel path's largest per-leaf relative L2 "
                   f"{check['worst']:.3e} ({check['worst_leaf']}), the "
                   f"plain path with the last bit of its scans' y flipped "
                   f"on that share {control['worst']:.3e} "
                   f"({control['worst_leaf']})")
            readings.append(check)
        del st
    return readings


def train_mamba2(dev, counters, report, seed, card) -> dict:
    """Phase 15's mamba2-780m step (see the module docstring): the grad
    check against the plain path, TRAIN_SSM_STEPS steps with exact
    launches, the plain backward's device time a step (CUDA events
    around every ``SsdScanGrad.backward``) and peak memory."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models.model import Model
    from repro_torch.models.params import param_count
    from repro_torch.training import OptimizerConfig, TrainConfig, \
        init_train_state, make_train_step
    from repro_torch.training.train_loop import batch_to_device

    failures = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(TRAIN_SSM_ARCH),
                              num_layers=TRAIN_SSM_LAYERS)
    model, plain = Model(cfg), Model(cfg, use_kernels=False)
    tc = TrainConfig(optimizer=OptimizerConfig(
        name="adamw", lr=TRAIN_LR, schedule="wsd", warmup_steps=1,
        total_steps=TRAIN_SSM_STEPS), accum_steps=TRAIN_ACCUM, remat="full")
    state = init_train_state(model, torch.Generator(device=dev).manual_seed(
        seed), tc, dev)
    n_params = param_count(model.param_specs())
    report(f"train {TRAIN_SSM_ARCH}: {cfg.num_layers} of its 48 layers, "
           f"d_model {cfg.d_model}, d_inner {cfg.ssm.d_inner}, "
           f"{cfg.ssm.num_heads} SSD heads x {cfg.ssm.head_dim}, state "
           f"{cfg.ssm.state_dim}, chunk {cfg.ssm.chunk_size}, vocab "
           f"{cfg.vocab_size}; {n_params / 1e9:.3f} B parameters, AdamW")
    pipeline = TokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH, seed=seed))
    batches = [batch_to_device(pipeline.batch(i), dev)
               for i in range(TRAIN_SSM_STEPS)]
    readings = ssm_grad_readings(model, plain, state, tc, batches[0], dev,
                                 seed, report)
    worst = max(r["worst"] for r in readings)
    controls = [r["control"]["worst"] for r in readings]
    bound = TRAIN_SSM_CONTROL_FACTOR * max(controls)
    out = {"grad_check": readings[0], "grad_readings": readings,
           "grad_summary": {"worst": worst, "control_max": max(controls),
                            "control_min": min(controls),
                            "ceiling": TRAIN_SSM_GRAD_CEILING,
                            "control_bound": bound}}
    report(f"train grads {TRAIN_SSM_ARCH}: {len(readings)} readings "
           f"({TRAIN_SSM_SEEDS} seeds x {TRAIN_ACCUM} microbatches): the "
           f"kernel path's largest per-leaf relative L2 at most "
           f"{worst:.3e}, the one-ulp control's {min(controls):.3e} to "
           f"{max(controls):.3e}; held to the ceiling "
           f"{TRAIN_SSM_GRAD_CEILING} each and to "
           f"{TRAIN_SSM_CONTROL_FACTOR} x the largest control "
           f"({bound:.3e}); {card}")
    for r in readings:
        if r["worst"] > TRAIN_SSM_GRAD_CEILING or \
                r["loss_rel"] > TRAIN_LOSS_RTOL:
            failures.append(f"{TRAIN_SSM_ARCH} grads, seed {r['seed']} "
                            f"microbatch {r['microbatch']}: largest "
                            f"per-leaf relative L2 {r['worst']:.3e} "
                            f"(ceiling {TRAIN_SSM_GRAD_CEILING}), loss "
                            f"{r['loss_rel']:.3e} (tolerance "
                            f"{TRAIN_LOSS_RTOL})")
    if worst > bound:
        failures.append(f"{TRAIN_SSM_ARCH} grads: largest per-leaf "
                        f"relative L2 {worst:.3e} above "
                        f"{TRAIN_SSM_CONTROL_FACTOR} x the largest one-ulp "
                        f"control ({bound:.3e})")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # CUDA events around the plain version's gradient, recomputed in
    # every SsdScanGrad.backward
    events = []
    backward = ssd.SsdScanGrad.backward

    def timed_backward(ctx, dy, dstate):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        e0.record()
        grads = backward(ctx, dy, dstate)
        e1.record()
        events.append((e0, e1))
        return grads
    step_fn = make_train_step(model, tc)
    steps = []
    ssd.SsdScanGrad.backward = staticmethod(timed_backward)
    try:
        for i, batch in enumerate(batches):
            torch.cuda.synchronize()
            for c in counters.values():
                c.clear()
            events.clear()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            got = {name: sum(c.values()) for name, c in counters.items()}
            want = train_ssm_launches(cfg)
            backward_ms = sum(a.elapsed_time(b) for a, b in events)
            steps.append({"remat": "full", "wall_ms": wall_ms,
                          "launches": got, "expected": want,
                          "loss": float(metrics["loss"]),
                          "grad_norm": float(metrics["grad_norm"]),
                          "plain_backward_ms": backward_ms,
                          "plain_backward_calls": len(events),
                          "peak_gib": torch.cuda.max_memory_allocated()
                          / 2**30})
            if got != want:
                failures.append(f"{TRAIN_SSM_ARCH} step {i}: launches "
                                f"{got}, expected {want}")
            report(f"train {TRAIN_SSM_ARCH} step {i} remat full: loss "
                   f"{steps[-1]['loss']:.4f}, grad norm "
                   f"{steps[-1]['grad_norm']:.3f}, {wall_ms:.1f} ms, of it "
                   f"the plain scan's gradient {backward_ms:.1f} ms over "
                   f"{len(events)} backward calls (device time between CUDA "
                   f"events); launches B4 {got['ssd_scan']} (expected "
                   f"{want['ssd_scan']}), B1 {got['block_matmul']}, B2 "
                   f"{got['flash_attention']}, B3 "
                   f"{got['flash_attention_paged']}; peak "
                   f"{steps[-1]['peak_gib']:.2f} GiB")
            torch.cuda.reset_peak_memory_stats()
    finally:
        ssd.SsdScanGrad.backward = backward
    out["steps"] = steps
    rest = steps[1:] or steps
    step_ms = statistics.median(st["wall_ms"] for st in rest)
    bwd_ms = statistics.median(st["plain_backward_ms"] for st in rest)
    out["summary"] = {"step_ms": step_ms, "plain_backward_ms": bwd_ms,
                      "plain_backward_share": bwd_ms / step_ms,
                      "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3,
                      "peak_gib": max(st["peak_gib"] for st in steps),
                      "losses": [st["loss"] for st in steps],
                      "layers": cfg.num_layers, "n_params": n_params,
                      "card": card}
    losses = out["summary"]["losses"]
    if not all(math.isfinite(l) for l in losses):
        failures.append(f"{TRAIN_SSM_ARCH} losses {losses}")
    report(f"train {TRAIN_SSM_ARCH}: step {step_ms:.1f} ms (median of steps "
           f"1-{len(steps) - 1}), {out['summary']['tokens_per_s']:.0f} "
           f"tokens/s, the plain scan's gradient {bwd_ms:.1f} ms of it "
           f"({out['summary']['plain_backward_share']:.3f}); loss "
           f"{losses[0]:.4f} -> {losses[-1]:.4f}; peak "
           f"{out['summary']['peak_gib']:.2f} GiB; {card}")
    del state, batches, model, plain
    gc.collect()
    torch.cuda.empty_cache()
    out["failures"] = failures
    return out


def train_gemma(dev, counters, report, seed, card) -> dict:
    """Phase 15 (see the module docstring)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.kernels import dispatch
    from repro_torch.models.model import Model
    from repro_torch.models.params import param_count, \
        tree_leaves_with_path, tree_map_with_path
    from repro_torch.serving.engine import H100_LEVEL_TILES
    from repro_torch.training import OptimizerConfig, TrainConfig, \
        apply_updates, init_train_state, make_train_step
    from repro_torch.training.train_loop import batch_to_device

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    report(f"train: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
           "resident before phase 15")
    gen = torch.Generator(device=dev).manual_seed(seed + 15)
    out = train_kernel_times(dev, gen, report)
    failures = out.pop("failures")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    cfg = get_config(TRAIN_ARCH)
    model, plain = Model(cfg), Model(cfg, use_kernels=False)
    total = TRAIN_STEPS + 3
    tc = TrainConfig(optimizer=OptimizerConfig(
        name="adamw", lr=TRAIN_LR, schedule="wsd", warmup_steps=1,
        total_steps=total), accum_steps=TRAIN_ACCUM, remat="full")
    t0 = time.perf_counter()
    state = init_train_state(model, torch.Generator(device=dev).manual_seed(
        seed), tc, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = [t for _, t in tree_leaves_with_path(state)]
    require(all(t.device.type == "cuda" for t in leaves),
            "phase 15: a train state leaf is off the card")
    n_params = param_count(model.param_specs())
    n_layer_params = param_count(model.param_specs()["blocks"])
    report(f"train {TRAIN_ARCH}: {cfg.num_layers} layers, d_model "
           f"{cfg.d_model}, d_ff {cfg.d_ff}, {cfg.num_heads} heads over "
           f"{cfg.num_kv_heads} of {cfg.head_dim}, vocab {cfg.vocab_size}; "
           f"{n_params / 1e9:.3f} B parameters; AdamW state made on the "
           f"card in {init_s:.2f} s, "
           f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    pipeline = TokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH, seed=seed))
    batches = [batch_to_device(pipeline.batch(i), dev) for i in range(total)]

    def zero():
        for c in counters.values():
            c.clear()

    def counts():
        return {name: sum(c.values()) for name, c in counters.items()}

    with dispatch.tile_context(H100_LEVEL_TILES[0]):
        check = train_grad_check(model, plain, state, batches[0], report)
        if check["worst"] > TRAIN_GRAD_RTOL or \
                check["loss_rel"] > TRAIN_LOSS_RTOL:
            failures.append(f"grads: largest per-leaf relative L2 "
                            f"{check['worst']:.3e} (tolerance "
                            f"{TRAIN_GRAD_RTOL}), loss {check['loss_rel']:.3e}"
                            f" (tolerance {TRAIN_LOSS_RTOL})")
        out["grad_check"] = check
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        steps = []
        fns = {r: make_train_step(model, dataclasses.replace(tc, remat=r))
               for r in ("full", "none", "dots")}
        # TRAIN_STEPS "full" steps (the main path), one more profiled, then
        # one under "none" and one under "dots"
        plan = ["full"] * (TRAIN_STEPS + 1) + ["none", "dots"]
        for i, remat in enumerate(plan):
            profiled = i == TRAIN_STEPS
            torch.cuda.synchronize()
            zero()
            t0 = time.perf_counter()
            if profiled:
                res = {}

                def one():
                    res["out"] = fns[remat](state, batches[i])
                prof = device_profile(one, TRAIN_GROUPS)
                state, metrics = res["out"]
            else:
                state, metrics = fns[remat](state, batches[i])
                torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            got = counts()
            want = train_launches(cfg, remat)
            steps.append({"remat": remat, "wall_ms": wall_ms,
                          "launches": got, "expected": want,
                          "loss": float(metrics["loss"]),
                          "grad_norm": float(metrics["grad_norm"]),
                          "lr": float(metrics["lr"]),
                          "peak_gib": torch.cuda.max_memory_allocated()
                          / 2**30, "profiled": profiled})
            if got != want:
                failures.append(f"step {i} ({remat}): launches {got}, "
                                f"expected {want}")
            report(f"train step {i} remat {remat}: loss "
                   f"{steps[-1]['loss']:.4f}, grad norm "
                   f"{steps[-1]['grad_norm']:.3f}, lr {steps[-1]['lr']:.2e}, "
                   f"{wall_ms:.1f} ms{' (profiled)' if profiled else ''}; "
                   f"launches B1 {got['block_matmul']}, B2 "
                   f"{got['flash_attention']}, B3 "
                   f"{got['flash_attention_paged']}, B4 {got['ssd_scan']} "
                   f"(expected {want['block_matmul']} / "
                   f"{want['flash_attention']} / 0 / 0); peak "
                   f"{steps[-1]['peak_gib']:.2f} GiB")
            torch.cuda.reset_peak_memory_stats()
    out["steps"] = steps
    # the optimizer alone (clip, then AdamW over the fp32 state), CUDA
    # events around one update from zero grads at the end of the phase
    with torch.no_grad():
        zeros = tree_map_with_path(lambda _, m: torch.zeros_like(m),
                                   state["opt"]["master"])
        times = []
        for _ in range(3):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            e0.record()
            apply_updates(tc.optimizer, zeros, state["opt"], state["step"])
            e1.record()
            times.append((e0, e1))
        torch.cuda.synchronize()
        optimizer_ms = statistics.median(a.elapsed_time(b)
                                         for a, b in times)
        del zeros
    full = [st for st in steps if st["remat"] == "full"
            and not st["profiled"]]
    losses = [st["loss"] for st in full]
    if not all(math.isfinite(l) for l in losses) or \
            losses[-1] > losses[0] - TRAIN_LOSS_DROP:
        failures.append(f"loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
                        f"{len(losses)} steps: not a fall of "
                        f"{TRAIN_LOSS_DROP}")
    # the first step pays first-use costs: the rate from the others
    step_ms = statistics.median(st["wall_ms"] for st in full[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    model_flops = 6 * n_params * tokens + 2 * n_layer_params * tokens
    out["summary"] = {
        "losses": losses, "step_ms": step_ms,
        "tokens_per_s": tokens / step_ms * 1e3,
        "model_flops": model_flops,
        "model_flop_share": model_flops / (step_ms / 1e3) / BF16_FLOPS,
        "peak_gib": max(st["peak_gib"] for st in full),
        "peak_gib_none": steps[-2]["peak_gib"],
        "peak_gib_dots": steps[-1]["peak_gib"],
        "none_ms": steps[-2]["wall_ms"], "dots_ms": steps[-1]["wall_ms"],
        "optimizer_ms": optimizer_ms,
        "init_s": init_s, "n_params": n_params, "card": card}
    out["profile"] = profile_summary(
        f"{TRAIN_ARCH} one train step (remat full, {TRAIN_ACCUM} x "
        f"{TRAIN_BATCH // TRAIN_ACCUM} x {TRAIN_SEQ} tokens)",
        step_ms * 1e3, prof, 1, report)
    sm = out["summary"]
    report(f"train {TRAIN_ARCH}: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
           f"over {len(losses)} steps (remat full); step {step_ms:.1f} ms "
           f"(median of steps 1-{len(full) - 1}), "
           f"{sm['tokens_per_s']:.0f} tokens/s, model-FLOP share "
           f"{sm['model_flop_share']:.3f} of 989 TFLOP/s ("
           f"{model_flops / 1e12:.1f} TFLOP a step: 6 x params x tokens + "
           f"the recompute), peak {sm['peak_gib']:.2f} GiB (none "
           f"{sm['peak_gib_none']:.2f}, dots {sm['peak_gib_dots']:.2f}); "
           f"step under none {sm['none_ms']:.1f} ms, dots "
           f"{sm['dots_ms']:.1f} ms; the optimizer alone "
           f"{optimizer_ms:.1f} ms an update; {card}")
    # the profiled step's result and the leaf list hold the state too
    del state, batches, model, plain, res, fns, metrics, leaves
    gc.collect()
    torch.cuda.empty_cache()
    out["mamba2"] = train_mamba2(dev, counters, report, seed, card)
    failures += out["mamba2"].pop("failures")
    out["failures"] = failures
    out["phase_s"] = time.perf_counter() - t_phase
    report(f"train: phase 15 took {out['phase_s']:.1f} s")
    require(not failures, "phase 15: " + "; ".join(failures))
    return out


SERVE_ARCH = "gemma-2b"
SERVE_REQUESTS = 8
SERVE_PROMPT = 16
SERVE_MAX_NEW = 8
SERVE_SLOTS = 4


def serve_launch(counters, report, card) -> dict:
    """Phase 16 (see the module docstring)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch_serve

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    report(f"serve-launch: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
           "resident before phase 16")
    vocab = get_config(SERVE_ARCH).vocab_size
    for c in counters.values():
        c.clear()
    res = launch_serve.main([
        "--arch", SERVE_ARCH, "--requests", str(SERVE_REQUESTS),
        "--prompt-len", str(SERVE_PROMPT), "--max-new", str(SERVE_MAX_NEW),
        "--slots", str(SERVE_SLOTS)])
    launches = {name: sum(c.values()) for name, c in counters.items()}
    done = res.pop("requests")
    lengths = sorted(len(r.output) for r in done)
    out = {**res, "finished": len(done), "lengths": lengths,
           "launches": launches, "card": card,
           "outputs": {r.rid: [int(t) for t in r.output] for r in done}}
    gc.collect()                 # the engine's graphs and weights
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    report(f"serve-launch {res['arch']}: {len(done)}/{SERVE_REQUESTS} "
           f"requests, {res['tokens']} tokens in {res['seconds']:.2f} s "
           f"({res['tokens_per_s']:.1f} tokens/s, a cold engine: first-use "
           f"captures included) on {res['device']}; launches "
           + ", ".join(f"{k} {v}" for k, v in sorted(launches.items()))
           + f"; {card}")
    report(f"serve-launch: phase 16 took {out['phase_s']:.1f} s")
    require(len(done) == SERVE_REQUESTS and all(r.done for r in done),
            f"phase 16: {len(done)} of {SERVE_REQUESTS} requests finished")
    require(lengths == [SERVE_MAX_NEW + 1] * SERVE_REQUESTS,
            f"phase 16: tokens a request {lengths}, expected "
            f"{SERVE_MAX_NEW + 1} each")
    require(all(0 <= t < vocab for r in done for t in r.output),
            "phase 16: a token outside the vocabulary")
    require(launches["block_matmul"] > 0 and launches["flash_attention"] > 0,
            f"phase 16: B1 or B2 not launched: {launches}")
    require(launches["flash_attention_paged"] == 0
            and launches["ssd_scan"] == 0,
            f"phase 16: B3 or B4 launched on a dense gemma-2b serve: "
            f"{launches}")
    return out


# phase 17: the dry-run cells traced beside the elastic serve, each in a
# process of its own (a fake world is one per process), and how long the
# script waits for them
ELASTIC_CELLS = ("decode_32k", "train_4k")
DRYRUN_TIMEOUT_S = 600
# the production mesh's shape with no devices, and the next one up
# (reshard planning)
MESH_16x16 = {"data": 16, "model": 16}
MESH_2x16x16 = {"pod": 2, "data": 16, "model": 16}
CARD_BYTES = 80e9


class MeshShape:
    """A mesh-shape lookup with no devices: ``.shape`` maps axis names to
    sizes (what ``dist.sharding`` and ``reshard_plan`` read)."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _bits(t):
    """A float tensor's bits as integers of its width (``torch.equal``
    compares values, and -0.0 == 0.0)."""
    import torch
    if not t.is_floating_point():
        return t
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def _start_dryruns() -> dict:
    """The ``launch.dryrun`` cells of SERVE_ARCH at ELASTIC_CELLS, each a
    subprocess writing its record and its log under OUT_DIR."""
    import os
    OUT_DIR.mkdir(exist_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                               else []))
    procs = {}
    for shape in ELASTIC_CELLS:
        rec = OUT_DIR / f"chip_smoke_dryrun_{shape}.jsonl"
        rec.unlink(missing_ok=True)
        log = open(OUT_DIR / f"chip_smoke_dryrun_{shape}.log", "w")
        procs[shape] = (rec, log, time.perf_counter(), subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             SERVE_ARCH, "--shape", shape, "--out", str(rec)],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
    return procs


def _dryrun_bytes(shape_name: str) -> int:
    """``device_bytes`` of the port's trees of one serving cell of
    SERVE_ARCH on the 16 x 16 mesh: params under the serve rules' params
    table, inputs and cache under its activation table."""
    from repro_torch.configs import get_config, get_shape
    from repro_torch.dist import sharding as shd
    from repro_torch.models.frontends import input_specs
    from repro_torch.models.model import Model
    from repro_torch.models.params import tree_map_with_path
    cfg, shape = get_config(SERVE_ARCH), get_shape(shape_name)
    model, mesh = Model(cfg), MeshShape(MESH_16x16)
    rules = shd.make_rules("serve")
    total = 0
    for specs, table in ((model.param_specs(), rules.params),
                         (input_specs(cfg, shape), rules.acts),
                         (model.cache_specs(shape.global_batch,
                                            shape.seq_len), rules.acts)):
        pspecs = tree_map_with_path(
            lambda _, sp: shd.pspec_for(sp.shape, sp.axes, table, mesh),
            specs)
        total += shd.device_bytes(pspecs, specs, mesh)
    return total


def elastic_mesh(dev, counters, report, card, served_launch) -> dict:
    """Phase 17 (see the module docstring)."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.checkpoint import Checkpointer, elastic_restore, \
        reshard_plan
    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.state_sharding import train_state_specs
    from repro_torch.launch.dryrun import train_config_for
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.model import Model
    from repro_torch.models.params import path_str, \
        tree_leaves_with_path, tree_map_with_path
    from repro_torch.serving.engine import Request, ServingEngine

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    report(f"elastic: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
           "resident before phase 17")
    out: dict = {"card": card}
    tmp = None
    try:
        (ROOT / "build").mkdir(exist_ok=True)
        tmp = tempfile.mkdtemp(prefix="elastic_", dir=ROOT / "build")
        dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                                f"{_free_port()}", rank=0, world_size=1,
                                device_id=dev)
        # (a) save launch/serve's weights, plan a reshard, restore onto
        # the 1 x 1 mesh, serve phase 16's recipe from the restored tree
        mesh = make_debug_mesh()
        cfg = get_config(SERVE_ARCH)
        model = Model(cfg)
        specs = model.param_specs()
        params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
        torch.cuda.synchronize()
        nbytes = sum(t.numel() * t.element_size()
                     for _, t in tree_leaves_with_path(params))
        ckpt = Checkpointer(tmp)
        t0 = time.perf_counter()
        ckpt.save(0, params)
        save_s = time.perf_counter() - t0
        tspecs = train_state_specs(train_config_for(SERVE_ARCH).optimizer,
                                   specs)
        old, new = MeshShape(MESH_16x16), MeshShape(MESH_2x16x16)
        trules = shd.make_rules("train")
        plan = reshard_plan(
            tree_map_with_path(lambda _, sp: shd.pspec_for(
                sp.shape, sp.axes, trules.params, old), tspecs),
            old, new, tree_map_with_path(lambda _, sp: sp.shape, tspecs))
        out["plan"] = dataclasses.asdict(plan)
        report(f"elastic: reshard plan of {SERVE_ARCH}'s AdamW train state "
               f"16x16 -> 2x16x16: {plan.n_leaves} leaves, "
               f"{plan.moved_bytes} bytes moved (2 an element, as the "
               f"reference counts), {len(plan.incompatible)} indivisible "
               "dims")
        rules = shd.make_rules("serve")
        t0 = time.perf_counter()
        restored, step = elastic_restore(
            ckpt, model.abstract(), shd.param_pspecs(specs, rules, mesh),
            mesh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        bad = []
        for (p, saved), (_, got) in zip(tree_leaves_with_path(params),
                                        tree_leaves_with_path(restored)):
            local = got.to_local() if isinstance(got, DTensor) else None
            if local is None or local.device.type != "cuda" or \
                    local.shape != saved.shape or \
                    local.dtype != saved.dtype or \
                    not torch.equal(_bits(local), _bits(saved)):
                bad.append(path_str(p))
        n_leaves = len(list(tree_leaves_with_path(params)))
        out.update(step=step, bytes=nbytes, save_s=save_s,
                   restore_s=restore_s, leaves=n_leaves, not_equal=bad,
                   save_gb_s=nbytes / save_s / 1e9,
                   restore_gb_s=nbytes / restore_s / 1e9)
        report(f"elastic: {SERVE_ARCH} ({n_leaves} leaves, {nbytes} bytes "
               f"of bf16 and fp32) saved in {save_s:.2f} s "
               f"({out['save_gb_s']:.2f} GB/s, card to files), restored onto "
               f"the 1x1 cuda mesh in {restore_s:.2f} s "
               f"({out['restore_gb_s']:.2f} GB/s, files to DTensors; the "
               f"files' read is warm); {len(bad)} leaves not equal bit for "
               f"bit; {card}")
        require(not bad and step == 0,
                f"phase 17: restored leaves off the card or not equal bit "
                f"for bit to the saved ones: {bad[:5]}")
        del params
        local = tree_map_with_path(lambda _, t: t.to_local(), restored)
        for c in counters.values():
            c.clear()
        engine = ServingEngine(cfg, local, batch_slots=SERVE_SLOTS,
                               max_len=SERVE_PROMPT + SERVE_MAX_NEW + 2,
                               device=dev)
        rng = np.random.default_rng(0)
        reqs = [Request(rid=i, prompt=rng.integers(
                    0, cfg.vocab_size, SERVE_PROMPT).astype(np.int32),
                    max_new_tokens=SERVE_MAX_NEW)
                for i in range(SERVE_REQUESTS)]
        t0 = time.perf_counter()
        done = engine.run_to_completion(reqs)
        torch.cuda.synchronize()
        out["serve_s"] = time.perf_counter() - t0
        launches = {name: sum(c.values()) for name, c in counters.items()}
        outputs = {r.rid: [int(t) for t in r.output] for r in done}
        out.update(launches=launches, outputs=outputs,
                   same_tokens=outputs == served_launch["outputs"])
        report(f"elastic: served {len(done)} requests from the restored "
               f"weights in {out['serve_s']:.2f} s, tokens "
               + ("equal to" if out["same_tokens"] else "NOT equal to")
               + " phase 16's; launches "
               + ", ".join(f"{k} {v}" for k, v in sorted(launches.items())))
        require(out["same_tokens"],
                "phase 17: the restored weights serve other tokens than "
                "phase 16's")
        require(launches == served_launch["launches"],
                f"phase 17: launches {launches}, phase 16's "
                f"{served_launch['launches']}")
        del engine, local, restored
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
        if dist.is_initialized():
            dist.destroy_process_group()
    out["phase_s"] = time.perf_counter() - t_phase
    report(f"elastic: phase 17 (a) took {out['phase_s']:.1f} s")
    return out


def stop_dryruns(procs: dict) -> None:
    """Kill the dry-run tracers still running and close their logs."""
    for _, log, _, proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


def elastic_dryruns(procs: dict, report) -> dict:
    """Phase 17 (b): wait for the dry-run cells (started before phase 1,
    traced on the host beside phases 1, 2 and 8) and check them."""
    t0 = time.perf_counter()
    try:
        cells = {}
        for shape, (rec_path, log, t_start, proc) in procs.items():
            try:
                rc = proc.wait(timeout=max(
                    1.0, DRYRUN_TIMEOUT_S - (time.perf_counter() - t_start)))
            except subprocess.TimeoutExpired:
                rc = None
            rec = (json.loads(rec_path.read_text().splitlines()[-1])
                   if rec_path.exists() else {"status": "no record"})
            rec.pop("traceback", None)
            cells[shape] = {"rc": rc, "seconds": time.perf_counter() -
                            t_start, **rec}
    finally:
        stop_dryruns(procs)
    for shape, rec in cells.items():
        mem = rec.get("memory", {})
        coll = rec.get("collectives", {})
        report(f"elastic dryrun {SERVE_ARCH} x {shape} @ 16x16 (a fake "
               f"world of 256 ranks, traced on the host): "
               f"{rec.get('status')}, rc {rec['rc']}, "
               f"{rec.get('cost', {}).get('flops', 0):.6g} FLOPs, "
               f"arguments {mem.get('argument_size_in_bytes', 0)} bytes "
               f"a device ("
               f"{mem.get('argument_size_in_bytes', 0) / CARD_BYTES:.4f}"
               f" of the card's 80 GB), outputs "
               f"{mem.get('output_size_in_bytes', 0)} bytes; "
               f"collectives {coll.get('counts')}, link bytes a device "
               f"{coll.get('link_bytes_per_dev')}; trace "
               f"{rec.get('trace_s')} s, {rec['seconds']:.1f} s from "
               f"start; {rec.get('error', '')[:300]}")
    wait_s = time.perf_counter() - t0
    report(f"elastic: waited {wait_s:.1f} s for the dry-run cells after "
           "phase 8")
    for shape, rec in cells.items():
        require(rec["rc"] == 0 and rec.get("status") == "ok"
                and rec.get("n_devices") == 256
                and rec.get("cost", {}).get("flops", 0) > 0,
                f"phase 17: the {shape} dry-run cell: {rec}")
    dec = cells["decode_32k"]
    want = _dryrun_bytes("decode_32k")
    require(dec["memory"]["argument_size_in_bytes"] == want,
            f"phase 17: decode_32k arguments "
            f"{dec['memory']['argument_size_in_bytes']} bytes a device, "
            f"device_bytes {want}")
    return {"dryrun": cells, "dryrun_wait_s": wait_s}


# phase 18: the examples, as a user runs them (``repro_torch.examples``):
# quickstart's two passes at gemma-2b's published widths and depth, then
# every example's card parts as shipped (reduced configs)
EX_ARCH = "gemma-2b"
EX_TRAIN_STEPS = {"minicpm-2b": 20, "mamba2-780m": 10}


def run_examples(dev, counters, report, card) -> dict:
    """Phase 18 (see the module docstring).  Each part runs with the
    launch counters zeroed just before it and read just after; what it
    prints is reported line by line (``examples <part> | ...``).  A part
    that raises (a demo's own assertion) or fails a check is collected,
    and the phase fails at its end."""
    import contextlib
    import io

    import torch
    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.core import cost_model as cm
    from repro_torch.examples import multi_tenant_serving as mts
    from repro_torch.examples import quickstart, seeded_params, train_lm
    from repro_torch.models.params import tree_leaves_with_path

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    report(f"examples: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
           "resident before phase 18")
    failures: list = []
    out: dict = {"card": card, "parts": {}}
    total = collections.Counter()

    def part(label, fn):
        for c in counters.values():
            c.clear()
        buf = io.StringIO()
        t0 = time.perf_counter()
        res = None
        try:
            with contextlib.redirect_stdout(buf):
                res = fn()
        except Exception as e:                      # noqa: BLE001
            failures.append(f"{label}: {type(e).__name__}: {e}")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = {name: sum(c.values()) for name, c in counters.items()}
        total.update(got)
        for line in buf.getvalue().splitlines():
            report(f"examples {label} | {line}")
        report(f"examples {label}: {secs:.1f} s; launches "
               + ", ".join(f"{k} {v}" for k, v in sorted(got.items())))
        out["parts"][label] = {"seconds": secs, "launches": got}
        return res, got

    def check(cond, what):
        if not cond:
            failures.append(what)

    # (a) quickstart's recipe at full width and depth, then its main
    cfg = get_config(EX_ARCH)
    params = seeded_params(cfg, dev)
    res, got = part("quickstart full-width",
                    lambda: quickstart.quickstart_passes(cfg, params, dev))
    if res is not None:
        reqs = res["requests"] + res["spec_requests"]
        check(res["identical"], "quickstart full-width: the speculative "
              "stream differs from the plain one")
        check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.output),
              "quickstart full-width: a token outside the vocabulary")
        check(all(len(r.output) == quickstart.MAX_NEW + 1 for r in reqs),
              "quickstart full-width: a request's token count")
        spec_tokens = sum(len(r.output) for r in res["spec_requests"])
        # a speculative rate only where a draft landed: otherwise the
        # pass is a plain serve on a speculative engine, and its token
        # identity holds trivially
        drafted = res["spec_stats"]["spec_quanta"] > 0
        out["quickstart"] = {
            "layers": cfg.num_layers, "tokens": res["tokens"],
            "seconds": res["seconds"], "tokens_per_s": res["tokens_per_s"],
            "spec_seconds": res["spec_seconds"],
            "spec_tokens_per_s": (spec_tokens / res["spec_seconds"]
                                  if drafted else None),
            "spec_stats": res["spec_stats"], "launches": got}
        spec = (f"speculative {spec_tokens / res['spec_seconds']:.1f} "
                f"tokens/s, token-identical {res['identical']}" if drafted
                else f"speculative pass: no drafts landed (no n-gram of "
                f"the random prompts recurred; {res['spec_seconds']:.3f} "
                f"s, a plain serve on a speculative engine, so no "
                f"speculative rate and no token-identity test)")
        report(f"examples quickstart {EX_ARCH} ({cfg.num_layers} layers, "
               f"d_model {cfg.d_model}, d_ff {cfg.d_ff}): plain "
               f"{res['tokens']} tokens in {res['seconds']:.3f} s "
               f"({res['tokens_per_s']:.1f} tokens/s, a cold engine: "
               f"first-use captures included), {spec}; spec_stats "
               f"{res['spec_stats']}; {card}")
    check(got["block_matmul"] > 0 and got["flash_attention"] > 0,
          f"quickstart full-width: B1 or B2 not launched: {got}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    res, got = part("quickstart main", lambda: quickstart.main([]))
    check(res is not None and res["identical"]
          and got["block_matmul"] > 0 and got["flash_attention"] > 0,
          f"quickstart main: launches {got}")
    # (b) train_lm as shipped, then on mamba2-780m (B4 under grad)
    for arch, steps in EX_TRAIN_STEPS.items():
        res, got = part(f"train_lm {arch}", lambda: train_lm.main(
            ["--arch", arch, "--steps", str(steps)]))
        if res is not None:
            losses = res["losses"]
            out[f"train_lm {arch}"] = {"losses": losses, "launches": got}
            check(losses[-1][1] < losses[0][1],
                  f"train_lm {arch}: loss {losses[0][1]:.4f} -> "
                  f"{losses[-1][1]:.4f}")
            check(all(t.device.type == "cuda" for _, t in
                      tree_leaves_with_path(res["state"])),
                  f"train_lm {arch}: a train state leaf is off the card")
            del res
        kernel = "ssd_scan" if arch == "mamba2-780m" else "block_matmul"
        check(got[kernel] > 0, f"train_lm {arch}: {kernel} not launched: "
              f"{got}")
    # (c) multi_tenant_serving's card parts
    rcfg = get_reduced_config(EX_ARCH)
    rparams = seeded_params(rcfg, dev)
    res, got = part("online", lambda: mts.online_engine_demo(
        cm.CPU_3990X, rcfg, rparams, dev))
    check(res is not None and res["device"].type == "cuda"
          and got["block_matmul"] > 0 and got["flash_attention"] > 0,
          f"online: engine on {res and res['device']}, launches {got}")
    res, got = part("colocation", lambda: mts.colocation_demo(
        cm.hardware_spec_for(dev), dev))
    check(res is not None and all(d.startswith("cuda") for d in
                                  res["devices"]) and got["ssd_scan"] > 0,
          f"colocation: engines on {res and res['devices']}, launches "
          f"{got}")
    if res is not None:
        out["colocation"] = res
    res, got = part("speculative", lambda: mts.speculative_demo(
        rcfg, rparams, dev))
    check(res is not None and all(d.startswith("cuda") for d in
                                  res["devices"]),
          f"speculative: engines on {res and res['devices']}")
    if res is not None:
        out["speculative"] = {k: v for k, v in res.items()
                              if k not in ("plain", "spec")}
    del rparams
    gc.collect()
    torch.cuda.empty_cache()
    out["launches"] = dict(total)
    out["failures"] = failures
    out["phase_s"] = time.perf_counter() - t_phase
    report(f"examples: phase 18 took {out['phase_s']:.1f} s; launches "
           + ", ".join(f"{k} {v}" for k, v in sorted(total.items())))
    require(not failures, "phase 18: " + "; ".join(failures))
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree



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
    # phase 17 (b)'s tracers run on the host from here, beside phases 1,
    # 2 and 8 (none reads a host time), and are collected before phase 3
    dryruns = _start_dryruns()
    atexit.register(stop_dryruns, dryruns)
    t_script = t0 = time.perf_counter()
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
    from repro_torch.kernels import block_matmul as bm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_paged as fap
    from repro_torch.kernels import ssd_scan as ssd
    all_counters = {"block_matmul": bm.LAUNCHES,
                    "flash_attention": fa.LAUNCHES,
                    "flash_attention_paged": fap.LAUNCHES,
                    "ssd_scan": ssd.LAUNCHES}
    worst["ssd_scan"] = check_ssd(dev, gen, report)
    worst["flash_attention_paged"] = check_paged(dev, gen, report)
    ssd_phases = ssd_phase_breakdown(dev, gen, report)
    # seconds by phase (phases 3-7 and 10 run inside each model's turn)
    seconds = {"1 build": build_s,
               "2 kernel checks": time.perf_counter() - t_script - build_s}
    t_mark = time.perf_counter()
    times = (timings(dev, gen, report) + ssd_timings(dev, gen, report)
             + paged_timings(dev, gen, report))
    seconds["8 timings"] = time.perf_counter() - t_mark
    dryrun_cells = elastic_dryruns(dryruns, report)
    seconds["17 dry-run wait"] = dryrun_cells["dryrun_wait_s"]
    t_mark = time.perf_counter()

    rng = np.random.default_rng(args.seed)
    served, prof, model_check, host = {}, {}, {}, {}
    for name in ("gemma-2b", "mamba2-780m"):
        cfg = dataclasses.replace(get_config(name),
                                  num_layers=EARLY_LAYERS[name])
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
        served[name]["pairs"] = engine_pairs(
            {"eager": eager, "graphs": engine}, prompts, report, groups,
            chunk=True)
        if cfg.ssm is None:
            served[name]["stream_pairs"] = stream_pairs(
                engine, cfg, params, prompts, dev, report, groups)
        served[name]["spec"] = serve_spec(cfg, params, engine, prompts, dev,
                                          report, args.seed)
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
        seconds[f"3-7, 10 {name}"] = time.perf_counter() - t_mark
        t_mark = time.perf_counter()
    cluster = serve_cluster(dev, {"block_matmul": bm.LAUNCHES,
                                  "flash_attention": fa.LAUNCHES,
                                  "ssd_scan": ssd.LAUNCHES},
                            report, args.seed, card)
    seconds["9 cluster"] = time.perf_counter() - t_mark
    hybrid = serve_hybrid(dev, all_counters, report, args.seed)
    seconds["11 hybrid"] = hybrid["phase_s"]
    moe = serve_moe(dev, all_counters, report, args.seed)
    seconds["12 moe"] = moe["phase_s"]
    late = serve_late(dev, all_counters, report, args.seed)
    seconds["13 late"] = late["phase_s"]
    front = serve_frontends(dev, all_counters, report, args.seed)
    seconds["14 frontends"] = front["phase_s"]
    train = train_gemma(dev, all_counters, report, args.seed, card)
    seconds["15 train"] = train["phase_s"]
    served_launch = serve_launch(all_counters, report, card)
    seconds["16 serve-launch"] = served_launch["phase_s"]
    elastic = elastic_mesh(dev, all_counters, report, card, served_launch)
    seconds["17 elastic"] = elastic["phase_s"]
    elastic.update(dryrun_cells)
    examples = run_examples(dev, all_counters, report, card)
    seconds["18 examples"] = examples["phase_s"]

    # phase 10's graphed speculative serves, first of their pairs, both
    # arms: the kernels' launches there
    spec_launches = collections.Counter()
    for name in ("gemma-2b", "mamba2-780m"):
        for label, res in served[name]["spec"].items():
            if isinstance(res, dict) and "arms" in res:
                for arm in res["arms"].values():
                    spec_launches.update(arm["launches"]["spec"])
    # phase 11's serves: graphed chunked, monolithic, and both sides of
    # its speculative arms
    hybrid_launches_by = collections.Counter()
    for key in ("serve", "monolithic"):
        for name, per_tile in hybrid[key]["launches"].items():
            hybrid_launches_by[name] += sum(per_tile.values())
    for arm in hybrid["spec"]["arms"].values():
        for side in arm["launches"].values():
            hybrid_launches_by.update(side)
    # phase 12's serves: deepseek-v2-lite-16b graphed chunked, monolithic,
    # paged and both sides of its speculative arm, then its MoE-free
    # clone's dense, paged, monolithic and speculative serves
    moe_launches_by = collections.Counter()
    clone = moe["clone"]
    for res in (moe["serve"], moe["monolithic"], moe["paged"],
                clone["dense"], clone["paged"], clone["monolithic"]):
        for name, per_tile in res["launches"].items():
            moe_launches_by[name] += sum(per_tile.values())
    for side in (moe["spec"]["plain_launches"], moe["spec"]["spec_launches"],
                 clone["spec"]["launches"]):
        moe_launches_by.update(side)
    # phase 13's serves: each config's graphed chunked and paged serves and
    # both sides of its speculative serve (arctic-480b dense, llama3-405b
    # paged)
    late_by = collections.Counter()
    for arch in LATE_ARCHS:
        res = late[arch]
        for key in ("serve", "paged"):
            for name, per_tile in res[key]["launches"].items():
                late_by[name] += sum(per_tile.values())
        if "spec" in res:
            late_by.update(res["spec"]["plain_launches"])
            late_by.update(res["spec"]["spec_launches"])
    # phase 14's serves: each config's graphed chunked and paged serves,
    # the graphed side of its eager/graphed check, and both sides of
    # musicgen-large's speculative serve
    front_by = collections.Counter()
    for arch in FRONT_ARCHS:
        res = front[arch]
        for key in ("serve", "paged"):
            for name, per_tile in res[key]["launches"].items():
                front_by[name] += sum(per_tile.values())
        front_by.update(res["eager"]["graphed"]["launches"])
        if "spec" in res:
            front_by.update(res["spec"]["plain_launches"])
            front_by.update(res["spec"]["spec_launches"])
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
            "cluster_launches": cluster["launches"].get(name, 0),
            "spec_launches": spec_launches.get(name, 0),
            "hybrid_launches": hybrid_launches_by.get(name, 0),
            "moe_launches": moe_launches_by.get(name, 0),
            "late_launches": late_by.get(name, 0),
            "frontend_launches": front_by.get(name, 0),
            "train_launches": sum(st["launches"][name]
                                  for st in train["steps"]
                                  + train["mamba2"]["steps"]),
            "serve_launches": served_launch["launches"][name],
            "elastic_launches": elastic["launches"][name],
            "example_launches": examples["launches"].get(name, 0),
            "max_abs_err": worst[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    spec_s = sum(served[n]["spec"]["phase_s"] for n in ("gemma-2b",
                                                        "mamba2-780m"))
    total_s = time.perf_counter() - t_script
    report(f"chip_smoke: seconds by phase: " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items())
        + f" (phase 10 {spec_s:.1f} of them); the script {total_s:.1f} s "
        "from the build on")
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps({
        "card": card, "build_s": build_s, "ptxas": ptxas, "serve": served,
        "profile": prof, "host_profile": host, "whole_model": model_check,
        "times": times,
        "ssd_phases": ssd_phases, "cluster": cluster, "hybrid": hybrid,
        "moe": moe, "late": late, "frontends": front, "train": train,
        "serve_launch": served_launch, "elastic": elastic,
        "examples": examples,
        "kernels": kernels, "spec_s": spec_s, "total_s": total_s,
        "seconds": seconds,
        "lines": lines}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
