"""Whether what the timed path served is right: the plain reference over
a sample of the finished requests.

Once the window has closed and the program's engines are freed, a
sample of each tenant's finished requests, drawn from the seed and
holding its longest, is run through the tenant's reference (float32,
TF32 off) over the prompt and the served tokens.  At each served
position the gap by which the served token's reference logit lies below
the reference's best is read; the widest gap of the sample is held to
the tenant's ``logit_gap_limit`` in the configuration file.  Greedy
decoding picks the program's best token, so on a sound run the gap is
open only where the program's bfloat16 rounding flips a near-tie.

The control runs the same reference with every weight product in fp8
and reads the gap of the token it puts first at each position of the
same sequences.
"""
from __future__ import annotations

import numpy as np

from veltair_bench import references

MIN_TOKENS = 1024       # served tokens to compare, per tenant
MAX_REQUESTS = 16


def sample(reqs: list, tenant: str, seed: int) -> list:
    """The tenant's longest finished request, then others in an order
    drawn from ``seed``, until MIN_TOKENS served tokens or MAX_REQUESTS."""
    done = [r for r in reqs if r.tenant == tenant and r.output is not None]
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.prompt) + len(r.output), r.idx))
    rest = [r for r in done if r is not longest]
    picked, total = [longest], len(longest.output)
    for i in np.random.default_rng(int(seed) + 1).permutation(len(rest)):
        if total >= MIN_TOKENS or len(picked) >= MAX_REQUESTS:
            break
        picked.append(rest[i])
        total += len(rest[i].output)
    return picked


def gaps(tenant, reqs: list, device, *, control: bool = False) -> dict:
    """The widest logit gap of the served tokens of ``reqs`` (and, with
    ``control``, of the fp8 control's first choices) and the count."""
    import torch
    worst = {"served": 0.0, "control": 0.0 if control else None, "tokens": 0}
    with references.exact_fp32(), torch.no_grad():
        for r in reqs:
            out = np.asarray(r.output, np.int64)
            seq = torch.as_tensor(np.concatenate([r.prompt, out[:-1]]),
                                  dtype=torch.long, device=device)
            pos = list(range(len(r.prompt) - 1, seq.shape[0]))
            ref = tenant.ref.logits(tenant.params, seq, pos, tenant.config,
                                    references.matmul_fp32)
            best = ref.max(dim=-1).values
            served = torch.as_tensor(out, device=device)[:, None]
            gap = (best - ref.gather(1, served)[:, 0]).max().item()
            worst["served"] = max(worst["served"], gap)
            worst["tokens"] += len(out)
            if control:
                ctl = tenant.ref.logits(tenant.params, seq, pos,
                                        tenant.config,
                                        references.matmul_fp8)
                pick = ctl.argmax(dim=-1)[:, None]
                cgap = (best - ref.gather(1, pick)[:, 0]).max().item()
                worst["control"] = max(worst["control"], cgap)
    return worst


def check(tenants: list, reqs: list, seed: int, device, *,
          control: bool = False) -> dict:
    """name -> {"value", "limit"} of every number compared: each tenant's
    widest gap and the requests that failed (never served, or served with
    another count of tokens than asked).  With ``control`` the fp8
    control's first choices take the served tokens' place, judged by the
    same limits: a sound control comes out not ``passed``."""
    failed = sum(1 for r in reqs if r.output is None
                 or len(r.output) != r.out_tokens)
    out = {"failed_requests": {"value": failed, "limit": 0}}
    for t in tenants:
        g = gaps(t, sample(reqs, t.name, seed), device, control=control)
        out[f"logit_gap.{t.name}"] = {
            "value": g["control" if control else "served"],
            "limit": t.limit, "tokens": g["tokens"]}
    return out


def passed(checks: dict) -> bool:
    return all(c["limit"] is not None and c["value"] <= c["limit"]
               for c in checks.values())
