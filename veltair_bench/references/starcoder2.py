"""Plain float32 StarCoder2 (arXiv:2402.19173; hf bigcode/starcoder2-3b).

A decoder of ``num_hidden_layers`` blocks over a tied embedding:

    h = x + Attn(LN1(x));  x' = h + W_down gelu_tanh(W_up LN2(h) + b_up) + b_down

LayerNorm with scale and bias; grouped-query attention (query head h
reads key/value head h // (heads / kv_heads)) with rotary embeddings
over split halves of each head (theta ``rope_theta``), causal and within
``sliding_window`` keys, softmax scale 1/sqrt(head_dim); a final
LayerNorm and the tied embedding as the output head.

Departures from the source, as the program runs the model (each listed
in the configuration file's ``departures``): the attention projections
carry no biases (``use_bias`` holds for the MLP only), and
``norm_epsilon`` is the configuration file's.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from veltair_bench import roofline

def port_fields(c: dict) -> dict:
    """The program's config attributes this file fixes."""
    return {"d_model": c["hidden_size"], "num_layers": c["num_hidden_layers"],
            "num_heads": c["num_attention_heads"],
            "num_kv_heads": c["num_key_value_heads"],
            "head_dim": c["hidden_size"] // c["num_attention_heads"],
            "d_ff": c["intermediate_size"], "vocab_size": c["vocab_size"],
            "rope_theta": c["rope_theta"],
            "sliding_window": c["sliding_window"],
            "tie_embeddings": c["tie_word_embeddings"]}


def _dims(c: dict) -> tuple[int, int, int, int, int, int]:
    m, h = c["hidden_size"], c["num_attention_heads"]
    return (c["num_hidden_layers"], m, h, c["num_key_value_heads"],
            m // h, c["intermediate_size"])


def layout(c: dict) -> list:
    """The weight tree: stacked per-layer leaves under blocks/dense."""
    n, m, h, k, d, f = _dims(c)
    bf, f32 = torch.bfloat16, torch.float32
    out = [(("embed", "embedding"), (c["vocab_size"], m), bf, "normal",
            0.02)]
    blk = ("blocks", "dense")
    for name, shape, std in (("wq", (n, m, h, d), m ** -0.5),
                             ("wk", (n, m, k, d), m ** -0.5),
                             ("wv", (n, m, k, d), m ** -0.5),
                             ("wo", (n, h, d, m), (h * d) ** -0.5)):
        out.append((blk + ("attn", name), shape, bf, "normal", std))
    out += [(blk + ("mlp", "w_up"), (n, m, f), bf, "normal", m ** -0.5),
            (blk + ("mlp", "w_down"), (n, f, m), bf, "normal", f ** -0.5),
            (blk + ("mlp", "b_up"), (n, f), f32, "normal", 0.02),
            (blk + ("mlp", "b_down"), (n, m), f32, "normal", 0.02)]
    for ln in ("ln1", "ln2"):
        out += [(blk + (ln, "scale"), (n, m), f32, "one_plus", 0.02),
                (blk + (ln, "bias"), (n, m), f32, "normal", 0.02)]
    out += [(("final_norm", "scale"), (m,), f32, "one_plus", 0.02),
            (("final_norm", "bias"), (m,), f32, "normal", 0.02)]
    return out


def _layer_norm(x, scale, bias, eps):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * scale.float() + bias.float()


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (L, heads, D): each head's halves rotated by pos * theta^(-2i/D)."""
    d = x.shape[-1]
    half = d // 2
    inv = theta ** (-2.0 * torch.arange(half, dtype=torch.float64,
                                        device=x.device) / d)
    ang = (pos.double()[:, None] * inv)[:, None, :]
    cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def logits(params: dict, tokens: torch.Tensor, positions, c: dict,
           mm) -> torch.Tensor:
    """float32 logits (len(positions), vocab) of ``tokens`` (L,)."""
    n, m, h, k, d, _ = _dims(c)
    eps, window = float(c["norm_epsilon"]), c.get("sliding_window")
    seq = tokens.shape[0]
    emb = params["embed"]["embedding"]
    x = emb[tokens].float()
    pos = torch.arange(seq, device=x.device)
    causal = pos[None, :] <= pos[:, None]
    if window is not None:
        causal &= pos[None, :] > pos[:, None] - window
    blk = params["blocks"]["dense"]
    for i in range(n):
        at, ml = blk["attn"], blk["mlp"]
        a = _layer_norm(x, blk["ln1"]["scale"][i], blk["ln1"]["bias"][i],
                        eps)
        q = mm(a, at["wq"][i].reshape(m, h * d)).reshape(seq, h, d)
        kk = mm(a, at["wk"][i].reshape(m, k * d)).reshape(seq, k, d)
        v = mm(a, at["wv"][i].reshape(m, k * d)).reshape(seq, k, d)
        q, kk = _rope(q, pos, c["rope_theta"]), _rope(kk, pos, c["rope_theta"])
        rep = h // k
        kk = kk.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
        s = torch.einsum("qhd,khd->hqk", q, kk) / math.sqrt(d)
        s = s.masked_fill(~causal[None], float("-inf"))
        y = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v)
        x = x + mm(y.reshape(seq, h * d), at["wo"][i].reshape(h * d, m))
        a = _layer_norm(x, blk["ln2"]["scale"][i], blk["ln2"]["bias"][i],
                        eps)
        u = mm(a, ml["w_up"][i]) + ml["b_up"][i].float()
        u = F.gelu(u, approximate="tanh")
        x = x + mm(u, ml["w_down"][i]) + ml["b_down"][i].float()
    sel = torch.as_tensor(positions, device=x.device, dtype=torch.long)
    fin = params["final_norm"]
    out = _layer_norm(x[sel], fin["scale"], fin["bias"], eps)
    return mm(out, emb.t())


def kernel_work(c: dict, step: tuple) -> dict:
    """(flops, bytes) of each launch of the port's kernels in one model
    pass: ``("decode", kv_lens)``, one step over the batch, each row
    attending ``kv_lens[i]`` keys; or ``("chunk", size, start)``, a
    prefill chunk of ``size`` rows from position ``start``.  The MLP's
    two GEMMs run B1, attention B2, in every layer."""
    n, m, h, k, d, f = _dims(c)
    win = c.get("sliding_window") or 1 << 30
    if step[0] == "decode":
        rows = len(step[1])
        seqs = [[min(x, win)] for x in step[1]]
    else:
        rows, start = step[1], step[2]
        seqs = [[min(start + i + 1, win) for i in range(rows)]]
    return {"b1": [roofline.matmul(rows, m, f),
                   roofline.matmul(rows, f, m)] * n,
            "b2": [roofline.attention(seqs, h, k, d)] * n}


def token_flops(c: dict, pos: int) -> float:
    """Model FLOPs of one token at position ``pos``, the output head left
    out: every weight product and the attention over its keys."""
    n, m, h, k, d, f = _dims(c)
    win = c.get("sliding_window") or 1 << 30
    proj = 2 * (2 * m * h * d + 2 * m * k * d + 2 * m * f)
    return float(n * (proj + 4 * h * d * min(pos + 1, win)))


def head_flops(c: dict) -> float:
    """The output head's FLOPs for one token."""
    return 2.0 * c["hidden_size"] * c["vocab_size"]
