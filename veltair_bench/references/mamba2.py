"""Plain float32 Mamba-2 (arXiv:2405.21060; hf state-spaces/mamba2-780m).

``n_layer`` residual blocks ``x + Mixer(RMSNorm(x))`` over a tied
embedding, then RMSNorm and the embedding as the output head.  The
mixer (the paper's Mamba-2 block, ``ngroups`` groups of B and C):

    z, xBC, dt = in_proj(u)                       (no bias)
    xBC = silu(causal depthwise conv of width d_conv over xBC + bias)
    x, B, C = split(xBC);  dt = softplus(dt + dt_bias);  A = -exp(A_log)
    y_t = sum_{s<=t} (C_t . B_s) exp(sum_{s<r<=t} dt_r A) dt_s x_s + D x_t
    out = out_proj(RMSNorm(y * silu(z)))          (the gated norm)

The scan is the SSD's quadratic (attention-like) form over the whole
sequence, with the segment sums of dt * A taken in float64.

The embedding and the head have ``vocab_size`` rows rounded up to a
multiple of ``pad_vocab_size_multiple``, as the source pads them.

Departures from the source, as the program runs the model (listed in the
configuration file's ``departures``): ``norm_epsilon`` is the file's, and
the residual stream is not kept in float32 by the program
(``residual_in_fp32``), which a float32 reference cannot show.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from veltair_bench import roofline

def vocab_rows(c: dict) -> int:
    """Rows of the embedding and the head: the vocabulary padded."""
    pad = int(c.get("pad_vocab_size_multiple", 1))
    return -(-int(c["vocab_size"]) // pad) * pad


def port_fields(c: dict) -> dict:
    """The program's config attributes this file fixes (``ssm.x``: an
    attribute of its SSM block)."""
    return {"d_model": c["d_model"], "num_layers": c["n_layer"],
            "vocab_size": vocab_rows(c),
            "ssm.d_inner": c["expand"] * c["d_model"],
            "ssm.head_dim": c["headdim"], "ssm.state_dim": c["d_state"],
            "ssm.num_groups": c["ngroups"], "ssm.conv_width": c["d_conv"],
            "ssm.chunk_size": c["chunk_size"],
            "tie_embeddings": c["tie_embeddings"]}


def _dims(c: dict) -> dict:
    di = c["expand"] * c["d_model"]
    return {"n": c["n_layer"], "m": c["d_model"], "di": di,
            "h": di // c["headdim"], "p": c["headdim"], "g": c["ngroups"],
            "s": c["d_state"], "w": c["d_conv"]}


def layout(c: dict) -> list:
    """The weight tree: stacked per-layer leaves under blocks/ssm."""
    d = _dims(c)
    n, m, di, h, g, s, w = (d["n"], d["m"], d["di"], d["h"], d["g"], d["s"],
                            d["w"])
    conv = di + 2 * g * s
    bf, f32 = torch.bfloat16, torch.float32
    mx = ("blocks", "ssm", "mixer")
    return [
        (("embed", "embedding"), (vocab_rows(c), m), bf, "normal", 0.02),
        (("blocks", "ssm", "ln1", "scale"), (n, m), f32, "one_plus", 0.02),
        (mx + ("in_proj",), (n, m, 2 * di + 2 * g * s + h), bf, "normal",
         m ** -0.5),
        (mx + ("conv_w",), (n, w, conv), f32, "normal", w ** -0.5),
        (mx + ("conv_b",), (n, conv), f32, "normal", 0.02),
        (mx + ("A_log",), (n, h), f32, "log_uniform", (1.0, 16.0)),
        (mx + ("dt_bias",), (n, h), f32, "dt_bias", (1e-3, 0.1)),
        (mx + ("D",), (n, h), f32, "one_plus", 0.02),
        (mx + ("norm", "scale"), (n, di), f32, "one_plus", 0.02),
        (mx + ("out_proj",), (n, di, m), bf, "normal", di ** -0.5),
        (("final_norm", "scale"), (m,), f32, "one_plus", 0.02),
    ]


def _rms_norm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * scale.float()


def _ssd(x, dt, a, b, c):
    """x (L,H,P), dt (L,H), a (H,), b/c (L,G,N) -> y (L,H,P)."""
    seq, h, _ = x.shape
    g = b.shape[1]
    cs = torch.cumsum(dt.double() * a.double(), dim=0)          # (L,H)
    seg = cs[:, None, :] - cs[None, :, :]                       # (t,s,H)
    causal = torch.ones(seq, seq, dtype=torch.bool,
                        device=x.device).tril()[:, :, None]
    decay = torch.exp(torch.where(causal, seg, float("-inf"))).float()
    cb = torch.einsum("tgn,sgn->gts", c, b)                     # (G,t,s)
    cb = cb.repeat_interleave(h // g, dim=0)                    # (H,t,s)
    att = cb * decay.permute(2, 0, 1) * dt.t()[:, None, :]
    return torch.einsum("hts,shp->thp", att, x)


def logits(params: dict, tokens: torch.Tensor, positions, c: dict,
           mm) -> torch.Tensor:
    """float32 logits (len(positions), vocab) of ``tokens`` (L,)."""
    d = _dims(c)
    m, di, h, p, g, s, w = (d["m"], d["di"], d["h"], d["p"], d["g"],
                            d["s"], d["w"])
    eps = float(c["norm_epsilon"])
    seq = tokens.shape[0]
    emb = params["embed"]["embedding"]
    x = emb[tokens].float()
    ln1 = params["blocks"]["ssm"]["ln1"]["scale"]
    mx = params["blocks"]["ssm"]["mixer"]
    for i in range(d["n"]):
        u = _rms_norm(x, ln1[i], eps)
        zxbcdt = mm(u, mx["in_proj"][i])
        z, xbc, dt = (zxbcdt[:, :di], zxbcdt[:, di:2 * di + 2 * g * s],
                      zxbcdt[:, 2 * di + 2 * g * s:])
        cw = mx["conv_w"][i].float()                             # (W,C)
        xp = F.pad(xbc, (0, 0, w - 1, 0))
        xbc = sum(xp[j:j + seq] * cw[j] for j in range(w)) \
            + mx["conv_b"][i].float()
        xbc = F.silu(xbc)
        xs = xbc[:, :di].reshape(seq, h, p)
        bm = xbc[:, di:di + g * s].reshape(seq, g, s)
        cm = xbc[:, di + g * s:].reshape(seq, g, s)
        dt = F.softplus(dt + mx["dt_bias"][i].float())
        a = -torch.exp(mx["A_log"][i].float())
        y = _ssd(xs, dt, a, bm, cm) + mx["D"][i].float()[:, None] * xs
        y = y.reshape(seq, di) * F.silu(z)
        y = _rms_norm(y, mx["norm"]["scale"][i], eps)
        x = x + mm(y, mx["out_proj"][i])
    sel = torch.as_tensor(positions, device=x.device, dtype=torch.long)
    out = _rms_norm(x[sel], params["final_norm"]["scale"], eps)
    return mm(out, emb.t())


def kernel_work(c: dict, step: tuple) -> dict:
    """(flops, bytes) of each launch of the port's kernels in one model
    pass (see ``starcoder2.kernel_work``): a prefill chunk of two or more
    rows runs B4 in every layer; a decode step and a one-row chunk run
    the recurrence in plain operations, and no layer runs B1 or B2."""
    if step[0] == "decode" or step[1] < 2:
        return {}
    d = _dims(c)
    return {"b4": [roofline.ssd_scan(step[1], d["h"], d["p"], d["s"],
                                     c["chunk_size"], d["g"], True)]
            * d["n"]}


def token_flops(c: dict, pos: int) -> float:
    """Model FLOPs of one token, the output head left out: the in and out
    projections, the conv, and the state's update and readout."""
    d = _dims(c)
    m, di, h, g, s = d["m"], d["di"], d["h"], d["g"], d["s"]
    proj = 2 * m * (2 * di + 2 * g * s + h) + 2 * di * m
    conv = 2 * d["w"] * (di + 2 * g * s)
    return float(d["n"] * (proj + conv + 4 * h * d["p"] * s))


def head_flops(c: dict) -> float:
    """The output head's FLOPs for one token."""
    return 2.0 * c["d_model"] * vocab_rows(c)
