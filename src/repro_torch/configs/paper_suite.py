"""A copy of ``repro.configs.paper_suite`` (pure Python). Classes carry
``Torch*`` names with the reference's names as aliases (see
``repro_torch.core.cost_model``).

The paper's evaluated workloads (MLPerf Server, Tbl. 2) as per-layer
GEMM-reduced profiles for the scheduler/compiler/simulator.

Convolutions are im2col'd: m = OH*OW (batch 1, the paper's serving regime),
k = Cin*KH*KW, n = Cout.  Depthwise convs: grouped — flops = HW*K2*C*2,
modelled as m=OH*OW, k=KH*KW, n=C with weight bytes C*K2.
QoS targets follow the paper's Tbl. 2 (ms).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.cost_model import GemmLayer

IT = 4  # fp32 on the CPU platform


def conv(name, hw_in, cin, cout, k=3, stride=1) -> GemmLayer:
    hw_out = (hw_in + stride - 1) // stride
    return GemmLayer(name=name, m=hw_out * hw_out, k=cin * k * k, n=cout,
                     itemsize=IT, weight_bytes=cin * k * k * cout * IT)


def dwconv(name, hw_in, c, k=3, stride=1) -> GemmLayer:
    hw_out = (hw_in + stride - 1) // stride
    return GemmLayer(name=name, m=hw_out * hw_out, k=k * k, n=c,
                     itemsize=IT, weight_bytes=k * k * c * IT)


def fc(name, k, n) -> GemmLayer:
    return GemmLayer(name=name, m=1, k=k, n=n, itemsize=IT,
                     weight_bytes=k * n * IT)


def resnet50() -> list[GemmLayer]:
    ls = [conv("conv1", 224, 3, 64, k=7, stride=2)]
    spec = [(56, 64, 64, 256, 3), (28, 128, 128, 512, 4),
            (14, 256, 256, 1024, 6), (7, 512, 512, 2048, 3)]
    cin = 64
    for hw, c1, c3, cout, reps in spec:
        for r in range(reps):
            stride = 2 if (r == 0 and hw != 56) else 1
            hin = hw * stride
            ls.append(conv(f"res{hw}_{r}_a", hin, cin, c1, k=1,
                           stride=stride))
            ls.append(conv(f"res{hw}_{r}_b", hw, c1, c3, k=3))
            ls.append(conv(f"res{hw}_{r}_c", hw, c3, cout, k=1))
            if r == 0:
                ls.append(conv(f"res{hw}_{r}_sc", hin, cin, cout, k=1,
                               stride=stride))
            cin = cout
    ls.append(fc("fc", 2048, 1000))
    return ls


def googlenet() -> list[GemmLayer]:
    ls = [conv("conv1", 224, 3, 64, k=7, stride=2),
          conv("conv2a", 56, 64, 64, k=1),
          conv("conv2b", 56, 64, 192, k=3)]
    # inception modules: (hw, cin, [b1, b3r, b3, b5r, b5, pool_proj])
    modules = [
        (28, 192, (64, 96, 128, 16, 32, 32)),
        (28, 256, (128, 128, 192, 32, 96, 64)),
        (14, 480, (192, 96, 208, 16, 48, 64)),
        (14, 512, (160, 112, 224, 24, 64, 64)),
        (14, 512, (128, 128, 256, 24, 64, 64)),
        (14, 512, (112, 144, 288, 32, 64, 64)),
        (14, 528, (256, 160, 320, 32, 128, 128)),
        (7, 832, (256, 160, 320, 32, 128, 128)),
        (7, 832, (384, 192, 384, 48, 128, 128)),
    ]
    for i, (hw, cin, (b1, b3r, b3, b5r, b5, pp)) in enumerate(modules):
        ls.append(conv(f"inc{i}_1x1", hw, cin, b1, k=1))
        ls.append(conv(f"inc{i}_3r", hw, cin, b3r, k=1))
        ls.append(conv(f"inc{i}_3x3", hw, b3r, b3, k=3))
        ls.append(conv(f"inc{i}_5r", hw, cin, b5r, k=1))
        ls.append(conv(f"inc{i}_5x5", hw, b5r, b5, k=5))
        ls.append(conv(f"inc{i}_pp", hw, cin, pp, k=1))
    ls.append(fc("fc", 1024, 1000))
    return ls


def ssd_vgg() -> list[GemmLayer]:
    ls = []
    vgg = [(300, 3, 64), (300, 64, 64), (150, 64, 128), (150, 128, 128),
           (75, 128, 256), (75, 256, 256), (75, 256, 256), (38, 256, 512),
           (38, 512, 512), (38, 512, 512), (19, 512, 512), (19, 512, 512),
           (19, 512, 512)]
    for i, (hw, cin, cout) in enumerate(vgg):
        ls.append(conv(f"vgg{i}", hw, cin, cout, k=3))
    extras = [(19, 512, 1024, 3), (19, 1024, 1024, 1), (19, 1024, 256, 1),
              (10, 256, 512, 3), (10, 512, 128, 1), (5, 128, 256, 3),
              (5, 256, 128, 1), (3, 128, 256, 3)]
    for i, (hw, cin, cout, k) in enumerate(extras):
        ls.append(conv(f"extra{i}", hw, cin, cout, k=k))
    heads = [(38, 512), (19, 1024), (10, 512), (5, 256), (3, 256), (1, 256)]
    for i, (hw, cin) in enumerate(heads):
        ls.append(conv(f"head{i}", hw, cin, 6 * (4 + 81), k=3))
    return ls


def mobilenet_v2() -> list[GemmLayer]:
    ls = [conv("conv1", 224, 3, 32, k=3, stride=2)]
    # (t_expand, cout, reps, stride) per the paper
    blocks = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
              (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
    hw, cin = 112, 32
    for bi, (t, cout, reps, stride) in enumerate(blocks):
        for r in range(reps):
            s = stride if r == 0 else 1
            ce = cin * t
            if t != 1:
                ls.append(conv(f"mb{bi}_{r}_e", hw, cin, ce, k=1))
            ls.append(dwconv(f"mb{bi}_{r}_d", hw, ce, k=3, stride=s))
            hw = (hw + s - 1) // s
            ls.append(conv(f"mb{bi}_{r}_p", hw, ce, cout, k=1))
            cin = cout
    ls.append(conv("conv_last", 7, 320, 1280, k=1))
    ls.append(fc("fc", 1280, 1000))
    return ls


def efficientnet_b0() -> list[GemmLayer]:
    ls = [conv("stem", 224, 3, 32, k=3, stride=2)]
    blocks = [(1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5),
              (6, 80, 3, 2, 3), (6, 112, 3, 1, 5), (6, 192, 4, 2, 5),
              (6, 320, 1, 1, 3)]
    hw, cin = 112, 32
    for bi, (t, cout, reps, stride, k) in enumerate(blocks):
        for r in range(reps):
            s = stride if r == 0 else 1
            ce = cin * t
            if t != 1:
                ls.append(conv(f"eff{bi}_{r}_e", hw, cin, ce, k=1))
            ls.append(dwconv(f"eff{bi}_{r}_d", hw, ce, k=k, stride=s))
            hw = (hw + s - 1) // s
            ls.append(conv(f"eff{bi}_{r}_p", hw, ce, cout, k=1))
            cin = cout
    ls.append(conv("head", 7, 320, 1280, k=1))
    ls.append(fc("fc", 1280, 1000))
    return ls


def tiny_yolov2() -> list[GemmLayer]:
    ls = []
    chans = [(416, 3, 16), (208, 16, 32), (104, 32, 64), (52, 64, 128),
             (26, 128, 256), (13, 256, 512), (13, 512, 1024),
             (13, 1024, 512)]
    for i, (hw, cin, cout) in enumerate(chans):
        ls.append(conv(f"conv{i}", hw, cin, cout, k=3))
    ls.append(conv("det", 13, 512, 425, k=1))
    return ls


def bert_large(seq: int = 128) -> list[GemmLayer]:
    """BERT-Large, MLPerf single-stream-ish seq 128 (seq 384 exceeds the
    64-core platform's roofline within the 130 ms QoS — the paper's served
    configuration must be the shorter-sequence one)."""
    d, f, layers = 1024, 4096, 24
    ls = []
    for i in range(layers):
        # qkv + attn-out + 2 ffn GEMMs aggregated into one effective GEMM
        flops = 2 * seq * d * (3 * d) + 2 * seq * d * d \
            + 2 * seq * seq * d * 2 + 2 * seq * d * f * 2
        n_eff = flops // (2 * seq * d)
        ls.append(GemmLayer(name=f"bert{i}", m=seq, k=d, n=int(n_eff),
                            itemsize=IT,
                            weight_bytes=(4 * d * d + 2 * d * f) * IT))
    return ls


@dataclasses.dataclass(frozen=True)
class TorchPaperModel:
    name: str
    workload_class: str       # light | medium | heavy
    qos_ms: float
    layers: tuple


PaperModel = TorchPaperModel


def paper_models() -> dict[str, PaperModel]:
    return {
        "resnet50": PaperModel("resnet50", "medium", 15.0,
                               tuple(resnet50())),
        "googlenet": PaperModel("googlenet", "medium", 15.0,
                                tuple(googlenet())),
        "efficientnet": PaperModel("efficientnet", "light", 10.0,
                                   tuple(efficientnet_b0())),
        "mobilenet_v2": PaperModel("mobilenet_v2", "light", 10.0,
                                   tuple(mobilenet_v2())),
        "ssd": PaperModel("ssd", "heavy", 100.0, tuple(ssd_vgg())),
        "tiny_yolov2": PaperModel("tiny_yolov2", "light", 10.0,
                                  tuple(tiny_yolov2())),
        "bert_large": PaperModel("bert_large", "heavy", 130.0,
                                 tuple(bert_large())),
    }


WORKLOAD_CLASSES = {
    "light": ("efficientnet", "mobilenet_v2", "tiny_yolov2"),
    "medium": ("resnet50", "googlenet"),
    "heavy": ("ssd", "bert_large"),
    "mix": ("resnet50", "googlenet", "efficientnet", "mobilenet_v2", "ssd",
            "tiny_yolov2", "bert_large"),
}
