"""The system under test, built as a user of the port builds it, and one
serve of a generated request list through it.

``repro_torch.serving.cluster.make_cluster`` stands up one engine per
tenant (its own CUDA stream, version cache and interference level) over
plans from ``cluster_plans`` for the card's spec, exactly as the program
makes them; ``ClusterRuntime`` serves them in wall-clock mode with the
VELTAIR policy on measured counters, the SLO scheduler and fused quanta.
The weights are the harness's (``weights.py``), handed to the program
and kept for the reference.
"""
from __future__ import annotations

import dataclasses
import gc
import time

from veltair_bench import references, weights
from veltair_bench.calls import Stamps


@dataclasses.dataclass
class Tenant:
    name: str
    ref: object                  # its reference module
    config: dict                 # the configuration file's sizes
    limit: float | None          # the largest logit gap a correct run has
    params: dict                 # weights, shared with the program


@dataclasses.dataclass
class Served:
    """One serve: the requests as stamped and what the engines counted."""
    reqs: list
    t_open: float
    t_close: float
    ticks: int
    inside_s: float
    held_s: float
    chunks: list
    quanta: list
    tokens: dict                 # tenant -> tokens decoded in the serve
    syncs: dict                  # tenant -> host syncs in the serve


def tenant_seed(seed: int, i: int) -> int:
    return (int(seed) * 1_000_003 + i) % (1 << 63)


def port_config(cfg, fields: dict):
    """The program's config with ``fields`` (``attr`` or ``sub.attr``)
    set to the configuration file's values."""
    top, sub = {}, {}
    for key, val in fields.items():
        if "." in key:
            part, attr = key.split(".", 1)
            sub.setdefault(part, {})[attr] = val
        else:
            top[key] = val
    for part, vals in sub.items():
        top[part] = dataclasses.replace(getattr(cfg, part), **vals)
    return dataclasses.replace(cfg, **top)


def check_layout(model, params: dict) -> None:
    """The harness's weight tree has the program's paths, shapes and
    dtypes."""
    from repro_torch.models.params import tree_leaves_with_path
    want = {p: (tuple(s.shape), s.dtype)
            for p, s in tree_leaves_with_path(model.param_specs())}
    got = {p: (tuple(a.shape), a.dtype) for p, a in weights.leaves(params)}
    if want != got:
        diff = sorted(set(want.items()) ^ set(got.items()))
        raise ValueError(f"weight layout differs from the program's: "
                         f"{diff[:6]}")


class System:
    def __init__(self, config: dict, seed: int, device, *, hw=None):
        import torch
        from repro_torch.configs import get_config
        from repro_torch.core import cost_model as cm
        from repro_torch.core.scheduler import VeltairPolicy
        from repro_torch.models.model import Model
        from repro_torch.serving.cluster import ClusterRuntime, make_cluster
        from repro_torch.serving.tenants import cluster_plans

        self.device = torch.device(device)
        self.hw = hw if hw is not None else cm.hardware_spec_for(self.device)
        self.tenants: list[Tenant] = []
        cfgs, params = {}, {}
        for i, spec in enumerate(config["tenants"]):
            ref = references.load(spec["reference"])
            cfg = port_config(get_config(spec["port_config"]),
                              ref.port_fields(spec["config"]))
            tree = weights.make(ref.layout(spec["config"]),
                                tenant_seed(seed, i), self.device)
            check_layout(Model(cfg), tree)
            name = spec["model"]
            cfgs[name], params[name] = cfg, tree
            self.tenants.append(Tenant(name, ref, spec["config"],
                                       spec.get("logit_gap_limit"), tree))
        names = [t.name for t in self.tenants]
        eng = config["engine"]
        self.cluster = make_cluster(
            names, self.hw, batch_slots=eng["batch_slots"],
            max_len=eng["max_len"], plans=cluster_plans(names, self.hw),
            configs=cfgs, params=params, device=self.device)
        self._policy, self._runtime = VeltairPolicy, ClusterRuntime
        ClusterRuntime(self.cluster, VeltairPolicy(self.hw),
                       self.hw).warmup()
        self.capture_s = {t.name: t.engine.version_cache.capture_s
                          for t in self.cluster}
        self.sync()

    def sync(self) -> None:
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)

    def serve(self, reqs: list, seed: int, slice_=None) -> Served:
        """Serve ``reqs`` once; the window opens when this is called."""
        from repro_torch.serving.runtime import Workload
        rt = self._runtime(self.cluster, self._policy(self.hw), self.hw,
                           wall_clock=True, counter_source="measured",
                           scheduler="slo", fused=True, seed=int(seed))
        wl = Workload(arrivals=[(r.offset, r.tenant) for r in reqs],
                      prompt_len=max(len(r.prompt) for r in reqs),
                      max_new_tokens=max(r.out_tokens for r in reqs) - 1,
                      seed=int(seed))
        engines = {t.name: t.engine for t in self.cluster}
        tok0 = {n: e.tokens_decoded for n, e in engines.items()}
        sync0 = {n: e.host_syncs for n, e in engines.items()}
        stamps = Stamps(self.cluster, reqs, slice_=slice_)
        self.sync()
        t_open = time.perf_counter()
        stamps.t_open = t_open
        for r in reqs:
            r.due = t_open + r.offset
        try:
            rt.serve(wl)
        finally:
            stamps.close()
        self.sync()
        t_close = time.perf_counter()
        if slice_ is not None and slice_.active:
            slice_.end()          # the serve ended inside the slice
        return Served(
            reqs=reqs, t_open=t_open, t_close=t_close, ticks=rt.ticks,
            inside_s=stamps.inside_s, held_s=stamps.held_s,
            chunks=stamps.chunks, quanta=stamps.quanta,
            tokens={n: e.tokens_decoded - tok0[n] for n, e in engines.items()},
            syncs={n: e.host_syncs - sync0[n] for n, e in engines.items()})

    def free(self) -> None:
        """Drop the engines (caches, graphs); the weights stay for the
        reference."""
        self.cluster = None
        gc.collect()
        if self.device.type == "cuda":
            import torch
            torch.cuda.empty_cache()
