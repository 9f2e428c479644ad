"""A copy of ``repro.core.schedule_space`` (pure Python).

Schedule-space enumeration (stands in for the Ansor search pass).

For a GEMM-reduced layer we enumerate (bm, bk, bn, unroll) candidates,
compute the paper's two metrics — parallelism (independent tiles x unroll)
and locality (blocking size in bytes) — and the traffic model the cost model
consumes.  The paper runs ~1024 auto-scheduler iterations per layer; our
space is the same knob set enumerated exhaustively (it is small enough), so
"single pass" here means exactly what Alg. 1 needs: one enumeration serving
all interference levels.
"""
from __future__ import annotations

import math
from typing import Iterable

from repro_torch.core.cost_model import CodeVersion, GemmLayer, HardwareSpec

TILES = (32, 64, 128, 256, 512, 1024, 2048)
UNROLLS = (1, 2, 4)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _clip_tiles(dim: int, tiles: Iterable[int]) -> list[int]:
    out = sorted({min(t, dim) for t in tiles})
    return out


def enumerate_versions(layer: GemmLayer, hw: HardwareSpec,
                       tiles: Iterable[int] = TILES,
                       unrolls: Iterable[int] = UNROLLS) -> list[CodeVersion]:
    """All tile/unroll candidates whose working set fits the private cache."""
    out: list[CodeVersion] = []
    it = layer.itemsize
    m, k, n = layer.m, layer.k, layer.n
    # CPU: tiles may target the LLC (that *is* the locality knob the paper
    # searches over); TPU: tiles must fit VMEM, hard constraint.
    tile_limit = (hw.shared_cache_bytes * 0.5 if hw.cache_shared
                  else hw.private_cache_bytes)

    def blocked_traffic(tm, tk, tn):
        # A panel re-read per N-tile, B panel per M-tile, C streamed
        return it * (m * k * _ceil_div(n, tn) + k * n * _ceil_div(m, tm)
                     + 2 * m * n)

    # reuse-collapse bound: L1-resident micro-tiles survive eviction
    # (calibrated so the most vulnerable version degrades ~7x, Fig. 6a)
    naive_all = blocked_traffic(min(16, m), k, min(16, n))
    for bm in _clip_tiles(m, tiles):
        for bk in _clip_tiles(k, tiles):
            for bn in _clip_tiles(n, tiles):
                tile_bytes = (bm * bk + bk * bn) * it + bm * bn * 4
                if tile_bytes > tile_limit:
                    continue
                n_tiles = _ceil_div(m, bm) * _ceil_div(n, bn)
                mem = blocked_traffic(bm, bk, bn)
                naive = max(naive_all, mem)
                for u in unrolls:
                    # unroll widens ILP (parallelism metric); compute
                    # efficiency grows with tile size (deeper pipelining /
                    # MXU utilization) — this is why the solo-optimal
                    # version is a big-tile one (paper Fig. 6a impl-1).
                    eff = hw.eff_base + hw.eff_slope * math.log2(
                        max(tile_bytes, 1024) / 65536.0)
                    eff = min(max(eff, hw.eff_min), hw.eff_max)
                    eff = min(eff + 0.02 * math.log2(u), hw.eff_max + 0.05)
                    out.append(CodeVersion(
                        layer_name=layer.name, bm=bm, bk=bk, bn=bn, unroll=u,
                        parallelism=n_tiles * u,
                        tile_bytes=tile_bytes,
                        flops=layer.flops,
                        mem_bytes=float(mem),
                        naive_bytes=float(naive),
                        resident_bytes=float(layer.io_bytes),
                        comm_bytes_per_unit=layer.comm_bytes_per_unit,
                        mxu_efficiency=eff,
                    ))
    return out


def default_version(layer: GemmLayer, hw: HardwareSpec) -> CodeVersion:
    """The 'solo-tuned' version: best at zero interference (TVM default)."""
    from repro_torch.core.cost_model import Interference, latency
    vs = enumerate_versions(layer, hw)
    return min(vs, key=lambda v: latency(hw, v, hw.n_units, Interference()))
