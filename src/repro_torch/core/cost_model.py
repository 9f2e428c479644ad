"""Analytical latency model under interference (the compiler's oracle).

A copy of ``repro.core.cost_model``: versions lie on a parallelism <->
locality trade-off, a version tuned for zero interference collapses under
contention, and interference attacks the shared resources only (LLC
capacity and DRAM bandwidth on the CPU platform, HBM bandwidth and ICI
links on the TPU platform).  The arithmetic and its order of operations
are the reference's, so the scheduler, the simulator and the runtime make
the same decisions in both packages.

Naming: the classes carry ``Torch*`` names and the reference's names are
aliases, because the repository's static analyzer
(``repro.analysis.callgraph``) keys classes by bare name and a second
class of the reference's name would merge with the reference's.  For the
same reason the reference's ``Interference.from_level`` is the function
:func:`level_interference` here: the analyzer resolves the reference's
calls of ``from_level`` by that method name being unique.

Beyond the reference's two platforms the port keeps the spec of the card
it runs on, :data:`H100_SXM`, whose units are streaming multiprocessors
(``unit="sm"``); :func:`hardware_spec_for` returns it after checking the
card against it.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TorchHardwareSpec:
    name: str
    n_units: int                 # cores (CPU), chips (TPU sub-mesh pool)
                                 # or SMs (GPU)
    unit: str                    # "core" | "chip" | "sm"
    flops_per_unit: float        # peak FLOP/s per unit
    private_cache_bytes: float   # L2 per core / VMEM per chip (tile must fit)
    shared_cache_bytes: float    # LLC (CPU); 0 => no shared cache (TPU)
    shared_bw: float             # contended bandwidth: DRAM+LLC bw (CPU),
                                 # HBM bw per chip (TPU co-residency)
    link_bw: float               # ICI per link (TPU); 0 => no comm term
    realloc_overhead_s: float    # thread respawn (CPU) / resharding (TPU)
    serial_overhead_s: float     # per-layer launch overhead
    amdahl_serial: float         # non-parallel fraction of layer work
    overlap: float = 1.0         # 1 = compute/mem/comm fully overlapped
    # compute-efficiency curve: eff(tile) = base + slope*log2(tile/64KiB),
    # clipped to [eff_min, eff_max] (calibrated against the paper's absolute
    # CPU latencies / realistic TPU MXU utilizations)
    eff_base: float = 0.28
    eff_slope: float = 0.06
    eff_min: float = 0.18
    eff_max: float = 0.55

    @property
    def cache_shared(self) -> bool:
        return self.shared_cache_bytes > 0


HardwareSpec = TorchHardwareSpec


# Measured on the card by ``chip_smoke.py`` (NVIDIA H100 80GB HBM3 at
# 700 W, full-width gemma-2b): a level switch between two captured
# versions, a dictionary swap of CUDA graphs (12.25 us, mean of 200 in
# the level sweep), and the mean idle gap between consecutive device ops
# of a graphed 8-step decode quantum (0.442 us, torch.profiler).
H100_SWITCH_S = 12.25e-6
H100_NODE_GAP_S = 0.442e-6

# Paper platform: AMD Threadripper 3990X, 64 cores, AVX2 @2.9GHz,
# 256 MB LLC, quad-channel DDR4-3200 (~100 GB/s), ~1 TB/s aggregate LLC bw.
CPU_3990X = HardwareSpec(
    name="amd-3990x", n_units=64, unit="core",
    flops_per_unit=46.4e9,           # 16 fp32 FLOP/cycle * 2.9 GHz
    private_cache_bytes=512e3,       # L2 per core
    shared_cache_bytes=256e6,
    shared_bw=100e9,                 # quad-channel DDR4-3200 DRAM
    link_bw=0.0,
    realloc_overhead_s=220e-6,       # measured thread-spawn cost (Fig. 5b)
    serial_overhead_s=8e-6,
    amdahl_serial=0.005,
    # calibrated against Fig. 1a (~300 QPS solo on 64 cores => ~3.3 ms
    # ResNet-50) and Fig. 3b (18.5 ms at the layer-wise allocation)
    eff_base=0.50, eff_slope=0.06, eff_min=0.35, eff_max=0.82,
)

# Target platform: one TPU v5e pod as the shared multi-tenant resource.
TPU_V5E_POD = HardwareSpec(
    name="tpu-v5e-pod", n_units=256, unit="chip",
    flops_per_unit=197e12,           # bf16
    private_cache_bytes=96e6,        # ~VMEM usable budget (structural)
    shared_cache_bytes=0.0,          # VMEM is private: no spill term
    shared_bw=819e9,                 # HBM per chip (shared by co-residents)
    link_bw=50e9,                    # per ICI link
    realloc_overhead_s=1e-3,         # program swap + weight re-layout
    serial_overhead_s=5e-6,
    amdahl_serial=0.01,
    eff_base=0.45, eff_slope=0.05, eff_min=0.30, eff_max=0.85,
)


# The port's card: one NVIDIA H100 SXM5 as the shared multi-tenant
# resource, its SMs the units the cluster partitions.  The shared cache is
# the L2 co-runners fight over, so the cost model's shared-cache branches
# apply (HBM bandwidth is one pool, not scaled by units).
H100_SXM = HardwareSpec(
    name="h100-sxm", n_units=132, unit="sm",     # H100 SXM5 datasheet: 132 SMs
    flops_per_unit=989e12 / 132,     # H100 SXM5 datasheet: 989 TFLOP/s
                                     # dense bf16, over the SMs
    private_cache_bytes=232_448,     # largest dynamic shared memory of a
                                     # block (227 KiB opt-in, H100 SXM5
                                     # datasheet), what the kernels size to
    shared_cache_bytes=50 * 2**20,   # H100 SXM5 datasheet: 50 MB L2 (the
                                     # card reports 50 MiB)
    shared_bw=3.35e12,               # H100 SXM5 datasheet: HBM3 3.35 TB/s
    link_bw=0.0,                     # one card: no collective term
    realloc_overhead_s=H100_SWITCH_S,
    serial_overhead_s=H100_NODE_GAP_S,
    amdahl_serial=0.01,
    # the efficiency curve (and the serial fraction) are TPU_V5E_POD's:
    # calibrating them against the card's measured solo speed is open
    eff_base=0.45, eff_slope=0.05, eff_min=0.30, eff_max=0.85,
)


def hardware_spec_for(device=None) -> HardwareSpec:
    """The spec of the card ``device`` names (``None`` means the current
    CUDA device): :data:`H100_SXM`, after checking its SM count, a
    block's opt-in shared memory (where torch reports it) and its L2
    against the constant.  Raises on a mismatch or a device with no spec;
    never substitutes another spec."""
    import torch
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise ValueError(f"no hardware spec for device {dev}: the port "
                         "models the card it runs on (pass a HardwareSpec, "
                         "e.g. CPU_3990X, for an analytic CPU plan)")
    props = torch.cuda.get_device_properties(dev)
    got = {"n_units": props.multi_processor_count,
           "private_cache_bytes": getattr(props,
                                          "shared_memory_per_block_optin",
                                          None),
           "shared_cache_bytes": getattr(props, "L2_cache_size", None)}
    spec = H100_SXM
    bad = {k: v for k, v in got.items()
           if v is not None and v != getattr(spec, k)}
    if bad:
        raise ValueError(
            f"{props.name}: " + ", ".join(
                f"{k} {v} (the {spec.name} spec has {getattr(spec, k)})"
                for k, v in bad.items())
            + "; the port has no spec for this card")
    return spec


@dataclasses.dataclass(frozen=True)
class TorchInterference:
    """Co-runner demand sums on each shared resource (fair-share model).

    Each field is the SUM of co-runner demands as a fraction of capacity
    (may exceed 1 under oversubscription).  Contention is fair-share:
    bandwidth time scales by (1 + bw); cache capacity is split
    proportionally to claims, so a victim whose claim c satisfies
    c + cache > 1 overflows by (c + cache - 1)."""
    cache: float = 0.0    # co-runner shared-cache claims (CPU only)
    bw: float = 0.0       # co-runner memory-bandwidth demand
    ici: float = 0.0      # co-runner link demand (TPU only)

    # level <-> resource mapping: level 1.0 == heavy co-location (LLC 2x
    # oversubscribed, bandwidth demand 1.5x capacity) — the top of the
    # paper's 10-level scale.
    CACHE_AT_1 = 2.0
    BW_AT_1 = 1.5
    ICI_AT_1 = 1.5

    @property
    def level(self) -> float:
        """Scalar pressure (what the paper's 10 discrete levels index)."""
        return min(max(self.cache / self.CACHE_AT_1,
                       self.bw / self.BW_AT_1,
                       self.ici / self.ICI_AT_1), 1.0)



Interference = TorchInterference


def level_interference(x: float) -> Interference:
    """The demand sums at pressure level ``x`` (the reference's
    ``Interference.from_level``)."""
    x = min(max(x, 0.0), 1.0)
    return Interference(cache=Interference.CACHE_AT_1 * x,
                        bw=Interference.BW_AT_1 * x,
                        ici=Interference.ICI_AT_1 * x)


NUM_LEVELS = 10  # paper: ten interference levels


def grid_point(i: int) -> float:
    """Level of grid index i.  Quadratically denser near 1.0 — on both
    platforms the version crossovers concentrate at high pressure (shared
    caches/bandwidth only saturate once co-runners claim most of them)."""
    return (i / (NUM_LEVELS - 1)) ** 0.5


def level_to_idx(level: float) -> int:
    x = min(max(level, 0.0), 1.0)
    return min(int(round(x * x * (NUM_LEVELS - 1))), NUM_LEVELS - 1)


def level_grid() -> list[Interference]:
    return [level_interference(grid_point(i))
            for i in range(NUM_LEVELS)]


@dataclasses.dataclass(frozen=True)
class TorchGemmLayer:
    """One schedulable layer, reduced to an effective GEMM.

    convs are im2col'd (m=OH*OW*B, k=Cin*KH*KW, n=Cout); transformer blocks
    aggregate their GEMMs into (m=tokens, k=d_model, n=flops/(2*m*k)).
    ``weight_bytes`` rides along for weight-traffic accounting.
    """
    name: str
    m: int
    k: int
    n: int
    itemsize: int = 4
    weight_bytes: float = 0.0
    comm_bytes_per_unit: float = 0.0   # TP collective bytes when sharded

    @property
    def flops(self) -> float:
        return 2.0 * self.m * self.k * self.n

    @property
    def io_bytes(self) -> float:
        return self.itemsize * (self.m * self.k + self.m * self.n) + \
            (self.weight_bytes or self.itemsize * self.k * self.n)


GemmLayer = TorchGemmLayer


@dataclasses.dataclass(frozen=True)
class TorchCodeVersion:
    """One compiled implementation of a layer (a point in the trade-off
    space).  ``parallelism`` = independent tiles x unroll (the paper's
    parallelism metric); ``tile_bytes`` = blocking size (locality metric)."""
    layer_name: str
    bm: int
    bk: int
    bn: int
    unroll: int
    parallelism: int
    tile_bytes: int
    flops: float
    mem_bytes: float            # shared-level traffic given this tiling
    naive_bytes: float          # traffic bound when reuse collapses
    resident_bytes: float = 0.0  # LLC-resident operand panels (pollution)
    comm_bytes_per_unit: float = 0.0
    mxu_efficiency: float = 1.0

    @property
    def locality(self) -> float:
        return float(self.tile_bytes)

    def key(self) -> tuple:
        return (self.bm, self.bk, self.bn, self.unroll)


CodeVersion = TorchCodeVersion


def _shared_traffic(hw: HardwareSpec, v: CodeVersion, units_eff: int,
                    itf: Interference) -> float:
    """Shared-memory traffic under pressure.  Versions whose tiles spill
    past the private cache (L2 per core) lean on the *shared* LLC for
    reuse — the paper's "interference-vulnerable high-locality" case:
    under cache oversubscription their fair share shrinks below their
    claim and reuse collapses toward the naive-traffic bound.  Small-tile
    versions are private-cache-resident and immune to the capacity term
    (but not to bandwidth contention)."""
    traffic = v.mem_bytes
    if hw.cache_shared and v.tile_bytes > hw.private_cache_bytes:
        claim_frac = (v.tile_bytes * units_eff + v.resident_bytes) \
            / hw.shared_cache_bytes
        total = claim_frac + itf.cache
        if total > 1.0:
            overflow = min(total - 1.0, 1.0)
            traffic = v.mem_bytes + overflow * (v.naive_bytes - v.mem_bytes)
    return traffic


def latency(hw: HardwareSpec, v: CodeVersion, units: int,
            itf: Interference) -> float:
    """Predicted latency (seconds) of one layer version on ``units`` units
    under interference ``itf``."""
    units = max(1, min(units, hw.n_units))
    units_eff = max(1, min(units, v.parallelism))

    # compute: private, unaffected by interference; Amdahl + launch overhead
    peak = hw.flops_per_unit * v.mxu_efficiency
    t_par = v.flops * (1.0 - hw.amdahl_serial) / (units_eff * peak)
    t_ser = v.flops * hw.amdahl_serial / peak
    t_comp = t_par + t_ser

    traffic = _shared_traffic(hw, v, units_eff, itf)
    # fair-share bandwidth: co-runner demand stretches memory time linearly
    bw_scale = 1.0 if hw.cache_shared else float(units)  # HBM scales w/ chips
    t_mem = traffic * (1.0 + itf.bw) / (hw.shared_bw * bw_scale)

    # collective term (TPU): TP all-reduce bytes over contended ICI links
    t_comm = 0.0
    if hw.link_bw > 0 and units > 1 and v.comm_bytes_per_unit > 0:
        comm = v.comm_bytes_per_unit * 2.0 * (units - 1) / units
        t_comm = comm * (1.0 + itf.ici) / hw.link_bw

    bound = max(t_comp, t_mem, t_comm)
    serial_sum = t_comp + t_mem + t_comm
    t = bound * hw.overlap + (1.0 - hw.overlap) * serial_sum
    return t + hw.serial_overhead_s


def units_required(hw: HardwareSpec, v: CodeVersion, budget_s: float,
                   itf: Interference) -> int:
    """Minimal units for latency(v, units) <= budget.

    If the budget is infeasible even on the whole machine (e.g. the layer
    is pinned on contended shared bandwidth, where extra units don't
    help), return the *knee* at this pressure — the smallest allocation
    within 5% of the best achievable — instead of demanding everything.
    Burning cores cannot buy back shared-resource time."""
    lo, hi = 1, hw.n_units
    best = latency(hw, v, hi, itf)
    target = budget_s if best <= budget_s else 1.05 * best
    while lo < hi:
        mid = (lo + hi) // 2
        if latency(hw, v, mid, itf) <= target:
            hi = mid
        else:
            lo = mid + 1
    return lo


def bw_demand(hw: HardwareSpec, v: CodeVersion, units: int,
              itf: Interference = Interference()) -> float:
    """Fraction of shared bandwidth this (version, units) consumes while
    running under conditions ``itf`` — the 'performance counter' the
    interference proxy reads.  Uses the *realized* traffic (a spilled
    chunk streams its collapsed-reuse bytes, not its blocked ideal), which
    is what closes the paper's contention feedback loop."""
    units_eff = max(1, min(units, v.parallelism))
    traffic = _shared_traffic(hw, v, units_eff, itf)
    t = latency(hw, v, units, itf)
    bw_scale = 1.0 if hw.cache_shared else float(max(units, 1))
    return min((traffic / t) / (hw.shared_bw * bw_scale), 1.0)


def cache_demand(hw: HardwareSpec, v: CodeVersion, units: int) -> float:
    """LLC occupancy a running chunk imposes on everyone else: its
    resident operand panels (all versions pollute with their streams) plus
    its active tiles when those live in the LLC."""
    if not hw.cache_shared:
        return 0.0
    units_eff = max(1, min(units, v.parallelism))
    claim = v.resident_bytes
    if v.tile_bytes > hw.private_cache_bytes:
        claim += v.tile_bytes * units_eff
    return min(claim / hw.shared_cache_bytes, 1.0)


def ici_demand(hw: HardwareSpec, v: CodeVersion, units: int,
               itf: Interference = Interference()) -> float:
    if hw.link_bw <= 0 or units <= 1 or v.comm_bytes_per_unit <= 0:
        return 0.0
    t = latency(hw, v, units, itf)
    comm = v.comm_bytes_per_unit * 2.0 * (units - 1) / units
    return min((comm / t) / hw.link_bw, 1.0)
