"""Analytical model of the Siracusa multi-MCU system (paper §II-B / §V-A).

Published constants are taken verbatim from the paper; the two quantities
GVSoC provides that the paper does not print (effective MAC throughput of
the 8-core cluster and the L3 interface bandwidth) are free parameters
fitted once by ``sim.calibrate`` against the paper's headline numbers and
then frozen here.  Energy follows the paper's equation:

    E = N_C2C*E_C2C + sum_j [ P*T_comp_j + N_L3_j*E_L3 + N_L2_j*E_L2 ]
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class SiracusaConfig:
    # --- published constants (paper §V-A) ------------------------------------
    freq_hz: float = 500e6
    n_cores: int = 8
    p_core_w: float = 13e-3            # avg power per core
    e_l3_per_byte: float = 100e-12
    e_l2_per_byte: float = 2e-12
    e_c2c_per_byte: float = 100e-12
    mipi_bw: float = 0.5e9             # 0.5 GB/s chip-to-chip
    l1_bytes: int = 256 * 1024
    l2_bytes: int = 2 * 1024 * 1024
    group: int = 4                     # hierarchical reduction fan-in (Fig. 1)

    # --- calibrated (sim.calibrate; GVSoC-derived, not printed in the paper) --
    macs_per_cycle_per_core: float = 1.25   # int8 effective (calibrated)
    l3_bw: float = 0.8e9                    # per-chip L3 DMA stream bandwidth
    demand_efficiency: float = 0.30         # non-DMA (demand) L3 access eff.
    mipi_latency_s: float = 4.0e-6          # per-hop setup latency
    kernel_k0: float = 2.0                  # small-kernel efficiency knee
    l2_bw: float = 16e9                     # 256 bit/cycle @ 500 MHz = 16 GB/s

    budget_fraction: float = 0.6       # share of on-chip SRAM usable for
                                       # resident weights (rest: activations,
                                       # buffers, code — GVSoC-derived)

    @property
    def onchip_budget(self) -> int:
        return int(self.budget_fraction * (self.l2_bytes + self.l1_bytes))

    @property
    def peak_macs(self) -> float:
        return self.n_cores * self.macs_per_cycle_per_core * self.freq_hz

    @property
    def p_cluster_w(self) -> float:
        return self.n_cores * self.p_core_w

    def with_(self, **kw):
        return replace(self, **kw)


def kernel_efficiency(cfg: SiracusaConfig, rows_per_core: float) -> float:
    """Sub-linear GEMM/GEMV scaling as per-core tiles shrink (paper §V-B:
    'the runtime of a GEMM kernel does not scale down linearly as the
    overall kernel size is reduced').  Modeled as a loop-overhead knee."""
    return rows_per_core / (rows_per_core + cfg.kernel_k0)
