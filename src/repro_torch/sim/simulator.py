"""Timeline + energy simulation of the multi-chip system (paper §V).

Per-block timeline:
  t_comp  = MACs / (peak * kernel_efficiency)         (cluster compute)
  t_sync  = hierarchical groups-of-4 all-reduce + broadcast-back over MIPI
  t_l3    = this block's weight slice over the chip's L3 interface

Residency regimes (the paper's central mechanism):
  * whole model fits on-chip        -> no L3 at all (32+ chips, scaled model)
  * one block fits (but model not)  -> next block's weights double-buffer
                                       UNDER compute: t = max(t_comp+t_sync,
                                       t_l3)  [super-linear speedup regime]
  * block does not fit              -> weights stream synchronously:
                                       t = t_comp + t_sync + t_l3
                                       (1-4 chip regime; no room to ping-pong)

Energy follows the paper's equation (§V-A); L3 energy is paid whenever
weights stream, regardless of overlap — which is why the 8-chip system is
26x faster but only ~equal energy, while 32+ chips also cut energy (Fig 5).
"""
from __future__ import annotations

from dataclasses import dataclass


from repro_torch.sim.siracusa import SiracusaConfig, kernel_efficiency
from repro_torch.sim.workload import BlockWorkload


@dataclass
class BlockResult:
    t_block: float
    t_comp: float
    t_sync: float
    t_l3_exposed: float
    e_block: float
    e_comp: float
    e_l3: float
    e_l2: float
    e_c2c: float
    resident: str      # 'model' | 'block' | 'streaming'


def hierarchical_allreduce_time(cfg: SiracusaConfig, payload: float,
                                n_chips: int) -> tuple:
    """Groups-of-4 tree reduce + broadcast back (paper Fig. 1).
    Returns (time, total_bytes_on_wire)."""
    if n_chips <= 1:
        return 0.0, 0.0
    t, total_bytes = 0.0, 0.0
    n = n_chips
    while n > 1:
        fan = min(cfg.group, n)
        senders = fan - 1
        # senders share the root's ingress link -> serialized
        t += senders * (payload / cfg.mipi_bw) + cfg.mipi_latency_s
        level_groups = max(1, n // fan)
        total_bytes += senders * level_groups * payload
        n = level_groups
    return 2 * t, 2 * total_bytes          # reduce + broadcast back


def simulate_block(cfg: SiracusaConfig, wl: BlockWorkload, n_chips: int,
                   model_bytes_per_chip: float) -> BlockResult:
    eff = kernel_efficiency(cfg, wl.min_rows_per_core)
    t_comp = wl.macs_per_chip / (cfg.peak_macs * eff)
    t_sync, wire_bytes = hierarchical_allreduce_time(
        cfg, wl.sync_payload_bytes, n_chips)
    t_sync *= wl.n_syncs
    wire_bytes *= wl.n_syncs

    # L2 streaming floor: weights must cross L2->L1 once per use
    t_l2 = wl.w_bytes_per_chip / cfg.l2_bw
    t_comp = max(t_comp, t_l2)

    if model_bytes_per_chip <= cfg.onchip_budget:
        # whole model resident per chip: no L3 at all
        regime, l3_bytes = "model", 0.0
        t_block = t_comp + t_sync
        t_l3_exposed = 0.0
    elif wl.w_bytes_per_chip * 2 <= cfg.onchip_budget:
        # one block fits twice -> DMA double-buffer of the NEXT block under
        # the current block's compute (paper §V-A); full stream bandwidth
        regime = "block"
        t_l3_stream = wl.w_bytes_per_chip / cfg.l3_bw
        t_block = max(t_comp + t_sync, t_l3_stream)
        t_l3_exposed = max(0.0, t_l3_stream - (t_comp + t_sync))
        l3_bytes = wl.w_bytes_per_chip
    else:
        # no room to ping-pong: operands are demand-fetched from L3 at the
        # (much lower) non-DMA efficiency; intermediates (KV cache,
        # activations) also live off-chip (paper §V-B single-chip regime)
        regime = "streaming"
        l3_bytes = wl.w_bytes_per_chip + wl.kv_bytes_per_chip + \
            wl.act_bytes_per_chip
        t_l3 = l3_bytes / (cfg.l3_bw * cfg.demand_efficiency)
        t_block = t_comp + t_sync + t_l3
        t_l3_exposed = t_l3

    l2_bytes = wl.w_bytes_per_chip + wl.act_bytes_per_chip + \
        (wl.kv_bytes_per_chip if regime != "streaming" else 0.0)

    # clusters burn power for the whole block (busy-wait on DMA/links),
    # matching GVSoC-style end-to-end latency x power accounting
    e_comp = n_chips * cfg.p_cluster_w * t_block
    e_l3 = n_chips * l3_bytes * cfg.e_l3_per_byte
    e_l2 = n_chips * l2_bytes * cfg.e_l2_per_byte
    e_c2c = wire_bytes * cfg.e_c2c_per_byte
    return BlockResult(t_block, t_comp, t_sync, t_l3_exposed,
                       e_comp + e_l3 + e_l2 + e_c2c,
                       e_comp, e_l3, e_l2, e_c2c, regime)


def simulate_model(cfg: SiracusaConfig, wl: BlockWorkload, n_chips: int,
                   n_blocks: int) -> dict:
    model_bytes_per_chip = wl.w_bytes_per_chip * n_blocks
    blk = simulate_block(cfg, wl, n_chips, model_bytes_per_chip)
    return {
        "n_chips": n_chips,
        "t_model": blk.t_block * n_blocks,
        "e_model": blk.e_block * n_blocks,
        "t_block": blk.t_block,
        "e_block": blk.e_block,
        "regime": blk.resident,
        "breakdown_t": {"comp": blk.t_comp * n_blocks,
                        "c2c": blk.t_sync * n_blocks,
                        "l3_exposed": blk.t_l3_exposed * n_blocks},
        "breakdown_e": {"comp": blk.e_comp * n_blocks,
                        "l3": blk.e_l3 * n_blocks,
                        "l2": blk.e_l2 * n_blocks,
                        "c2c": blk.e_c2c * n_blocks},
    }


def speedup_curve(cfg: SiracusaConfig, wl_fn, n_blocks: int,
                  chips: list) -> dict:
    runs = {n: simulate_model(cfg, wl_fn(n), n, n_blocks) for n in chips}
    base = runs[chips[0]]["t_model"]
    for r in runs.values():
        r["speedup"] = base / r["t_model"]
    return runs
