"""Calibrate the two GVSoC-derived free parameters of the Siracusa model.

Grid-search (macs_per_cycle_per_core, l3_bw, kernel_k0, mipi_latency)
against the paper's headline numbers:

    TinyLlama AR     8 chips : speedup 26.1x, 0.54 ms, 0.64 mJ / inference
    TinyLlama prompt 8 chips : speedup  9.9x
    MobileBERT       4 chips : speedup  4.7x
    TinyLlama-64h AR 64 chips: speedup 60.1x, energy reduction ~1.3x

Run:  PYTHONPATH=src python -m repro_torch.sim.calibrate
Writes the best-fit constants report; the chosen values are frozen in
``sim.siracusa.SiracusaConfig`` and validated by benchmarks/.
"""
from __future__ import annotations

import itertools

import numpy as np

from repro_torch.configs import get_config
from repro_torch.sim.simulator import simulate_model
from repro_torch.sim.siracusa import SiracusaConfig
from repro_torch.sim.workload import mobilebert_block, tinyllama_block


def paper_metrics(cfg: SiracusaConfig) -> dict:
    tl = get_config("tinyllama-42m")
    tl64 = get_config("tinyllama-42m-64h")
    mb = get_config("mobilebert")

    def run(model_cfg, mode, chips, n_blocks, wl_fn):
        out = {}
        for n in chips:
            wl = wl_fn(model_cfg, mode, n) if mode else wl_fn(model_cfg, n)
            out[n] = simulate_model(cfg, wl, n, n_blocks)
        return out

    ar = run(tl, "autoregressive", [1, 2, 4, 8], 8, tinyllama_block)
    pr = run(tl, "prompt", [1, 2, 4, 8], 8, tinyllama_block)
    ar64 = run(tl64, "autoregressive", [1, 8, 16, 32, 64], 8, tinyllama_block)
    mbr = run(mb, None, [1, 2, 4], 24,
              lambda c, n: mobilebert_block(c, n))
    # paper §V-A: runtime/energy are reported for a single transformer block
    return {
        "ar_speedup8": ar[1]["t_block"] / ar[8]["t_block"],
        "ar_t8_ms": ar[8]["t_block"] * 1e3,
        "ar_e8_mj": ar[8]["e_block"] * 1e3,
        "prompt_speedup8": pr[1]["t_block"] / pr[8]["t_block"],
        "mb_speedup4": mbr[1]["t_block"] / mbr[4]["t_block"],
        "mb_t4_ms": mbr[4]["t_block"] * 1e3,
        "ar64_speedup64": ar64[1]["t_block"] / ar64[64]["t_block"],
        "ar64_energy_ratio": ar64[1]["e_block"] / ar64[64]["e_block"],
        "_curves": {"ar": ar, "prompt": pr, "ar64": ar64, "mb": mbr},
    }


TARGETS = {
    "ar_speedup8": 26.1,
    "ar_t8_ms": 0.54,       # paper headline (per-block reporting, §V-A)
    "ar_e8_mj": 0.64,
    "prompt_speedup8": 9.9,
    "mb_speedup4": 4.7,
    "mb_t4_ms": 38.8,
    "ar64_speedup64": 60.1,
    "ar64_energy_ratio": 1.3,
}


def loss(metrics) -> float:
    return float(np.mean([np.log(max(metrics[k], 1e-9) / v) ** 2
                          for k, v in TARGETS.items()]))


def search():
    best = (1e9, None)
    grid = itertools.product(
        [1.0, 1.25, 1.5, 1.75, 2.0, 2.5],            # macs/cycle/core
        [0.4e9, 0.6e9, 0.8e9, 1.0e9, 1.4e9, 2.0e9],  # l3 stream bw
        [0.15, 0.2, 0.3, 0.45, 0.6],                 # demand efficiency
        [2.0, 4.0, 8.0, 12.0],                       # kernel knee
        [0.5e-6, 1e-6, 2e-6, 4e-6],                  # mipi latency
    )
    for mac, l3, eta, k0, lat in grid:
        cfg = SiracusaConfig().with_(macs_per_cycle_per_core=mac, l3_bw=l3,
                                     demand_efficiency=eta,
                                     kernel_k0=k0, mipi_latency_s=lat)
        m = paper_metrics(cfg)
        lv = loss(m)
        if lv < best[0]:
            best = (lv, (mac, l3, eta, k0, lat),
                    {k: m[k] for k in TARGETS})
    return best


def main():
    lv, params, metrics = search()
    mac, l3, eta, k0, lat = params
    print(f"best fit: macs/cyc/core={mac} l3_bw={l3/1e9:.2f}GB/s eta={eta} "
          f"k0={k0} mipi_lat={lat*1e6:.1f}us  (logloss {lv:.4f})")
    print(f"{'metric':20s} {'paper':>8s} {'sim':>8s} {'ratio':>7s}")
    for k, tgt in TARGETS.items():
        print(f"{k:20s} {tgt:8.2f} {metrics[k]:8.2f} {metrics[k]/tgt:7.2f}")
    return params, metrics


if __name__ == "__main__":
    main()
