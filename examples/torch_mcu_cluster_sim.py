"""Reproduce the paper's evaluation on the calibrated Siracusa cluster model,
through the PyTorch port's copy of the model (``repro_torch.sim``: numpy
only, no JAX; the same tables as ``examples/mcu_cluster_sim.py``).

Prints the Fig. 4/5/6 tables: speedups, runtime breakdowns, energy/latency
for TinyLlama (AR + prompt), MobileBERT, and the 64-head scalability study.

    PYTHONPATH=src python examples/torch_mcu_cluster_sim.py
"""
from repro_torch.configs import get_config
from repro_torch.sim.simulator import simulate_model
from repro_torch.sim.siracusa import SiracusaConfig
from repro_torch.sim.workload import mobilebert_block, tinyllama_block


def main():
    cfg = SiracusaConfig()
    tl = get_config("tinyllama-42m")
    tl64 = get_config("tinyllama-42m-64h")
    mb = get_config("mobilebert")

    print("== TinyLlama-42M, autoregressive (paper Fig. 4a) ==")
    base = None
    for n in (1, 2, 4, 8):
        r = simulate_model(cfg, tinyllama_block(tl, "autoregressive", n), n, 8)
        base = base or r["t_block"]
        print(f"  {n} chips: {r['t_block']*1e3:7.3f} ms/block  "
              f"speedup {base/r['t_block']:5.1f}x  regime={r['regime']}")
    print("  paper: 26.1x @ 8 chips, 0.54 ms, 0.64 mJ")
    r8 = simulate_model(cfg, tinyllama_block(tl, "autoregressive", 8), 8, 8)
    print(f"  sim  : {base/r8['t_block']:.1f}x, {r8['t_block']*1e3:.2f} ms, "
          f"{r8['e_block']*1e3:.2f} mJ")

    print("== TinyLlama-42M, prompt (Fig. 4b) ==")
    base = None
    for n in (1, 2, 4, 8):
        r = simulate_model(cfg, tinyllama_block(tl, "prompt", n), n, 8)
        base = base or r["t_block"]
        print(f"  {n} chips: {r['t_block']*1e3:7.3f} ms/block  "
              f"speedup {base/r['t_block']:5.1f}x  (paper @8: 9.9x)")

    print("== MobileBERT (Fig. 4c) ==")
    base = None
    for n in (1, 2, 4):
        r = simulate_model(cfg, mobilebert_block(mb, n), n, 24)
        base = base or r["t_block"]
        print(f"  {n} chips: {r['t_block']*1e3:7.2f} ms/block  "
              f"speedup {base/r['t_block']:5.1f}x  (paper @4: 4.7x, 38.8 ms)")

    print("== Scaled TinyLlama 64 heads, 2-64 chips (Fig. 6) ==")
    base_t = base_e = None
    for n in (1, 2, 4, 8, 16, 32, 64):
        r = simulate_model(cfg, tinyllama_block(tl64, "autoregressive", n),
                           n, 8)
        base_t = base_t or r["t_block"]
        base_e = base_e or r["e_block"]
        print(f"  {n:3d} chips: speedup {base_t/r['t_block']:5.1f}x  "
              f"energy ratio {base_e/r['e_block']:4.2f}x  "
              f"regime={r['regime']}")
    print("  paper: 60.1x speedup, ~1.3x energy reduction @ 64 chips")


if __name__ == "__main__":
    main()
