#!/usr/bin/env python3
"""Time every launch plan the expert matmul could take, on the card.

    PYTHONPATH=src python3 scripts/torch_expert_plans.py [--out FILE]

For each expert product of deepseek-moe-16b (64 experts, E 2048 and F
1408 both ways round, capacities 8 and 16: a decode tick and a chunk) and
mixtral-8x22b (8 experts, E 6144 and F 16384, capacity 16), with each
bucket filled as a top-k routing of the step's rows fills it (8 rows for
capacity 8, 32 for 16), it launches the expert kernel with every
candidate split of ``kernels/matmul.py::_mma_candidates`` at the one tile
width the kernel instantiates (64 columns, one tile a block) and prints
each one's time (CUDA events, L2-warm) beside the byte bound of the
non-empty experts' weights, marking the plan
``kernels/matmul.py::expert_plan`` picks.  Prints the card's name and
power limit first.  Needs the CUDA toolkit and a card; imports nothing of
JAX.
"""
from __future__ import annotations

import argparse
import json
import random
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

HBM_BYTES_PER_S = 3.35e12
SHAPES = (  # (name, experts, top-k, capacity, K, N)
    ("deepseek w_gate/w_up", 64, 6, 8, 2048, 1408),
    ("deepseek w_down", 64, 6, 8, 1408, 2048),
    ("deepseek w_gate/w_up", 64, 6, 16, 2048, 1408),
    ("deepseek w_down", 64, 6, 16, 1408, 2048),
    ("mixtral w_gate/w_up", 8, 2, 16, 6144, 16384),
    ("mixtral w_down", 8, 2, 16, 16384, 6144))


def time_us(torch, fn, iters=30):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="", help="also write the rows as JSON")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_expert_plans: no CUDA device", file=sys.stderr)
        return 3
    from repro_torch.kernels import build
    from repro_torch.kernels import matmul as mm
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    build.build_all()
    fn = build.kernel_function("matmul", "repro_expert_matmul",
                               mm._EXPERT_ARGTYPES)
    bf = torch.bfloat16
    rng = random.Random(0)
    rows = []
    for name, n, k, C, K, N in SHAPES:
        counts = [0] * n
        for _ in range(8 if C == 8 else 32):
            for e in rng.sample(range(n), k):
                counts[e] += 1
        counts = [min(c, C) for c in counts]
        x = torch.randn(n, C, K, device="cuda").to(bf)
        w = (0.02 * torch.randn(n, K, N, device="cuda")).to(bf)
        cnt = torch.tensor(counts, dtype=torch.int32, device="cuda")
        out = torch.empty(n, C, N, dtype=bf, device="cuda")
        hit = sum(c > 0 for c in counts)
        bound = hit * K * N * 2 / HBM_BYTES_PER_S * 1e6
        pick = mm.expert_plan(C, N, K, bf)
        stream = torch.cuda.current_stream().cuda_stream
        found = []
        for p in mm._mma_candidates(C, N, K, pick.bm, True, False):
            if p.bn != 64 or p.grid_n != p.n_tiles:
                continue

            def call(p=p):
                rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                        cnt.data_ptr(), n, C, N, K, 1, p.bm, p.bn, p.split,
                        p.grid_n, p.smem, 1, stream)
                build.check_launch(rc, "expert_matmul")

            found.append(dict(us=time_us(torch, call), split=p.split,
                              smem=p.smem, blocks_per_expert=p.blocks,
                              picked=p.split == pick.split))
        found.sort(key=lambda r: r["us"])
        print(f"{name} n={n} C={C} K={K} N={N}: {hit} experts hold rows, "
              f"bound_us={bound:.1f}; expert_plan split={pick.split}")
        for r in found:
            print(f"   us={r['us']:.1f} split={r['split']} "
                  f"smem={r['smem']} blocks/expert={r['blocks_per_expert']}"
                  f"{'  <- expert_plan' if r['picked'] else ''}")
        rows.append(dict(shape=name, n=n, C=C, K=K, N=N, experts_hit=hit,
                         bound_us=bound, candidates=found))
        del x, w, out
    if args.out:
        Path(args.out).write_text(json.dumps(dict(card=smi, rows=rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
