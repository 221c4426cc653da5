#!/usr/bin/env python3
"""Serve throughput of two checkouts of the PyTorch port, in turns, on one card.

    python3 scripts/torch_serve_ab.py PARENT_DIR CHANGE_DIR [--rounds 1]

Each round runs PARENT, CHANGE, CHANGE, PARENT, every run in a fresh
process from that checkout's own ``chip_smoke.py``: it builds the
checkout's kernels, then serves each of its serve phases once after the
phase's own warm-up (``phase_serve``: 16 requests, bf16 weights, each
checkout's default engine).  Prints one line per run and phase (tok/s,
wall, wall per tick, TTFT and TPOT p50), then one JSON line with every
reading.  Two versions are compared only inside one
call: the host's speed differs between machines by more than the change
(PERF.md §6).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

RUN = r"""
import io, json, re, sys, contextlib
sys.path.insert(0, "src")
import torch
import chip_smoke as cs
from repro_torch.kernels import build
assert torch.cuda.is_available(), "no CUDA device"
torch.backends.cuda.matmul.allow_tf32 = False
build.build_all()
out = {}
for name in cs.SERVE_PHASES:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cs.phase_serve(torch, name)
    line = buf.getvalue()
    out[name] = {k: float(re.search(rf" {k}=([0-9.]+)", line).group(1))
                 for k in ("ticks", "tok_per_s", "wall_s", "ttft_p50_ms",
                           "tpot_p50_ms")}
print("AB " + json.dumps(out))
"""


def run(tree: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=tree,
                          capture_output=True, text=True, timeout=1200)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise SystemExit(f"{tree}: exit {proc.returncode}")
    line = next(x for x in proc.stdout.splitlines() if x.startswith("AB "))
    return json.loads(line[3:])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("change", type=Path)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")
    readings = []
    for _ in range(args.rounds):
        for label, tree in (("parent", args.parent), ("change", args.change),
                            ("change", args.change), ("parent", args.parent)):
            phases = run(tree.resolve())
            readings.append({"side": label, "phases": phases})
            for name, r in phases.items():
                print(f"{label:6s} {name:17s} tok_per_s={r['tok_per_s']:7.1f} "
                      f"wall_s={r['wall_s']:.3f} ticks={r['ticks']:.0f} "
                      f"wall_per_tick_ms={1e3 * r['wall_s'] / r['ticks']:.3f} "
                      f"ttft_p50_ms={r['ttft_p50_ms']:.1f} "
                      f"tpot_p50_ms={r['tpot_p50_ms']:.2f}", flush=True)
    print(json.dumps({"card": smi, "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
