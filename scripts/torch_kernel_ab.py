#!/usr/bin/env python3
"""Kernel times and serve device time of two checkouts of the PyTorch port,
in turns, on one card.

    python3 scripts/torch_kernel_ab.py PARENT_DIR CHANGE_DIR [--rounds 1]
        [--phases serve serve-spec ...]

Each round runs PARENT, CHANGE, CHANGE, PARENT, every run in a fresh
process from that checkout's own ``chip_smoke.py``: it builds the
checkout's kernels, runs its kernel phase (``phase_kernels``: every kernel
against its plain version, and each kernel's graph-captured, L2-warm time
at the main path's shapes) and times the contiguous decode at S 256 and
1024, then traces the given serve phases (``phase_profile``: the phase's
workload under torch.profiler) and keeps their device time.  Prints one line per run, then one JSON line with every
reading.  Two versions are compared only inside one call: cards and hosts
differ between calls.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

RUN = r"""
import contextlib, io, json, re, sys
sys.path.insert(0, "src")
import torch
import torch.nn.functional as F
import chip_smoke as cs
from repro_torch.kernels import build
assert torch.cuda.is_available(), "no CUDA device"
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
build.build_all()
with contextlib.redirect_stdout(io.StringIO()):
    rows = cs.phase_kernels(torch, F)
out = {"kernel_us": {k: 1e3 * r["ms"] for k, r in rows.items()},
       "device_ms": {}}
# the contiguous decode at the serve shape and at tinyllama's longest lane,
# through the entry point both checkouts have (bf16, full lengths)
from repro_torch.kernels import ops
g = torch.Generator(device="cuda").manual_seed(0)
for S in (256, 1024):
    q = torch.randn(8, 8, 64, generator=g, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn(8, 8, S, 64, generator=g, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    L = torch.full((8,), S, dtype=torch.int32, device="cuda")
    out["kernel_us"][f"decode_attention_S{S}"] = 1e3 * cs.time_ms(
        lambda: ops.decode_attention(q, k, v, L), torch)
for name in sys.argv[1:]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cs.phase_profile(torch, name, 1.0)
    out["device_ms"][name] = float(
        re.search(r"device_ms=([0-9.]+)", buf.getvalue()).group(1))
print("AB " + json.dumps(out))
"""


def run(tree: Path, phases) -> dict:
    proc = subprocess.run([sys.executable, "-c", RUN, *phases], cwd=tree,
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
    ap.add_argument("--phases", nargs="*", default=[
        "serve", "serve-spec", "serve-int8", "serve-spec-int8"])
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    readings = []
    for rnd in range(args.rounds):
        for side in ("parent", "change", "change", "parent"):
            r = run(getattr(args, side), args.phases)
            readings.append(dict(round=rnd, side=side, **r))
            print(f"round {rnd} {side}: kernel_us="
                  + " ".join(f"{k}={v:.2f}" for k, v in r["kernel_us"].items())
                  + " device_ms="
                  + " ".join(f"{k}={v:.2f}" for k, v in r["device_ms"].items()),
                  flush=True)
    print(json.dumps({"card": smi, "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
