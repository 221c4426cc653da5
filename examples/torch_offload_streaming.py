"""Host-offload streaming on the card: the paper's L3->L2 double buffering,
one tier up, through the PyTorch port (``repro_torch.runtime.offload``).

The paper streams the NEXT transformer block's weights into on-chip memory
while the current block computes (§V-A).  This example runs the same
discipline between host memory ("L3") and the card's HBM ("L2"): layer-group
weights live pinned on the host; group i+1 is copied on a side CUDA stream,
into the other of two staging buffers, while group i computes through the
port's matmul kernel.  It reports the
overlap achieved, the host link's rate measured on this card, and the
bandwidth the paper's §V-C analysis says is needed for streaming to be free.
The counterpart of ``examples/offload_streaming.py``.

    PYTHONPATH=src python examples/torch_offload_streaming.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.runtime.offload import (OffloadExecutor, host_link_rate,
                                         required_bandwidth)


def group_fwd(x, p):
    """Two matmul layers of one group: x + silu(x w1) w2, x (T, E)."""
    h = torch.nn.functional.silu(ops.matmul(x, p["w1"]))
    return x + ops.matmul(h, p["w2"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (pinned copies on a side stream) or cpu")
    args = ap.parse_args(argv)
    # a toy "model": 8 groups of 2 matmul layers, weights held on HOST
    E, F, B, S = 512, 2048, 8, 128
    n_groups = 8
    rng = np.random.RandomState(0)
    host_groups = [
        {"w1": rng.randn(E, F).astype(np.float32) * 0.02,
         "w2": rng.randn(F, E).astype(np.float32) * 0.02}
        for _ in range(n_groups)
    ]
    execu = OffloadExecutor(host_groups, device=args.device)
    dev = execu.device
    x = torch.from_numpy(rng.randn(B * S, E).astype(np.float32)).to(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # cold pass (includes the kernels' build)
    execu.stream_forward(x, [group_fwd] * n_groups)
    sync()

    # measured pass
    execu = OffloadExecutor(execu.host_groups, device=dev)
    t0 = time.perf_counter()
    y = execu.stream_forward(x, [group_fwd] * n_groups)
    sync()
    wall = time.perf_counter() - t0

    bytes_per_group = sum(a.nbytes for a in host_groups[0].values())
    st = execu.stats
    print(f"groups={st.groups}  wall={wall*1e3:.1f}ms  "
          f"stage(dispatch)={st.stage_s*1e3:.1f}ms  "
          f"compute(dispatch)={st.compute_s*1e3:.1f}ms")
    print(f"weights/group = {bytes_per_group/1e6:.1f} MB")
    need = required_bandwidth(bytes_per_group, wall / st.groups)
    print(f"host-link bandwidth for FREE streaming (paper §V-C logic): "
          f">= {need/1e9:.2f} GB/s")
    if dev.type == "cuda":
        link, _ = host_link_rate(host_groups[0], dev)
        print(f"on {torch.cuda.get_device_name(dev)}: pinned host-to-device "
              f"copy measured at {link/1e9:.1f} GB/s => streaming is "
              f"{'free' if need < link else 'exposed'} at this compute "
              f"intensity")
    else:
        print("on the CPU: no host link to measure (plain copies)")
    # correctness vs all-resident execution
    ref = x
    for p in host_groups:
        ref = group_fwd(ref, {k: torch.from_numpy(v).to(dev)
                              for k, v in p.items()})
    err = float((ref - y).abs().max())
    print(f"max |offloaded - resident| = {err:.2e}")
    assert err < 1e-5
    print("OK")


if __name__ == "__main__":
    main()
