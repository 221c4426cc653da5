"""Host-offload streaming executor: the paper's L3->L2 double buffering, one
level up the card's hierarchy (host memory -> HBM).

Port of the JAX package's ``runtime/offload.py``.  The paper streams the
NEXT transformer block's weights into on-chip memory while the current
block computes, hiding off-chip latency once on-chip memory holds one
block.  Here, when a model's weights exceed the card's memory (or HBM is
kept for KV pages), layer-group weights live in host memory and are staged
one group AHEAD of use.

On the card the host groups are pinned when the executor is built (a group
that cannot be pinned raises: a copy from pageable memory would serialise
with compute, silently), and two staging buffers on the card take the
groups in turn, as the paper's ping-pong buffers do.  ``stream_forward``
issues group i+1's copy into the other buffer with ``non_blocking=True`` on
a side CUDA stream before it runs group i; that copy first waits for the
compute of group i-1, which read the buffer last, and the compute stream
waits on the copy's event before it runs group i+1.  No memory is
allocated while a stream runs (an allocation may synchronise the card).
Group i's tensors are valid while ``group_fns[i]`` runs; group i+2's copy
overwrites them.  ``device="cpu"`` gives the plain copies.

Accounting: ``required_bandwidth`` tells whether streaming can be free
(weight bytes per group / group compute time <= the host link's rate): the
same arithmetic as the paper's §V-C double-buffer analysis.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List

import numpy as np
import torch

from repro_torch.core.device import resolve_device


@dataclass
class StreamStats:
    groups: int = 0
    stage_s: float = 0.0
    compute_s: float = 0.0


def tree_map(fn, tree):
    """``fn`` over the leaves of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def _pinned(a) -> torch.Tensor:
    """A host leaf as a pinned CPU tensor (numpy arrays are wrapped first);
    raises when the page-locked copy cannot be made."""
    t = torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) \
        else a
    if t.device.type != "cpu":
        raise ValueError(f"offload: a host group holds a tensor on {t.device}")
    if not t.is_pinned():
        t = t.pin_memory()
    if not t.is_pinned():
        raise RuntimeError("offload: a host group could not be pinned")
    return t


class OffloadExecutor:
    """Holds layer-group params on the host; stages group i+1 while the
    caller computes group i.  On the card ``timeline`` holds, per group of
    the last ``stream_forward``, the CUDA events around its copy (on the
    side stream) and its compute (on the compute stream)."""

    def __init__(self, host_groups: List, device="cuda"):
        self.device = resolve_device(device)
        self.stats = StreamStats()
        self.timeline: list = []
        if self.device.type == "cuda":
            self.host_groups = [tree_map(_pinned, g) for g in host_groups]
            self.copy_stream = torch.cuda.Stream(self.device)
            # the two staging buffers (group i goes to buffer i % 2), and the
            # event after the last compute that read each
            self._buffers = [tree_map(self._empty, g)
                             for g in self.host_groups[:2]]
            self._read = [None, None]
        else:
            self.host_groups = [
                tree_map(lambda a: torch.from_numpy(np.ascontiguousarray(a))
                         if isinstance(a, np.ndarray) else a, g)
                for g in host_groups]
            self.copy_stream = None

    def _empty(self, a):
        return torch.empty(a.shape, dtype=a.dtype, device=self.device)

    def _event(self):
        return torch.cuda.Event(enable_timing=True)

    def _put(self, i):
        """Group i on the device, the event its copy ends on and its
        timeline record (None and None on the CPU)."""
        group = self.host_groups[i]
        if self.copy_stream is None:
            return (tree_map(lambda a: a.to(self.device, copy=True), group),
                    None, None)
        slot = i % 2
        buf = self._buffers[slot]
        if [(t.shape, t.dtype) for t in tree_leaves(buf)] != \
                [(a.shape, a.dtype) for a in tree_leaves(group)]:
            raise ValueError(f"offload: group {i}'s layout differs from "
                             f"group {slot}'s, whose buffer it reuses")
        rec = {"group": i, "copy_start": self._event()}
        with torch.cuda.stream(self.copy_stream):
            if self._read[slot] is not None:     # group i-2's compute is done
                self.copy_stream.wait_event(self._read[slot])
            rec["copy_start"].record()
            for dst, src in zip(tree_leaves(buf), tree_leaves(group)):
                dst.copy_(src, non_blocking=True)
            rec["copy_end"] = self._event()
            rec["copy_end"].record()
        self.timeline.append(rec)
        return buf, rec["copy_end"], rec

    def stream_forward(self, x, group_fns: List[Callable]):
        """x -> group_fns[i](x, params_i) for each i, double-buffered."""
        assert len(group_fns) == len(self.host_groups)
        compute = (torch.cuda.current_stream(self.device)
                   if self.copy_stream is not None else None)
        self.timeline = []
        t0 = time.monotonic()
        staged, ready, rec = self._put(0)                # prologue
        self.stats.stage_s += time.monotonic() - t0
        for i, fn in enumerate(group_fns):
            nxt = (None, None, None)
            t0 = time.monotonic()
            if i + 1 < len(self.host_groups):
                nxt = self._put(i + 1)                   # on the side stream
            self.stats.stage_s += time.monotonic() - t0
            t0 = time.monotonic()
            if compute is not None:
                compute.wait_event(ready)
                rec["compute_start"] = self._event()
                rec["compute_start"].record(compute)
            x = fn(x, staged)
            if compute is not None:              # the buffer may be refilled
                rec["compute_end"] = self._read[i % 2] = self._event()
                rec["compute_end"].record(compute)
            self.stats.compute_s += time.monotonic() - t0
            staged, ready, rec = nxt
            self.stats.groups += 1
        return x


def host_link_rate(group, device="cuda") -> tuple:
    """(bytes per second, bytes) of one pinned host group copied to the
    card alone, into buffers made beforehand: the second of two copies,
    timed by CUDA events on a side stream."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("host_link_rate: the host link is a card's")
    src = tree_map(_pinned, group)
    dst = tree_map(lambda a: torch.empty(a.shape, dtype=a.dtype, device=dev),
                   src)
    side = torch.cuda.Stream(dev)
    torch.cuda.synchronize(dev)
    for _ in range(2):
        with torch.cuda.stream(side):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            for d, a in zip(tree_leaves(dst), tree_leaves(src)):
                d.copy_(a, non_blocking=True)
            end.record()
        end.synchronize()
    nbytes = sum(a.numel() * a.element_size() for a in tree_leaves(src))
    return nbytes / (start.elapsed_time(end) / 1e3), nbytes


def required_bandwidth(bytes_per_group: float, compute_s_per_group: float):
    """Host-link bandwidth needed for free streaming (paper §V-C logic)."""
    return bytes_per_group / max(compute_s_per_group, 1e-12)
