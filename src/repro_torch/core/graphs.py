"""Compiled steps: the port's counterpart of the JAX steps' ``jax.jit``.

The JAX package compiles every serving step once (``jax.jit`` with the
cache donated) and replays it for every request mix.  Here a step is
captured once into a CUDA graph and replayed:

- ``compile_step(fn, inputs)`` runs ``fn(*inputs)`` a few times on a side
  stream (Triton compiles its kernels on first call, the CUDA kernels
  raise their shared-memory limits), then captures one call with
  ``torch.cuda.CUDAGraph`` on the inputs' device.  The inputs are the
  step's static buffers: the caller copies each call's values into them
  (the serving engine, from pinned host staging) and calls the step, which
  replays.  The outputs are static too, overwritten by every replay.
- The cache needs no donation and no copy back: every step updates its
  pools, slabs and lanes in place at fixed addresses.  Each step's shapes
  are fixed when it is made, so one graph serves every request mix.
- The cyclic garbage collector is off while a capture is open: an
  unreachable engine collected then would destroy its graphs inside the
  capture, which fails it.
- A capture that fails raises; nothing falls back to running eagerly.
  ``EagerStep`` is the uncompiled form with the same interface, what the
  engine runs with ``graphs=False`` (the counterpart of
  ``jax.disable_jit``) and what ``compile_step`` returns for CPU inputs:
  the caller asked for the CPU.

Launch counts (``kernels.ops``): a wrapper counts a launch where it
launches its kernel, and a graph replay launches again every kernel the
capture recorded.  So capture counts nothing (it launches nothing: the
counts are put back as they were) and each replay adds the captured
call's counts, per wrapper.  ``CompiledStep.launches`` holds them.  The
MoE layers' device counters of pairs dropped by capacity are put back
after the warm-up calls too (``core.moe``): a replay adds its own.
"""
from __future__ import annotations

import gc

import torch

from repro_torch.core import moe
from repro_torch.kernels import ops

WARMUP_CALLS = 2


class EagerStep:
    """``fn(*inputs)`` on every call: the step as plain PyTorch."""
    graph = None

    def __init__(self, fn, inputs):
        self.fn, self.inputs = fn, tuple(inputs)
        self.outputs = None
        self.calls = 0

    def __call__(self):
        self.outputs = tuple(self.fn(*self.inputs))
        self.calls += 1
        return self.outputs


class CompiledStep:
    """One captured call of a step, replayed on every call.  ``inputs``
    and ``outputs`` are the static buffers; ``graph`` is the
    ``torch.cuda.CUDAGraph`` (kept, so its nodes can be read);
    ``launches`` the counted kernel launches of one replay, per wrapper;
    ``pool_bytes`` the memory the capture reserved for the graph's
    intermediates."""

    def __init__(self, fn, inputs):
        self.fn, self.inputs = fn, tuple(inputs)
        dev = self.inputs[0].device
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        drops = moe.drop_counters()
        with torch.cuda.device(dev), torch.cuda.stream(side):
            for _ in range(WARMUP_CALLS):
                fn(*self.inputs)
        main.wait_stream(side)
        torch.cuda.synchronize(dev)
        moe.restore_drop_counters(drops)
        before = ops.launch_counts()
        # capture starts by emptying the cache: measure from there, so the
        # difference is the graph's own pool
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        # an engine is a reference cycle (its steps call back into it), so
        # an unreachable one is freed by the cyclic collector, whenever it
        # runs; destroying its graphs while this capture is open fails the
        # capture ("operation not permitted when stream is capturing"): no
        # automatic collection until the capture ends
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.device(dev):
                with torch.cuda.graph(self.graph):
                    self.outputs = tuple(fn(*self.inputs))
                self.graph.instantiate()
        finally:
            if collecting:
                gc.enable()
        torch.cuda.synchronize(dev)
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        after = ops.launch_counts()
        self.launches = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}
        ops.set_launch_counts(before)        # the capture launched nothing
        self.calls = 0

    def __call__(self):
        self.graph.replay()
        ops.add_launches(self.launches)
        self.calls += 1
        return self.outputs


def compile_step(fn, inputs):
    """The step ``fn`` over its static ``inputs`` (tensors on one device),
    returning a tuple of tensors: captured in a CUDA graph on the card,
    eager for CPU inputs.  -> a callable ``step()`` that runs the step on
    what the static inputs hold and returns its static outputs."""
    if not inputs[0].is_cuda:
        return EagerStep(fn, inputs)
    return CompiledStep(fn, inputs)
