"""The port's copy of the paper's analytical multi-MCU model
(``repro_torch.sim``) against the JAX package's (``repro.sim``): the same
workloads, timelines, energies and calibration metrics, compared with
exact ``==`` (both are the same numpy arithmetic on the same constants).
``calibrate.search()`` is never called: its grid is walked at its corners
only.  The port's example prints the JAX example's tables."""
import contextlib
import dataclasses
import importlib.util
import io
import itertools
from pathlib import Path

import pytest

from repro.configs import get_config as jax_config
from repro.sim import calibrate as j_cal
from repro.sim import simulator as j_sim
from repro.sim import siracusa as j_sir
from repro.sim import workload as j_wl
from repro_torch.configs import PAPER_MODELS
from repro_torch.configs import get_config as port_config
from repro_torch.sim import calibrate as t_cal
from repro_torch.sim import simulator as t_sim
from repro_torch.sim import siracusa as t_sir
from repro_torch.sim import workload as t_wl

ROOT = Path(__file__).resolve().parents[1]

# (model, mode, chips, blocks): every point examples/mcu_cluster_sim.py and
# the Fig. 4-6 scripts sweep
POINTS = ([("tinyllama-42m", mode, n, 8) for mode in ("autoregressive", "prompt")
           for n in (1, 2, 4, 8)] +
          [("mobilebert", None, n, 24) for n in (1, 2, 4)] +
          [("tinyllama-42m-64h", mode, n, 8)
           for mode in ("autoregressive", "prompt")
           for n in (1, 2, 4, 8, 16, 32, 64)])

# calibrate.search()'s grid (src/repro/sim/calibrate.py), by parameter
GRID = {"macs_per_cycle_per_core": (1.0, 1.25, 1.5, 1.75, 2.0, 2.5),
        "l3_bw": (0.4e9, 0.6e9, 0.8e9, 1.0e9, 1.4e9, 2.0e9),
        "demand_efficiency": (0.15, 0.2, 0.3, 0.45, 0.6),
        "kernel_k0": (2.0, 4.0, 8.0, 12.0),
        "mipi_latency_s": (0.5e-6, 1e-6, 2e-6, 4e-6)}
CORNERS = [dict(zip(GRID, c)) for c in
           itertools.product(*[(v[0], v[-1]) for v in GRID.values()])]


def _workloads(name, mode, n):
    if mode is None:
        return (j_wl.mobilebert_block(jax_config(name), n),
                t_wl.mobilebert_block(port_config(name), n))
    return (j_wl.tinyllama_block(jax_config(name), mode, n),
            t_wl.tinyllama_block(port_config(name), mode, n))


@pytest.mark.parametrize("name", PAPER_MODELS)
def test_paper_configs_are_copies(name):
    j, t = jax_config(name), port_config(name)
    shared = {f.name for f in dataclasses.fields(t)}
    assert shared <= {f.name for f in dataclasses.fields(j)}
    assert {k: getattr(t, k) for k in shared} == \
        {k: getattr(j, k) for k in shared}
    assert t.is_encoder_only == j.is_encoder_only


def test_siracusa_config_is_a_copy():
    j, t = j_sir.SiracusaConfig(), t_sir.SiracusaConfig()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.onchip_budget, t.peak_macs, t.p_cluster_w) == \
        (j.onchip_budget, j.peak_macs, j.p_cluster_w)
    for rows in (0.5, 1.0, 7.0, 256.0):
        assert t_sir.kernel_efficiency(t, rows) == \
            j_sir.kernel_efficiency(j, rows)


@pytest.mark.parametrize("name,mode,n,blocks", POINTS,
                         ids=[f"{p[0]}-{p[1] or 'encoder'}-{p[2]}" for p in POINTS])
def test_simulate_model_equals_jax(name, mode, n, blocks):
    jw, tw = _workloads(name, mode, n)
    assert dataclasses.asdict(tw) == dataclasses.asdict(jw)
    got = t_sim.simulate_model(t_sir.SiracusaConfig(), tw, n, blocks)
    want = j_sim.simulate_model(j_sir.SiracusaConfig(), jw, n, blocks)
    assert got == want          # every field, the breakdowns too, exactly


@pytest.mark.parametrize("name,mode,chips,blocks", [
    ("tinyllama-42m", "autoregressive", [1, 2, 4, 8], 8),
    ("tinyllama-42m", "prompt", [1, 2, 4, 8], 8),
    ("tinyllama-42m-64h", "autoregressive", [1, 2, 4, 8, 16, 32, 64], 8)])
def test_speedup_curve_equals_jax(name, mode, chips, blocks):
    got = t_sim.speedup_curve(
        t_sir.SiracusaConfig(),
        lambda n: t_wl.tinyllama_block(port_config(name), mode, n), blocks, chips)
    want = j_sim.speedup_curve(
        j_sir.SiracusaConfig(),
        lambda n: j_wl.tinyllama_block(jax_config(name), mode, n), blocks, chips)
    assert got == want


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8, 16, 17, 64])
@pytest.mark.parametrize("payload", [0.0, 512.0, 2048.0, 548864.0])
def test_hierarchical_allreduce_time_equals_jax(payload, n):
    got = t_sim.hierarchical_allreduce_time(t_sir.SiracusaConfig(), payload, n)
    want = j_sim.hierarchical_allreduce_time(j_sir.SiracusaConfig(), payload, n)
    assert got == want


def test_paper_metrics_at_the_frozen_config():
    """The JAX sim's headline numbers (not the paper's), reproduced."""
    got = t_cal.paper_metrics(t_sir.SiracusaConfig())
    want = j_cal.paper_metrics(j_sir.SiracusaConfig())
    assert got == want
    assert t_cal.loss(got) == j_cal.loss(want)
    assert t_cal.TARGETS == j_cal.TARGETS
    assert round(got["ar_speedup8"], 1) == 29.2
    assert round(got["ar_t8_ms"], 2) == 0.49
    assert round(got["ar_e8_mj"], 2) == 0.74
    assert round(got["mb_speedup4"], 2) == 2.76


@pytest.mark.parametrize("corner", CORNERS,
                         ids=["-".join(f"{v:g}" for v in c.values())
                              for c in CORNERS])
def test_paper_metrics_and_loss_at_grid_corners(corner):
    got = t_cal.paper_metrics(t_sir.SiracusaConfig().with_(**corner))
    want = j_cal.paper_metrics(j_sir.SiracusaConfig().with_(**corner))
    assert got == want
    assert t_cal.loss(got) == j_cal.loss(want)


def _example_output(name):
    spec = importlib.util.spec_from_file_location(
        name.replace(".py", ""), ROOT / "examples" / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main()
    return buf.getvalue()


def test_example_prints_the_jax_examples_tables():
    got = _example_output("torch_mcu_cluster_sim.py")
    assert got == _example_output("mcu_cluster_sim.py")
    assert "sim  : 29.2x, 0.49 ms, 0.74 mJ" in got
