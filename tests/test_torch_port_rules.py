"""Rules of the PyTorch port that no numerical test would catch: it imports
nothing of JAX or of the JAX package, it never falls back to the CPU on its
own, and ``chip_smoke.py`` refuses to report a result without a card."""
import ast
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"] + sorted((ROOT / "scripts").glob("torch_*.py")) \
    + sorted((ROOT / "examples").glob("torch_*.py"))


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_entry_points_refuse_cuda_without_a_card(monkeypatch):
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import model
    from repro_torch.core.partition import ShardingPlan
    from repro_torch.serving import ServingEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_config("tinyllama-42m"), dtype="float32")
    params = model.init_params(cfg, ShardingPlan(), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine.build_paged(cfg, ShardingPlan(), 2, 32, params,
                                  page_size=8, prefill_chunk=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_params(cfg, ShardingPlan())


def test_unported_architectures_are_refused():
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import model
    from repro_torch.core.partition import ShardingPlan
    cfg = reduced(get_config("tinyllama-42m"))
    untied = model.init_params(dataclasses.replace(cfg, tie_embeddings=False),
                               ShardingPlan(), device="cpu")
    assert tuple(untied["lm_head"]["w"].shape) == (cfg.vocab_size,
                                                   cfg.d_model)
    with pytest.raises(NotImplementedError, match="vision frontend"):
        model.init_params(dataclasses.replace(cfg, tie_embeddings=False,
                                              frontend="vision_patches"),
                          ShardingPlan(), device="cpu")
    # MoE layers are served: init_params builds the router, the experts
    # (expert axis first) and the shared experts' dense FFN
    moe = dataclasses.replace(cfg, n_experts=4, top_k=2, moe_d_ff=64,
                              n_shared_experts=1)
    ffn = model.init_params(moe, ShardingPlan(), device="cpu")["stacks"][0][0]["ffn"]
    L, E = cfg.n_layers, cfg.d_model
    assert {k: tuple(v.shape) for k, v in model.tree_paths(ffn)} == {
        "router.w": (L, E, 4), "experts.w_up": (L, 4, E, 64),
        "experts.w_gate": (L, 4, E, 64), "experts.w_down": (L, 4, 64, E),
        "shared.w_up": (L, E, 64), "shared.w_gate": (L, E, 64),
        "shared.w_down": (L, 64, E)}
    # an unknown name raises a KeyError that lists the registered names
    with pytest.raises(KeyError, match="deepseek-moe-16b.*hymba-1.5b.*"
                                       "mixtral-8x22b"):
        get_config("no-such-arch")
    # the paper's encoder: registered for the sim, refused for JAX's reason
    # (src/repro/core/kvcache.py::paged_cache_supported)
    why = "encoder-only arch has no decode path to serve"
    with pytest.raises(ValueError, match=why):
        model.init_params(reduced(get_config("mobilebert")), ShardingPlan(),
                          device="cpu")
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.parse_args(["--arch", "mobilebert", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="int8"):
        model.init_params(cfg, ShardingPlan(weight_dtype="int8"), device="cpu")


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "alone"])
def test_chip_smoke_fails_without_a_card_and_prints_no_result(alone, tmp_path):
    cwd = ROOT
    if alone:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    res = _run_smoke(cwd)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_model_holds_its_parameters_as_a_module():
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import model
    from repro_torch.core.partition import ShardingPlan
    cfg = reduced(get_config("tinyllama-42m"), dtype="float32")
    params = model.init_params(cfg, ShardingPlan(), device="cpu")
    dec = model.Decoder(params)
    sd = dec.state_dict()
    assert "stacks__0__0__attn__wq" in sd
    assert sum(p.numel() for p in dec.parameters()) == \
        sum(t.numel() for _, t in model.tree_paths(params))
    assert dec.tree()["stacks"][0][0]["attn"]["wq"] is \
        dict(dec.named_parameters())["stacks__0__0__attn__wq"]
    np.testing.assert_array_equal(sd["embed__table"].numpy(),
                                  params["embed"]["table"].numpy())


def test_scan_covers_the_runtime_copies():
    """Every runtime module the port copies from the JAX package is in the
    import scan, and the hedged router's copy needs nothing but the
    standard library (it wraps plain callables: no device, no torch)."""
    runtime = ROOT / "src" / "repro_torch" / "runtime"
    for name in ("elastic", "ft", "offload", "straggler"):
        assert runtime / f"{name}.py" in PORT_FILES, name
    mods = {m.split(".")[0] for m in
            _imported_modules(runtime / "straggler.py")}
    assert mods <= {"__future__", "dataclasses", "threading", "time",
                    "typing"}, mods
