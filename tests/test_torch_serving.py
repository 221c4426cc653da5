"""The port's serving engine against the JAX package's paged engine in its
serial loop (``overlap=False``), on the same weights and requests: greedy
tokens must be identical.  Prompt lengths cross chunk and page boundaries
and a tight pool forces requests to queue; the pool must be leak-free
after ``drain()``.  Also the launcher's CPU run and its refusals."""
import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core import model as jmodel
from repro.core.partition import ShardingPlan as JaxPlan
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, reduced
from repro_torch.core.partition import ShardingPlan
from repro_torch.launch import serve
from repro_torch.serving import Request, ServingEngine

SB, SLOTS, PSZ, CHUNK = 64, 3, 8, 16
N_PAGES = 12        # 11 usable pages: at most ~2 requests in flight, so some queue
# (prompt length, max_new_tokens): lengths on both sides of the 8-token page
# and the 16-token chunk, a 1-token prompt and a budget-filling request
REQS = [(5, 9), (8, 7), (9, 12), (16, 5), (17, 10), (33, 8), (40, 20), (1, 6),
        (24, 16)]


@pytest.fixture(scope="module")
def weights():
    """JAX's init for reduced tinyllama in fp32, scaled x25 so greedy
    decoding does not collapse onto repeating the prompt's last token."""
    jcfg = jax_reduced(jax_get_config("tinyllama-42m"), dtype="float32")
    jplan = JaxPlan(tp=1, kv_cache_dtype="float32")
    jp = jax.tree_util.tree_map(lambda a: a * 25,
                                jmodel.init_params(jcfg, jplan))
    cfg = reduced(get_config("tinyllama-42m"), dtype="float32")
    plan = ShardingPlan(kv_cache_dtype="float32")
    return jcfg, jplan, jp, cfg, plan, params_from_jax(
        cfg, plan, jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _prompts(vocab):
    rng = np.random.RandomState(0)
    return [(rid, rng.randint(2, vocab, L).astype(np.int32), m)
            for rid, (L, m) in enumerate(REQS)]


def test_greedy_tokens_identical_to_jax_paged_engine(weights, mesh1):
    jcfg, jplan, jp, cfg, plan, params = weights
    reqs = _prompts(cfg.vocab_size)
    jeng = JaxEngine.build_paged(jcfg, jplan, mesh1, SLOTS, SB, jp,
                                 page_size=PSZ, prefill_chunk=CHUNK,
                                 n_pages=N_PAGES, overlap=False)
    jreqs = [JaxRequest(rid=r, prompt=p, max_new_tokens=m) for r, p, m in reqs]
    for r in jreqs:
        jeng.submit(r)
    jeng.run(max_ticks=2000)

    eng = ServingEngine.build_paged(cfg, plan, SLOTS, SB, params,
                                    page_size=PSZ, prefill_chunk=CHUNK,
                                    n_pages=N_PAGES, overlap=False,
                                    device="cpu")
    treqs = [Request(rid=r, prompt=p, max_new_tokens=m) for r, p, m in reqs]
    for r in treqs:
        eng.submit(r)
    stats = eng.run(max_ticks=2000)

    assert all(r.done for r in treqs)
    for a, b in zip(jreqs, treqs, strict=True):
        assert b.out_tokens == a.out_tokens, a.rid
    assert len({t for r in treqs for t in r.out_tokens}) > 20   # not degenerate
    assert stats.ticks == jeng.stats.ticks          # same admission schedule
    assert stats.prefills == len(REQS)
    assert eng.drain() == 0
    assert eng.allocator.n_free == N_PAGES - 1      # every page reclaimed


def test_drain_mid_run_releases_every_page(weights):
    *_, cfg, plan, params = weights
    eng = ServingEngine.build_paged(cfg, plan, SLOTS, SB, params,
                                    page_size=PSZ, prefill_chunk=CHUNK,
                                    n_pages=N_PAGES, device="cpu")
    reqs = [Request(rid=r, prompt=p, max_new_tokens=m)
            for r, p, m in _prompts(cfg.vocab_size)]
    for r in reqs:
        eng.submit(r)
    eng.run(max_ticks=4)
    assert any(a is not None for a in eng.admissions)
    assert eng.drain() > 0
    assert eng.allocator.n_free == N_PAGES - 1
    assert eng.has_pending()                 # queued requests stay queued


def test_submit_rejects_infeasible_requests(weights):
    *_, cfg, plan, params = weights
    eng = ServingEngine.build_paged(cfg, plan, SLOTS, SB, params,
                                    page_size=PSZ, prefill_chunk=CHUNK,
                                    n_pages=4, device="cpu")
    long_prompt = np.arange(2, 30, dtype=np.int32)
    with pytest.raises(RuntimeError, match="pages"):
        eng.submit(Request(rid=0, prompt=long_prompt, max_new_tokens=4))
    with pytest.raises(RuntimeError, match="sequence budget"):
        eng.submit(Request(rid=1, prompt=long_prompt, max_new_tokens=60))
    eng.submit(Request(rid=2, prompt=long_prompt[:4], max_new_tokens=2))
    with pytest.raises(RuntimeError, match="duplicate"):
        eng.submit(Request(rid=2, prompt=long_prompt[:4], max_new_tokens=2))


def test_launcher_serves_on_cpu(capsys):
    assert serve.main(["--arch", "tinyllama-42m", "--smoke", "--requests", "4",
                       "--slots", "2", "--seq-budget", "64", "--prompt-len",
                       "20", "--max-new", "4", "--page-size", "8",
                       "--prefill-chunk", "16", "--kv-dtype", "fp32",
                       "--paged", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "device=cpu" in out and "tokens=16" in out and "pages_free=16/16" in out


@pytest.mark.parametrize("argv,slice_", [
    (["--tp", "2"], "tensor parallelism"),
    (["--dp", "2"], "data-parallel replicas"),
    (["--disagg", "1:1"], "disaggregated prefill/decode"),
    (["--scale-events", "8:1"], "elastic replicas"),
    (["--temperature", "0.7"], "sampled decoding"),
    (["--prefix-cache"], "prefix cache"),
    (["--shared-prefix", "4"], "prefix cache"),
    (["--frame-groups", "2"], "encoder-decoder"),
    (["--policy", "fair"], "priority and fair policies"),
    (["--preemption"], "preemption"),
    (["--high-priority-every", "2"], "priority policies"),
    (["--clients", "2"], "fair policy"),
])
def test_launcher_refuses_flags_of_later_slices(argv, slice_, capsys):
    """A value of the JAX launcher's flags that the port cannot serve is
    refused with the slice it waits for."""
    with pytest.raises(SystemExit) as e:
        serve.parse_args(["--arch", "tinyllama-42m", *argv])
    assert e.value.code == 2
    assert slice_ in capsys.readouterr().err


LAUNCH = ["--arch", "tinyllama-42m", "--smoke", "--requests", "3", "--slots",
          "2", "--seq-budget", "32", "--prompt-len", "12", "--max-new", "3",
          "--kv-dtype", "fp32", "--device", "cpu"]
JAX_DEFAULTS = [["--tp", "1"], ["--dp", "1"], ["--overlap"],
                ["--temperature", "0"], ["--policy", "fcfs"],
                ["--shared-prefix", "0"], ["--frame-groups", "1"],
                ["--high-priority-every", "0"], ["--clients", "1"]]


def _served_tokens(argv, monkeypatch):
    """Serve ``argv`` through the launcher on the CPU -> each request's
    greedy tokens."""
    seen = []
    submit = ServingEngine.submit

    def record(self, req):
        seen.append(req)
        return submit(self, req)

    with monkeypatch.context() as m:
        m.setattr(ServingEngine, "submit", record)
        assert serve.main(argv) == 0
    return [r.out_tokens for r in seen]


@pytest.fixture(scope="module")
def bare_tokens():
    with pytest.MonkeyPatch.context() as m:
        return _served_tokens(LAUNCH, m)


@pytest.mark.parametrize(
    "flags", JAX_DEFAULTS + [["--no-overlap"], sum(JAX_DEFAULTS, [])],
    ids=[f[0] for f in JAX_DEFAULTS] + ["--no-overlap", "all"])
def test_launcher_takes_the_jax_defaults(flags, bare_tokens, monkeypatch):
    """A JAX command line that spells out its defaults runs on the port and
    serves the same greedy tokens as the bare command; overlap is on unless
    ``--no-overlap`` (the JAX launcher's serial loop)."""
    args = serve.parse_args([*LAUNCH, *flags])
    assert (args.tp, args.dp, args.temperature, args.policy) == \
        (1, 1, 0.0, "fcfs")
    assert args.overlap is ("--no-overlap" not in flags)
    got = _served_tokens([*LAUNCH, *flags], monkeypatch)
    assert got == bare_tokens and all(len(t) == 3 for t in got)


@pytest.mark.parametrize("arch,extra", [
    ("tinyllama-42m", ["--paged", "--page-size", "8", "--prefill-chunk", "16"]),
    ("tinyllama-42m", ["--speculative", "2", "--page-size", "8",
                       "--prefill-chunk", "16"]),
    ("mamba2-370m", ["--paged", "--page-size", "8", "--prefill-chunk", "8"])],
    ids=["paged", "speculative", "mamba2-slabs"])
def test_launcher_overlap_and_no_overlap_serve_identical_tokens(
        arch, extra, monkeypatch, capsys):
    """The paged engine's pipelined tick (the default, ``--overlap``) and
    its serial loop (``--no-overlap``) serve the same greedy tokens, and
    the launcher prints JAX's ``pipeline:`` line for each: plan-ahead
    ticks with overlap, none without."""
    argv = [*LAUNCH, *extra]
    argv[argv.index("--arch") + 1] = arch
    runs = {}
    for flag in ("--overlap", "--no-overlap"):
        toks = _served_tokens([*argv, flag], monkeypatch)
        out = capsys.readouterr().out
        line = next(x for x in out.splitlines() if x.startswith("pipeline:"))
        ahead = int(line.split("plan_ahead_ticks=")[1].split()[0])
        runs[flag] = (toks, line, ahead)
    assert runs["--overlap"][0] == runs["--no-overlap"][0]
    assert all(len(t) == 3 for t in runs["--overlap"][0])
    assert "overlap=on" in runs["--overlap"][1] and runs["--overlap"][2] > 0
    assert "overlap=off" in runs["--no-overlap"][1]
    assert runs["--no-overlap"][2] == 0
    assert "plan_invalidations=0" in runs["--overlap"][1]
