"""The PyTorch port's serve path: the port engine against the JAX engine on
bridged weights (same tokens, same ``metrics()``, same traffic history),
the continuous-batching properties of tests/test_serve.py held by the port
alone, the recorded step costs against the machine-model simulator, the
scheduler against the reference's virtual-time simulation, and entry
points that refuse to fall back to the CPU."""
import dataclasses
import json
import sys

import pytest

torch = pytest.importorskip("torch")

import jax
import numpy as np

from repro.config import RunConfig as JRC
from repro.configs import get_reduced as jax_reduced
from repro.core.policy import ExecutionPolicy as JEP
from repro.core.policy import OperatingPoint as JOP
from repro.core.policy import PolicyTable as JPolicyTable
from repro.models import init_model_params as jax_init_params
from repro.serve import ServeEngine as JaxEngine
from repro.serve import StepCostModel as JStepCostModel
from repro.serve import TraceRequest as JTrace
from repro.serve import simulate_serve as jax_simulate
from repro.serve import ServeSLO as JSLO
from repro_torch import bridge
from repro_torch.config import RunConfig
from repro_torch.configs import get_reduced
from repro_torch.core.policy import ExecutionPolicy, OperatingPoint
from repro_torch.models import init_cache, init_model_params
from repro_torch.serve import (ServeEngine, ServeSLO, StepCostModel,
                               TraceRequest, simulate_serve)
from repro_torch.serve import scheduler as port_scheduler

RC = RunConfig(remat=False, dtype="float32")
JRC_ = JRC(remat=False, dtype="float32")
ARCH = "phi3-mini-3.8b"


def _params():
    return init_model_params(0, get_reduced(ARCH), device="cpu")


def _engine(params, **kw):
    kw.setdefault("batch_slots", 2)
    kw.setdefault("max_len", 64)
    return ServeEngine(params, get_reduced(ARCH), RC, device="cpu", **kw)


# --- against the JAX engine -------------------------------------------------

def _engine_parity(arch, prefill):
    """Same bridged weights, same prompts: the same generated tokens, the
    same serving report and the same measured-traffic retargets."""
    cfg = jax_reduced(arch)
    pj = jax_init_params(jax.random.PRNGKey(0), cfg)
    pt = bridge.from_numpy_tree(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    rng = np.random.default_rng(9)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab, n)]
               for n in (3, 9, 5, 2, 7)]
    jeng = JaxEngine(pj, cfg, JRC_, batch_slots=2, max_len=64,
                     prefill=prefill, prefill_chunk=4,
                     policy_table=JPolicyTable())
    teng = ServeEngine(pt, get_reduced(arch), RC, batch_slots=2, max_len=64,
                       prefill=prefill, prefill_chunk=4, device="cpu")
    for p in prompts[:3]:
        jeng.submit(p, max_new=4)
        teng.submit(p, max_new=4)
    for _ in range(3):
        jeng.step()
        teng.step()
    for p in prompts[3:]:
        jeng.submit(p, max_new=3)
        teng.submit(p, max_new=3)
    dj, dt = jeng.run(), teng.run()
    assert sorted(dj) == sorted(dt) == list(range(5))
    for rid in dj:
        assert dj[rid].generated == dt[rid].generated, rid
    assert teng.metrics(slo=ServeSLO(p99_cycles_per_token=200.0)).to_dict() \
        == jeng.metrics(slo=JSLO(p99_cycles_per_token=200.0)).to_dict()
    assert teng.traffic_history == jeng.traffic_history
    assert teng.traffic_history                  # the retarget did happen
    assert teng.prefill_compiles == jeng.prefill_compiles


@pytest.mark.parametrize("prefill", ["chunked", "token"])
def test_port_engine_matches_jax_engine(prefill):
    _engine_parity(ARCH, prefill)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "falcon-mamba-7b",
                                  "recurrentgemma-2b", "minicpm3-4b",
                                  "nemotron-4-340b", "pixtral-12b"])
def test_port_engine_matches_jax_engine_on_moe_and_ssm(arch):
    """The MoE, SSM, hybrid and MLA families, the squared-ReLU FFN and the
    vision model (which decodes tokens) through the chunked-prefill
    engine."""
    _engine_parity(arch, "chunked")


def test_scheduler_simulation_matches_reference():
    """The port's copy of the scheduler gives the reference's report on a
    bursty trace (flat costs, no machine model involved)."""
    costs = dict(cycles_decode_token=10.0, energy_decode_token=5.0,
                 cycles_prefill_token=2.5, energy_prefill_token=1.25,
                 overhead_cycles=20.0, source="flat-test")
    trace = [(4 * b + i, b * 2000.0 + i * 5.0, 2 + (i % 2) * 2,
              2 if i % 2 else 10) for b in range(2) for i in range(4)]
    for mode in ("continuous", "static"):
        a = simulate_serve([TraceRequest(*t) for t in trace], 2,
                           StepCostModel(**costs), mode=mode,
                           slo=ServeSLO(p99_cycles_per_token=300.0))
        b = jax_simulate([JTrace(*t) for t in trace], 2,
                         JStepCostModel(**costs), mode=mode,
                         slo=JSLO(p99_cycles_per_token=300.0))
        assert a.to_dict() == b.to_dict()


# --- continuous-batching properties, port alone -----------------------------

def test_engine_midrun_admission_matches_fresh_engine():
    """Analogue of test_serve.py:211."""
    params = _params()
    prompt, max_new = [7, 3, 9, 1], 5
    eng = _engine(params)
    eng.submit([1, 2, 3], max_new=8)
    eng.submit([4, 5, 6], max_new=2)
    for _ in range(4):
        eng.step()
    rid = eng.submit(prompt, max_new=max_new)
    done = eng.run()
    assert len(done) == 3
    fresh = _engine(params)
    rid_f = fresh.submit(prompt, max_new=max_new)
    assert done[rid].generated == fresh.run()[rid_f].generated


def test_hybrid_engine_midrun_admission_matches_fresh_engine():
    """The hybrid family (window 16, caches of 24, so the K/V ring wraps):
    a request admitted into a freed slot mid-run, after its neighbours'
    long prompts, generates what it generates alone."""
    cfg = get_reduced("recurrentgemma-2b")
    params = init_model_params(0, cfg, device="cpu")
    prompt, max_new = [7, 3, 9, 1, 4], 6

    def engine():
        return ServeEngine(params, cfg, RC, batch_slots=2, max_len=24,
                           prefill_chunk=4, device="cpu")
    eng = engine()
    eng.submit(list(range(1, 19)), max_new=4)
    eng.submit([4, 5, 6], max_new=2)
    for _ in range(4):
        eng.step()
    rid = eng.submit(prompt, max_new=max_new)
    done = eng.run()
    assert len(done) == 3
    fresh = engine()
    rid_f = fresh.submit(prompt, max_new=max_new)
    assert done[rid].generated == fresh.run()[rid_f].generated


def _slot_rows(cache, i):
    return {k: (v[i] if v.ndim == 1 else v[:, i]).clone()
            for k, v in cache.items()}


def test_engine_chunked_prefill_mixed_phase_bit_exact():
    """Analogue of test_serve.py:283: one slot mid-prefill-chunk while its
    neighbour decodes; tokens and each request's cache rows at its
    completion step are bit-exact with the token-by-token engine."""
    params = _params()
    reqs = [([5, 9], 8), (list(range(1, 19)), 3)]

    def run_with_snapshots(prefill):
        eng = _engine(params, prefill=prefill, prefill_chunk=4)
        rids = [eng.submit(p, max_new=m) for p, m in reqs]
        snaps, slot_of = {}, {}
        for _ in range(200):
            if not eng.sched.busy:
                break
            for i, s in enumerate(eng.sched.slots):
                if s is not None:
                    slot_of[s.rid] = i
            eng.step()
            for rid in eng.finished:
                if rid not in snaps:
                    snaps[rid] = _slot_rows(eng.cache, slot_of[rid])
        assert set(eng.finished) == set(rids)
        return eng, snaps

    chunked, snaps_c = run_with_snapshots("chunked")
    token, snaps_t = run_with_snapshots("token")
    for rid in chunked.finished:
        assert chunked.finished[rid].generated == \
            token.finished[rid].generated
        for k in snaps_c[rid]:
            assert torch.equal(snaps_c[rid][k], snaps_t[rid][k]), (rid, k)
    assert chunked._n_steps < token._n_steps


def test_engine_readmission_during_neighbour_prefill():
    """Analogue of test_serve.py:327."""
    params = _params()
    prompt, max_new = [7, 3, 9, 1], 5
    eng = _engine(params, prefill_chunk=4)
    eng.submit([4, 5, 6], max_new=2)
    eng.submit(list(range(1, 25)), max_new=4)
    for _ in range(3):
        eng.step()
    rid = eng.submit(prompt, max_new=max_new)
    assert any(s is not None and s.phase == "prefill"
               for s in eng.sched.slots)
    done = eng.run()
    assert len(done) == 3
    fresh = _engine(params, prefill_chunk=4)
    rid_f = fresh.submit(prompt, max_new=max_new)
    assert done[rid].generated == fresh.run()[rid_f].generated


def test_engine_chunk_bucket_cache_is_bounded():
    """Analogue of test_serve.py:353: at most log2(prefill_chunk) + 1 step
    callables, one per power-of-two width."""
    eng = _engine(_params(), prefill_chunk=8)
    for plen in (1, 2, 3, 5, 8, 13, 21, 6, 17):
        eng.submit(list(range(1, plen + 1)), max_new=2)
    eng.run(max_steps=4000)
    assert not eng.sched.busy
    assert 1 <= eng.prefill_compiles <= 4
    assert set(eng._prefill_fns) <= {1, 2, 4, 8}


def test_engine_reset_zeroes_only_the_refilled_slot():
    eng = _engine(_params())
    for v in eng.cache.values():
        v.fill_(1)
    eng._reset_slot_cache(1)
    assert int(eng.cache["len"][1]) == 0 and int(eng.cache["len"][0]) == 1
    assert torch.count_nonzero(eng.cache["k"][:, 1]) == 0
    assert torch.all(eng.cache["k"][:, 0] == 1)


# --- recorded step costs ----------------------------------------------------

def test_step_costs_file_equals_the_simulator():
    """Every entry of step_costs.json is what the machine-model simulator
    gives for that point today."""
    with open(port_scheduler.STEP_COSTS_PATH) as f:
        entries = json.load(f)["entries"]
    assert len(entries) == 4
    for e in entries:
        point = JOP(**{**e["point"], "policy": JEP(e["point"]["policy"])})
        ref = JStepCostModel.from_operating_point(
            point, workload=e["workload"], n_samples=e["n_samples"])
        assert dataclasses.asdict(ref) == e["cost"], e["point"]


@pytest.mark.parametrize("policy", list(ExecutionPolicy))
def test_step_costs_cover_every_point_the_table_returns(policy):
    from repro_torch.core.policy import default_table
    for op in (None, OperatingPoint(),
               default_table().resolve("serve", policy=policy)):
        cost = StepCostModel.from_operating_point(op)
        assert cost.cycles_decode_token > cost.cycles_prefill_token > 0
    with pytest.raises(NotImplementedError, match="repro.core"):
        StepCostModel.from_operating_point(OperatingPoint(queue_depth=2))


def test_pinned_policy_engine_uses_its_recorded_costs():
    eng = _engine({}, operating_point=None)
    pinned = ServeEngine({}, get_reduced(ARCH),
                         dataclasses.replace(RC, policy=ExecutionPolicy.COPIFT),
                         batch_slots=2, device="cpu")
    assert pinned.rc.policy is ExecutionPolicy.COPIFT
    assert pinned._cost.source == "override"
    assert pinned._cost.cycles_decode_token > eng._cost.cycles_decode_token


# --- entry points and the card ----------------------------------------------

def test_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_reduced(ARCH)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_model_params(0, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cache(cfg, 2, 8, torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine({}, cfg, RC, batch_slots=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bridge.from_numpy_tree({"a": np.zeros(2, np.float32)})
    from repro_torch.launch import serve as launch
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCH, "--reduced"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.main()


def test_launcher_serves_on_the_cpu_when_asked(monkeypatch, capsys):
    from repro_torch.launch import serve as launch
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "glm4-9b", "--reduced", "--device", "cpu",
        "--requests", "3", "--max-new", "3"])
    launch.main()
    out = capsys.readouterr().out
    assert "policy=copiftv2 (source=default" in out
    assert "served 3 requests, 9 tokens" in out
    assert "on cpu" in out


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "granite-moe-3b-a800m",
                                  "falcon-mamba-7b", "recurrentgemma-2b",
                                  "minicpm3-4b", "nemotron-4-340b",
                                  "pixtral-12b"])
def test_launcher_serves_moe_and_ssm_on_the_cpu(monkeypatch, capsys, arch):
    from repro_torch.launch import serve as launch
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", arch, "--reduced", "--device", "cpu",
        "--requests", "3", "--max-new", "2", "--prefill", "token"])
    launch.main()
    out = capsys.readouterr().out
    assert "served 3 requests, 6 tokens" in out and "on cpu" in out


def test_launcher_refuses_the_encoder(monkeypatch):
    """hubert-xlarge has no decode: the launcher exits, as the
    reference's does."""
    from repro_torch.launch import serve as launch
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "hubert-xlarge", "--reduced", "--device", "cpu"])
    with pytest.raises(SystemExit, match="encoder-only"):
        launch.main()
