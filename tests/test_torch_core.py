"""The port's copy of the machine model (``repro_torch.core``) against the
JAX package's ``repro.core`` on the same inputs, with exact equality: the
lowered programs simulated under every policy (cycles, energy, stalls, the
FIFO sequences and the outputs), ``run_point`` records on single-PE,
clustered and pipelined points under the event, cycle and batch engines,
the port's batch engine against its event engine, and a ``hypothesis``
differential of the port's event ``Stepper`` against its per-cycle
``ReferenceStepper``.  The two packages' enums are different classes, so
enums are compared by value."""
import dataclasses
import enum
import itertools

import pytest

torch = pytest.importorskip("torch")

from _hypothesis_compat import given, settings, st

from repro import core as jcore
from repro_torch import core as tcore

POLICIES = ("baseline", "copift", "copiftv2")

#: every SimResult facet the packages (and the port's two steppers) must
#: agree on
FACETS = ("cycles", "energy", "instrs", "stalls", "push_seq", "pop_seq",
          "max_queue_occupancy", "fifo_violations", "env")


def _plain(x):
    """``x`` with every enum (a dict key included) replaced by its value."""
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, dict):
        return {_plain(k): _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    return x


def _streams(prog):
    """A program's streams as plain data: every instruction field but its
    semantics (``fn``, a closure each lowering makes anew)."""
    return {unit.value: [_plain(tuple(getattr(i, f.name)
                                      for f in dataclasses.fields(i)
                                      if f.name != "fn"))
                         for i in instrs]
            for unit, instrs in prog.streams.items()}


def _simulate(core, kernel, policy, n_samples=32):
    tcfg = core.TransformConfig(n_samples=n_samples)
    prog = core.lower(core.KERNELS[kernel],
                      core.ExecutionPolicy(policy), tcfg)
    return prog, core.simulate(prog, core.MachineConfig())


@pytest.fixture
def fresh_prefix_caches():
    """Both packages' COPIFTv2 prefix caches empty before and after the
    test.  A cached prefix keeps its ``_Builder``, whose uid counter goes on
    counting across the lowerings that share it, so a lowering's uids
    depend on what the process lowered before: a test that lowers in both
    packages must start both from the same history."""
    from repro.core import transform as jtransform
    from repro_torch.core import transform as ttransform
    caches = (jtransform._V2_PREFIX_CACHE, ttransform._V2_PREFIX_CACHE)
    for c in caches:
        c.clear()
    yield
    for c in caches:
        c.clear()


def _same_lowering_and_run(kernel, policy):
    assert sorted(tcore.KERNELS) == sorted(jcore.KERNELS)
    jprog, jres = _simulate(jcore, kernel, policy)
    tprog, tres = _simulate(tcore, kernel, policy)
    assert tprog.output_values == jprog.output_values
    assert _streams(tprog) == _streams(jprog)
    for facet in FACETS:
        assert _plain(getattr(tres, facet)) == _plain(getattr(jres, facet)), \
            facet
    outputs = [tres.env[v] for v in tprog.output_values]
    assert outputs == [jres.env[v] for v in jprog.output_values]
    assert (tres.ipc, tres.throughput, tres.efficiency) == \
        (jres.ipc, jres.throughput, jres.efficiency)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("kernel", sorted(jcore.KERNELS))
def test_lowered_kernels_simulate_as_the_reference(kernel, policy,
                                                   fresh_prefix_caches):
    """7 kernels x 3 policies: the same program lowered, the same run."""
    _same_lowering_and_run(kernel, policy)


@pytest.mark.parametrize("kernel", ["expf", "histf"])
def test_lowering_after_a_cached_prefix_matches(kernel, fresh_prefix_caches):
    """The order that once failed: a COPIFTv2 lowering of the kernel at
    another depth in the same process first (its prefix, and the ``_Builder``'s
    uid counter, are then cached), in both packages, then the
    comparison, which lowers from the cached prefix on both sides."""
    for core in (jcore, tcore):
        core.lower(core.KERNELS[kernel], core.ExecutionPolicy.COPIFTV2,
                   core.TransformConfig(n_samples=32, queue_depth=1))
    _same_lowering_and_run(kernel, "copiftv2")


#: single-PE points (symmetric and asymmetric rings), 2- and 4-core
#: clusters (conflict-free and banked) and pipelined core pairs
POINTS = (
    [dict(kernel=k, policy=p, queue_depth=d, queue_latency=lat)
     for k, p, d, lat in itertools.product(
         ("expf", "histf"), POLICIES, (1, 4), (1, 2))]
    + [dict(kernel="dequant_dot", policy="copiftv2", queue_depth=2,
            queue_depth_i2f=1, queue_depth_f2i=4, unroll=4)]
    + [dict(kernel=k, policy=p, n_cores=n, tcdm_banks=b)
       for k, p, n, b in itertools.product(
           ("poly_lcg", "cluster_matmul"), ("copift", "copiftv2"), (2, 4),
           (None, 2))]
    + [dict(kernel="cluster_matmul", policy="copiftv2", n_cores=n,
            tcdm_banks=b, pipeline=True, cq_depth=cq, dma_buffers=db)
       for n, b, cq, db in ((2, None, 4, 2), (2, 8, 2, 1), (4, 2, 8, 2))]
    + [dict(kernel="expf", policy="copift", n_cores=2, pipeline=True)])


def _record(core, engine, kw):
    return dataclasses.asdict(core.run_point(core.SweepPoint(
        n_samples=16, engine=engine, **kw)))


@pytest.mark.parametrize("engine", ("event", "cycle", "batch"))
def test_run_point_records_equal_the_reference(engine):
    statuses = set()
    for kw in POINTS:
        rec = _record(tcore, engine, kw)
        assert rec == _record(jcore, engine, kw), kw
        statuses.add((rec["status"], rec["n_cores"] > 1, rec["pipeline"]))
    # the grid reaches every kind of point, and a rejected one
    assert {("ok", False, False), ("ok", True, False), ("ok", True, True),
            ("rejected", True, True)} <= statuses


def test_batch_sweep_equals_event_inside_the_port():
    """The port's lockstep engines (grouped through ``run_sweep``) give the
    port's event records, engine column aside."""
    pts = [tcore.SweepPoint(n_samples=16, **kw) for kw in POINTS]
    event = tcore.run_sweep(pts, workers=1)
    batch = tcore.run_sweep([dataclasses.replace(p, engine="batch")
                             for p in pts], workers=1)
    for e, b in zip(event, batch):
        assert dataclasses.replace(b, engine="event") == e


@given(st.sampled_from(sorted(tcore.KERNELS)), st.sampled_from(POLICIES),
       st.integers(min_value=1, max_value=16),
       st.integers(min_value=1, max_value=8),
       st.sampled_from((1, 2, 4, 8)), st.sampled_from((8, 16, 32)))
@settings(max_examples=20, deadline=None)
def test_port_event_stepper_matches_its_reference_stepper(kernel, policy,
                                                          depth, lat,
                                                          unroll, n):
    tcfg = tcore.TransformConfig(n_samples=n, queue_depth=depth,
                                 unroll=unroll)
    try:
        prog = tcore.lower(tcore.KERNELS[kernel],
                           tcore.ExecutionPolicy(policy), tcfg)
    except ValueError:
        return                        # infeasible schedule: nothing to diff
    mcfg = tcore.MachineConfig(queue_depth=depth, queue_latency=lat)
    ref = tcore.ReferenceStepper(prog, mcfg).run()
    ev = tcore.Stepper(prog, mcfg).run()
    for facet in FACETS:
        assert getattr(ev, facet) == getattr(ref, facet), facet


def test_sweep_csv_round_trips_between_the_packages(tmp_path):
    """A sweep CSV written by either package reads back in the other as the
    same records."""
    pts = [dict(kernel="expf", policy=p, queue_depth=d)
           for p, d in itertools.product(POLICIES, (1, 4))]
    trecs = [tcore.run_point(tcore.SweepPoint(n_samples=16, **kw))
             for kw in pts]
    jrecs = [jcore.run_point(jcore.SweepPoint(n_samples=16, **kw))
             for kw in pts]
    tcore.write_csv(trecs, str(tmp_path / "port.csv"))
    jcore.write_csv(jrecs, str(tmp_path / "jax.csv"))
    assert (tmp_path / "port.csv").read_text() == \
        (tmp_path / "jax.csv").read_text()
    assert [dataclasses.asdict(r) for r in
            jcore.read_csv(str(tmp_path / "port.csv"))] == \
        [dataclasses.asdict(r) for r in trecs]


def test_copiftv2_demo_part1_simulates_and_part2_needs_the_card(
        monkeypatch, capsys):
    """The demo's machine-model part gives the reference's runs; its
    kernel part raises where there is no card."""
    from repro_torch.examples import copiftv2_demo
    runs = copiftv2_demo.part1(n_samples=64)
    out = capsys.readouterr().out
    for kernel, by_policy in runs.items():
        assert f"\n{kernel}:" in out
        for policy, res in by_policy.items():
            _, ref = _simulate(jcore, kernel, policy, n_samples=64)
            assert (res.cycles, res.energy) == (ref.cycles, ref.energy)
    assert runs["expf"]["copiftv2"].throughput > \
        runs["expf"]["baseline"].throughput
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        copiftv2_demo.part2()
