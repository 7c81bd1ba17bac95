"""The port's benchmark sections (``repro_torch.benchmarks``) against the
JAX package's ``benchmarks/`` on the CPU: the kernel benchmark's rows, bulk
against ring ``tp_matmul`` over 8 gloo processes, the roofline table of a
dry-run cell, the live chunked-prefill cell and the section runner.

Tolerances: ``tp_matmul`` within fp32 2e-4 (rtol = atol) of ``x @ w``;
the prefill cell's cycles-domain TTFTs, engine steps and chunk programs
equal the reference engine's with ``==`` (the scheduler and the cost
model are copies, held to the reference with ``==`` in
tests/test_torch_serve.py and tests/test_torch_calibration.py); the
roofline table equal to the reference's rendering of the same cell."""
import contextlib
import io
import json

import pytest

torch = pytest.importorskip("torch")

from _calibration_isolation import isolated_calibration  # noqa: F401
from _port_artifacts import redirect

from benchmarks import kernel_bench as ref_kernel_bench
from benchmarks import roofline_table as ref_roofline
from benchmarks import serve_slo as ref_slo
from repro_torch.benchmarks import (collective_policy, kernel_bench,
                                    roofline_table, serve_slo)
from repro_torch.benchmarks import run as bench_run
from repro_torch.launch import dryrun


def test_kernel_bench_rows_are_the_reference_rows(tmp_path):
    """The reference's rows in its order (its XLA baseline row named for
    ``torch.matmul``); ``run`` raises unless ``queue_matmul`` and
    ``moe_gemm`` give the same bits at every depth; the artifact names the
    device."""
    want = [name for name, _, _ in ref_kernel_bench.run()]
    want[want.index("kernel_matmul_xla_ref")] = "kernel_matmul_torch"
    out = tmp_path / "kernels.json"
    rows = kernel_bench.run(device="cpu", out_path=str(out))
    assert [name for name, _, _ in rows] == want
    assert all(us > 0 for _, us, _ in rows)
    art = json.loads(out.read_text())
    assert art["device"] == "cpu" and art["timer"] == "host clock"
    assert [r[0] for r in art["rows"]] == want


def test_kernel_bench_raises_when_depths_differ(monkeypatch):
    """The depth check is a gate: a depth that changed a bit fails."""
    real = kernel_bench.queue_matmul

    def off_at_depth_two(x, w, depth=None, **kw):
        y = real(x, w, depth=depth, **kw)
        return y + 1e-3 if depth == 2 else y
    monkeypatch.setattr(kernel_bench, "queue_matmul", off_at_depth_two)
    with pytest.raises(AssertionError, match="depth 2 differs"):
        kernel_bench.run(device="cpu", out_path=None)


@pytest.fixture(scope="module")
def collective():
    return collective_policy.measure("cpu")


@pytest.mark.parametrize("policy", ["copift", "copiftv2"])
def test_collective_policy_within_tolerance(collective, policy):
    """Each policy over the 2 x 4 gloo mesh within fp32 2e-4 of ``x @ w``
    (``measure`` raises otherwise)."""
    d = collective["policies"][policy]
    assert collective["mesh"] == [2, 4] and collective["world"] == 8
    assert d["within_tol"] and d["us"] > 0


def test_collective_policy_op_counts(collective):
    """Bulk issues one all-gather and no send; the ring no all-gather and
    n - 1 = 3 sends over the model axis of 4.  The reference counts ops in
    its compiled HLO text and reports 1 all-gather / 0 permutes for bulk
    and 0 / 1 for the ring (its ring's one ``collective-permute`` sits in
    a loop body run n = 4 times, the last send feeding nothing): the port
    counts each send issued, and drops the last."""
    rows = collective_policy.rows(collective)
    assert [name for name, _, _ in rows] == [
        f"collective_{pol}_{what}" for pol in ("copift", "copiftv2")
        for what in ("us", "allgather_ops", "permute_ops")]
    counts = {name: derived for name, _, derived in rows}
    assert counts["collective_copift_allgather_ops"] == 1
    assert counts["collective_copift_permute_ops"] == 0
    assert counts["collective_copiftv2_allgather_ops"] == 0
    assert counts["collective_copiftv2_permute_ops"] == 3


def test_roofline_table_of_a_dry_run_cell(tmp_path):
    """One analysis cell written by the dry run to ``tmp_path``: the
    reference's table rendering of it equals the port's, and the row
    carries the count's seconds and the MFU."""
    art = dryrun.run_cell("phi3-mini-3.8b", "decode_32k", False,
                          analysis=True, out_dir=str(tmp_path))
    cells = roofline_table.load(art_dir=str(tmp_path))
    assert list(cells) == [("phi3-mini-3.8b", "decode_32k")]
    assert roofline_table.table(cells) == ref_roofline.table(cells)
    assert roofline_table.run(str(tmp_path)) == [
        ("roofline_phi3-mini-3.8b_decode_32k_mfu", art["count_s"] * 1e6,
         art["roofline"]["mfu"])]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        roofline_table.main(art_dir=str(tmp_path / "none"))
    assert out.getvalue() == "roofline_no_artifacts,0,0\n"


def test_prefill_constants_equal_reference():
    assert serve_slo.PREFILL_FULL == ref_slo.PREFILL_FULL
    assert serve_slo.PREFILL_SMOKE == ref_slo.PREFILL_SMOKE
    assert serve_slo.MIN_PREFILL_TTFT_GAIN == ref_slo.MIN_PREFILL_TTFT_GAIN
    assert serve_slo.MIN_PREFILL_TTFT_GAIN_SMOKE == \
        ref_slo.MIN_PREFILL_TTFT_GAIN_SMOKE
    card = dict(serve_slo.PREFILL_CARD)
    assert card.pop("full") is True and card.pop("dtype") == "bfloat16"
    assert card == ref_slo.PREFILL_FULL
    for width, prefill in ((2, 0), (2, 16), (1, 3)):
        assert serve_slo._cost_model().step_cost(width, prefill) == \
            ref_slo._cost_model().step_cost(width, prefill)


def test_prefill_smoke_cell_equals_reference(tmp_path):
    """``run_prefill(PREFILL_SMOKE)`` on the CPU passes its hard gates, and
    its cycles-domain TTFTs, engine steps and chunk programs equal the
    reference engine's with ``==``: the reference's values come from its
    non-gating ``_prefill_engines`` and ``_measure_ttft`` (its
    ``run_prefill`` also gates on the wall clock)."""
    cfg = ref_slo.PREFILL_SMOKE
    mk, prompt = ref_slo._prefill_engines(cfg)
    ref = {}
    for prefill in ("chunked", "token"):
        eng = mk(prefill)
        tokens, cycles, _ = ref_slo._measure_ttft(eng, prompt,
                                                   cfg["max_new"],
                                                   cfg["trials"])
        ref[prefill] = (cycles, eng._n_steps, eng.prefill_compiles)
    _, port_prompt = serve_slo._prefill_engines(cfg, "cpu")
    assert port_prompt == prompt

    out = tmp_path / "prefill.json"
    rows = serve_slo.run_prefill(dict(cfg), out_path=str(out),
                                 min_wall_gain=serve_slo.
                                 MIN_PREFILL_TTFT_GAIN_SMOKE, device="cpu")
    assert [name for name, _, _ in rows] == [
        "serve_prefill_ttft_wall_gain", "serve_prefill_ttft_cycles_gain",
        "serve_prefill_compiles"]
    rep = json.loads(out.read_text())
    assert rep["ttft"]["cycles_chunked"] == ref["chunked"][0]
    assert rep["ttft"]["cycles_token"] == ref["token"][0]
    assert rep["steps"] == {"chunked": ref["chunked"][1],
                            "token": ref["token"][1]}
    assert rep["prefill_compiles"] == ref["chunked"][2]
    head = rep["headline"]
    assert head["bit_exact"] is True
    assert head["ttft_cycles_gain"] >= serve_slo.MIN_PREFILL_TTFT_GAIN
    assert head["min_required"] == serve_slo.MIN_PREFILL_TTFT_GAIN_SMOKE
    assert head["meets_wall_bar"] == (head["ttft_wall_gain"] >=
                                      head["min_required"])
    assert rep["device"] == "cpu"


def test_prefill_gates_are_hard(monkeypatch, tmp_path):
    """A chunked path that changes one token fails the cell."""
    real = serve_slo._measure_ttft

    def off_by_one(eng, prompt, max_new, trials):
        tokens, cycles, walls = real(eng, prompt, max_new, trials)
        if eng.prefill == "chunked":
            tokens = [tokens[0] + 1] + tokens[1:]
        return tokens, cycles, walls
    monkeypatch.setattr(serve_slo, "_measure_ttft", off_by_one)
    cfg = dict(serve_slo.PREFILL_SMOKE, trials=1, max_new=2)
    with pytest.raises(AssertionError, match="not bit-exact"):
        serve_slo.run_prefill(cfg, out_path=str(tmp_path / "p.json"),
                              device="cpu")


def test_run_smoke_passes_every_section(monkeypatch, tmp_path):
    """``python -m repro_torch.benchmarks.run --smoke --device cpu``: the
    reference's 11 smoke sections, in its order and with its titles, then
    the port's kernels, collective policy and roofline; every section
    passes (the runner exits non-zero on any failure).  Every artifact
    goes to ``tmp_path``."""
    import benchmarks.run as ref_run
    want = []
    monkeypatch.setattr(ref_run, "_run_sections",
                        lambda sections: want.extend(t for t, _ in sections))
    ref_run.main(["--smoke"])
    assert len(want) == 11
    redirect(monkeypatch, tmp_path)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        bench_run.main(["--smoke", "--device", "cpu"])
    summary = out.getvalue().split("# --- summary ---")[1].splitlines()[1:]
    assert len(summary) == 14 and all(s.startswith("# PASS: ")
                                      for s in summary), summary
    assert [s.removeprefix("# PASS: ") for s in summary[:11]] == want
