"""``repro_torch.benchmarks.kernel_ab`` without a card: the fp32 products
it compares are those ``chip_smoke.py``'s phase 2 checks, each once, the
shapes it times are among them, its ``rglru_scan`` cases are phase 2's and
phase 5 (a)'s, and it refuses to run without a card."""
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from _calibration_isolation import isolated_calibration  # noqa: F401

from repro_torch.benchmarks import kernel_ab

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def test_the_cases_are_phase_2s_fp32_products_once(smoke):
    cases = kernel_ab.product_cases(smoke)
    shapes = [(m, k, n) for _, m, k, n in cases]
    assert len(shapes) == len(set(shapes))
    # train_lm 100m's five products over 4096 tokens and quickstart's
    # three at 512 tokens and 2 slots
    for shape in [(4096, 512, 512), (4096, 512, 256), (4096, 512, 2048),
                  (4096, 2048, 512), (4096, 512, 32768), (512, 64, 64),
                  (2, 64, 128), (512, 128, 64)]:
        assert shape in shapes
    # nemotron-4-340b's head and ffn wo at full width, decode and forward
    for shape in [(4, 18432, 256000), (512, 18432, 256000),
                  (512, 73728, 18432)]:
        assert shape in shapes
    # the router runs in fp32 only; every bf16-only product is absent
    assert (4, 2048, 64) in shapes
    timed_extra = {(4096, 32768, 512), (512, 4096, 32768)}
    assert kernel_ab.TIMED <= set(shapes) | timed_extra


def test_it_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kernel_ab.main(["--other", str(ROOT)]) == 1
    assert "needs a CUDA card" in capsys.readouterr().err


def _names_in(smoke, fn):
    """The module-level names a function of chip_smoke.py reads."""
    import ast
    import inspect
    tree = ast.parse(inspect.getsource(getattr(smoke, fn)))
    return {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}


def test_the_rglru_cases_are_phase_2s_and_phase_5as(smoke):
    """The forward bits are compared at phase 2's ``rglru_scan`` shapes
    and the reverse walk timed at phase 5 (a)'s: recurrentgemma-2b's width
    at its training shape (2 x 512 tokens)."""
    from repro_torch.configs import get_config
    assert "rglru_scan" in kernel_ab.WRAPPERS
    assert {"RGLRU_CASES", "RGLRU_TRAIN"} <= _names_in(smoke,
                                                      "check_rglru_scan")
    assert "RGLRU_TRAIN" in _names_in(smoke, "check_rglru_scan_bwd")
    fwd = kernel_ab.rglru_forward_cases(smoke)
    assert fwd == list(smoke.RGLRU_CASES) + [smoke.RGLRU_TRAIN]
    assert len(set(fwd)) == len(fwd)
    assert kernel_ab.rglru_bwd_cases(smoke) == [smoke.RGLRU_TRAIN]
    cfg = get_config("recurrentgemma-2b")
    width = cfg.rglru.lru_width or cfg.d_model
    assert smoke.RGLRU_TRAIN == (2, 512, width)
    assert all(w == width for _, _, w in smoke.RGLRU_CASES)

