"""The check fails a broken timed path: a run of each cell at the reduced
widths on the CPU (the harness's look for a card skipped), with the
program broken underneath (patched for the test alone), comes out not
correct, once for each fault a served cell can have; the same run
unbroken comes out correct."""
import time

import pytest
import torch

from portbench.bench import harness
from portbench.tests._portbench_cells import reduced_cell

CELLS = ["phi3-chat-poisson", "olmoe-decode-batch"]


def altered_token(monkeypatch):
    """A token altered where it is produced: every slot's argmax + 1."""
    from repro_torch.serve import ServeEngine
    real = ServeEngine._next_tokens

    def wrong(self, logits):
        return (real(self, logits) + 1) % logits.shape[-1]
    monkeypatch.setattr(ServeEngine, "_next_tokens", wrong)


def half_the_batch(monkeypatch):
    """Half of the slots left out: their rows take the first half's."""
    from repro_torch.serve import ServeEngine
    real = ServeEngine._next_tokens

    def half(self, logits):
        n = logits.shape[0]
        logits = logits.clone()
        logits[n // 2:] = logits[:n - n // 2]
        return real(self, logits)
    monkeypatch.setattr(ServeEngine, "_next_tokens", half)


def cache_unchanged(monkeypatch):
    """A step that leaves its state unchanged: no K/V row is written."""
    from repro_torch.models import attention
    monkeypatch.setattr(attention, "_write_column_rows",
                        lambda *a, **k: None)


def run(cell):
    return harness.run(reduced_cell(cell), 2**31 + 4242, 3.0, False,
                       torch.device("cpu"), started=time.time())


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = run(cell)
    assert out["correct"], out["check"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [altered_token, half_the_batch])
def test_broken_output_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = run(cell)
    assert not out["correct"], out["check"]


@pytest.mark.parametrize("cell", CELLS)
def test_unwritten_cache_is_not_correct(cell, monkeypatch):
    cache_unchanged(monkeypatch)
    out = run(cell)
    assert not out["correct"], out["check"]
