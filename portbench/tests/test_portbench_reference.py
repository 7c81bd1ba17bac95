"""The plain reference against the port's CPU path at the reduced
configurations, on the harness's own weights: the reference's logits
equal the port's ``forward`` in float32, and the engine's served tokens,
in float32 on the CPU, lie at a gap of 0 to rounding."""
import time

import pytest
import torch

from portbench.bench import check, harness, serving, weights
from portbench.reference import dense, moe

from portbench.tests._portbench_cells import reduced_cell

CELLS = ["phi3-chat-poisson", "olmoe-decode-batch"]


@pytest.mark.parametrize("cell", CELLS)
def test_reference_equals_forward(cell):
    from repro_torch.config import RunConfig
    from repro_torch.models.model import forward
    cfg = reduced_cell(cell, dtype="float32").config
    mcfg = serving.port_config(cfg)
    w = weights.draw(cfg, 5, torch.device("cpu"), torch.float32)
    tokens = torch.randint(0, cfg["vocab"], (1, 40),
                           generator=torch.Generator().manual_seed(1))
    rc = RunConfig(dtype="float32", param_dtype="float32", remat=False)
    with torch.no_grad():
        want = forward(w, {"tokens": tokens}, mcfg, rc)[0]
    ref = {"dense": dense, "moe": moe}[cfg["reference"]]
    got = ref.logits_at(w, cfg, tokens[0], torch.arange(40))
    torch.testing.assert_close(got, want.float(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cell", CELLS)
def test_served_tokens_are_the_references(cell):
    """The timed path in float32 (the CPU's plain kernels): every sampled
    served token is the reference's first choice but for near ties."""
    c = reduced_cell(cell, dtype="float32")
    out = harness.run(c, 2**31 + 77, 3.0, False, torch.device("cpu"),
                      started=time.time())
    assert out["correct"]
    assert out["checked"]["requests"] > 0 and out["checked"]["tokens"] > 0
    assert out["checked"]["served_logit_gap"] < 1e-3


def test_fp8_control_rounds_operands():
    x = torch.randn(64, 32, generator=torch.Generator().manual_seed(0))
    y = dense.fp8(x)
    assert not torch.equal(x, y)
    assert (y - x).abs().max() <= x.abs().max() * 2 ** -3
    assert torch.equal(dense.fp8(y), y)


def test_sample_keeps_the_longest():
    from portbench.bench.serving import Rec, Run
    from portbench.bench.traffic import Request
    recs = []
    for i in range(20):
        r = Rec(Request(i, 0.0, [1], 4), finish_t=1.0)
        r.generated = [0] * (i % 7 + 1)
        recs.append(r)
    run = Run({}, 4, recs, [], 0.0, 2.0, 2.0, 0.0)
    a = check.sample(run, 3, 5)
    assert len(a) == 5 and len(a[0].generated) == 7
    assert [r.req.idx for r in a] == [r.req.idx for r in
                                      check.sample(run, 3, 5)]
