"""The metric arithmetic on synthetic timelines: latencies with refused
and unfinished requests counted as missing, rates over the window, the
counts of operations and bytes, and the reduction of a trace."""
import math

import pytest

from portbench.bench import readers, roofline, trace
from portbench.bench.serving import Rec, Run, Step
from portbench.bench.timeline import percentile
from portbench.bench.traffic import Request

CFG = {"reference": "dense", "n_layers": 2, "d_model": 8, "n_heads": 2,
       "n_kv_heads": 2, "head_dim": 4, "d_ff": 16, "vocab": 10,
       "dtype": "bfloat16"}


def rec(idx, due, first=None, last=None, finish=None, n=4, refused=False,
        placed=None, submit=None):
    r = Rec(Request(idx, due, [1, 2, 3], n), due_t=due,
            submit_t=due if submit is None else submit, refused=refused,
            placed_t=placed, first_t=first, last_t=last, finish_t=finish)
    return r


def timeline():
    recs = [rec(0, 0.0, first=1.0, last=1.3, finish=1.3, placed=0.1),
            rec(1, 1.0, first=1.5, last=2.1, finish=2.1, placed=1.1),
            rec(2, 2.0, refused=True),
            rec(3, 3.0, first=3.5, placed=3.2),        # unfinished
            rec(4, 11.0)]                              # due after close
    steps = [Step(0.0 + i, 0.5 + i, 16 if i % 2 else 0, [(0, 16 if i % 2
             else 1), (5, 1)], 2, True) for i in range(10)]
    steps.append(Step(10.0, 10.5, 0, [(7, 1)], 1, False))
    return Run(CFG, 4, recs, steps, 0.0, 10.0, 12.0, 21.5)


def test_percentile_nearest_rank():
    assert percentile([], 95) is None
    assert percentile([3.0], 95) == 3.0
    assert percentile(list(range(1, 101)), 95) == 95
    assert percentile(list(range(1, 21)), 95) == 19


def test_latencies_count_missing():
    run = timeline()
    # refused (due 2.0) and the never-answered count to the drain's end
    assert readers.read("ttft_p90_s", run) == pytest.approx(12.0 - 2.0)
    tpot = sorted([1e3 * 0.3 / 3, 1e3 * 0.6 / 3, 1e3 * (12.0 - 2.0) / 3,
                   1e3 * (12.0 - 3.5) / 3])
    assert readers.read("tpot_p90_ms", run) == pytest.approx(tpot[-1])
    assert readers.read("offer_lag_p90_ms.chat", run) == 0.0
    assert readers.read("queue_wait_p90_s.chat", run) == pytest.approx(
        12.0 - 2.0)


def test_rates_and_shares():
    run = timeline()
    assert readers.read("output_tokens_per_s", run) == pytest.approx(2.0)
    assert readers.read("step_ms.batch", run) == pytest.approx(1000.0)
    assert readers.read("chunk_step_ms.chat", run) == pytest.approx(500.0)
    assert readers.read("chunk_step_share.batch", run) == pytest.approx(50.0)
    assert readers.read("slot_occupancy.batch", run) == pytest.approx(50.0)
    assert readers.read("setup_s", run) == 21.5
    # no trace: the device metrics read nothing (never 0)
    for name in ("device_idle_share.chat", "queue_matmul_roofline.chat",
                 "decode_attention_roofline.batch"):
        assert readers.read(name, run) is None


def test_work_counts():
    d, V = CFG["d_model"], CFG["vocab"]
    per_token = 2 * (4 * d * 8 + 3 * d * 16)
    cols = [(0, 3), (5, 1)]
    pairs = (1 + 2 + 3) + 6
    want = 2 * (4 * per_token + 4 * 4 * 2 * pairs) + 2 * 2 * d * V
    assert roofline.model_flops(CFG, cols) == pytest.approx(want)
    # the bound of a product: max(ops / peak, bytes / bandwidth)
    b = roofline.matmul_bound(512, 3072, 8192, "bfloat16")
    assert b == pytest.approx(max(2 * 512 * 3072 * 8192 / 989e12,
                                  2 * (3072 * 8192 + 512 * 3072
                                       + 512 * 8192) / 3.35e12))
    # attention reads each slot's rows through its last column once
    att = roofline.decode_attention_bound(CFG, [(5, 1)])
    assert att == pytest.approx(2 * max(4 * 4 * 2 * 6 / 989e12,
                                        2 * (2 * 6 * 2 * 4 + 2 * 2 * 4)
                                        / 3.35e12))


def test_mfu_reads_a_share():
    run = timeline()
    v = readers.read("mfu.chat", run)
    flops = sum(roofline.model_flops(CFG, s.cols) for s in run.steps[:10])
    assert v == pytest.approx(100 * flops / (10.0 * 989e12))


class Ev:
    def __init__(self, name, start, dur, cuda):
        self._n, self._s, self._d, self._c = name, start, dur, cuda

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        import torch
        return (torch.autograd.DeviceType.CUDA if self._c
                else torch.autograd.DeviceType.CPU)

    def is_user_annotation(self):
        return False


def test_trace_reduction():
    ns0 = 1_700_000_000_000_000_000
    evs = [Ev("portbench.step", ns0, 600, False),
           Ev("portbench.observe", ns0 + 700, 300, False),
           Ev("void queue_matmul_thin<1>(...)", ns0 + 100, 200, True),
           Ev("void decode_attention_split<..>", ns0 + 250, 150, True),
           Ev("void moe_gemm_thin<..>", ns0 + 500, 100, True)]
    out = trace.reduce(evs, ns0, ns0 + 1000, 1e-6)
    assert out["busy_s"] == pytest.approx(400e-9)       # 100-400, 500-600
    assert trace.kernel_seconds(out, "queue_matmul") == pytest.approx(200e-9)
    assert trace.kernel_seconds(out, "decode_attention") == \
        pytest.approx(150e-9)
    assert trace.kernel_seconds(out, "moe_gemm") == pytest.approx(100e-9)
    assert trace.kernel_seconds(out, "rms_norm") is None
    gaps = dict(out["idle_gaps"])
    assert gaps["portbench.observe"] == pytest.approx(400e-9)
    assert math.isclose(sum(gaps.values()), 600e-9)
    assert out["device_ops"][0][0].startswith("void queue_matmul")
