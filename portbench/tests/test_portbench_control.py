"""The control of each cell's check, at the reduced widths on the CPU:
the plain reference computed with float8 operands, put in the program's
place, reads a number the cell compares several times higher than the
bf16 program does.  Limits set between the two readings, as a cell's are
set at its own size, then makes the harness's own verdict find the
control not correct and the program correct on a fresh seed.  At the
cell's own size on the card the same readings, and the verdict on the
control with the cell's committed limits, come from
``portbench/readings.py``."""
import math
import time

import pytest
import torch

from portbench.bench import harness
from portbench.tests._portbench_cells import reduced_cell

CELLS = ["phi3-chat-poisson", "olmoe-decode-batch"]


def run(cell, seed):
    return harness.run(cell, seed, 3.0, False, torch.device("cpu"),
                       started=time.time(), control=True)


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_higher(cell):
    """At least one compared number separates the control from the program
    by 3x over the seeds; with those numbers' limits set between the
    readings, the verdict finds a fresh seed's program correct and its
    control not.  (A number that separates only at the cell's own size,
    such as olmoe's worst request over a few short requests here, is held
    to it by the card's readings.)"""
    c = reduced_cell(cell)
    compared = [k for k, v in c.check.items() if isinstance(v, dict)]
    program = {k: [] for k in compared}
    low = {k: [] for k in compared}
    for seed in (11, 2**31 + 5):
        out = run(c, seed)
        for k in compared:
            program[k].append(out["checked"][k])
            low[k].append(out["checked"][k.replace("served_", "control_")])
    apart = [k for k in compared if min(low[k]) >= 3 * max(program[k])]
    assert apart, (program, low)
    for k in compared:
        if k in apart:
            c.check[k]["limit"] = math.sqrt(max(program[k]) * min(low[k]))
        else:
            del c.check[k]
    out = run(c, 2**33 + 9)
    assert out["correct"] and not out["control_correct"], out["checked"]
