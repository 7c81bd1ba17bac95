"""The launch geometry of ``rglru_scan``'s reverse walk
(``kernels/rglru_scan/plan.py``, the ranges ``rglru_scan.cu``'s
``bwd_geometry`` computes on the card), on the CPU: every (b, t, channel)
is written exactly once at ragged B, T and w and at the chunk and segment
edges, whatever residency the card reports; a channel's chunks lie in
neighbouring lanes of one warp for the carry; recurrentgemma's training
shape fits an H100 in one wave at the residency the launch bound
guarantees; the kernel's constants are the plan's; and
``chip_smoke.py``'s profile gives each of the source's kernels a line of
its own."""
import ast
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _calibration_isolation import isolated_calibration  # noqa: F401

from repro_torch.kernels.rglru_scan import plan

ROOT = Path(__file__).resolve().parents[1]
SOURCE = (ROOT / "src" / "repro_torch" / "kernels" / "rglru_scan" / "csrc"
          / "rglru_scan.cu")

#: (B, T, w): T = 1, T at and either side of a chunk (8), a segment's
#: least (64) and most (32 chunks: 256) steps, and a multiple of segments;
#: w odd, under a tile, at and either side of 8, 16 and 32; B up to 8
SHAPES = [(1, 1, 1), (3, 1, 37), (1, 7, 16), (1, 8, 32), (1, 9, 33),
          (2, 37, 20), (1, 63, 8), (2, 64, 31), (1, 65, 17), (3, 255, 37),
          (3, 256, 37), (3, 257, 37), (1, 700, 64), (2, 511, 100),
          (4, 129, 15), (8, 100, 40), (1, 1030, 24)]

#: residencies a card might report: what the launch bound guarantees, one
#: block an SM whatever the size (every halving taken), and plenty (none
#: taken)
RESIDENCIES = {
    "bound": plan.bound_resident,
    "one": lambda n: 1,
    "plenty": lambda n: 32,
}


def _each_once(geo):
    b, t, c = plan.elements(geo)
    assert b.size == geo.B * geo.T * geo.w
    assert (t >= 0).all() and (t < geo.T).all()
    idx = np.ravel_multi_index((b, t, c), (geo.B, geo.T, geo.w))
    assert (np.bincount(idx, minlength=geo.B * geo.T * geo.w) == 1).all()


@pytest.mark.parametrize("res", sorted(RESIDENCIES))
@pytest.mark.parametrize("sms", [132, 4])
@pytest.mark.parametrize("b,t,w", SHAPES)
def test_every_element_is_written_exactly_once(b, t, w, sms, res):
    _each_once(plan.geometry(b, t, w, sms, RESIDENCIES[res]))


def test_recurrentgemma_training_fits_one_wave():
    """B, T, w = 2, 512, 2560 on 132 SMs at the residency the launch bound
    guarantees: every block resident at once, each SM given one, every
    element once.  (The card test holds the same at the residency the
    occupancy query reports.)"""
    geo = plan.geometry(2, 512, 2560, plan.H100_SMS, plan.bound_resident)
    assert geo.waves == 1
    assert geo.blocks >= plan.H100_SMS
    assert geo.tile == 32
    _each_once(geo)


def test_a_grid_past_one_wave_keeps_its_shape():
    """B = 8 at w = 2560 needs more than one wave on an H100; the chunks are
    halved no further than a 64-step segment, and every element is still
    written once."""
    geo = plan.geometry(8, 512, 2560, plan.H100_SMS, plan.bound_resident)
    assert geo.waves > 1
    assert geo.segment == plan.MIN_SEGMENT
    _each_once(geo)


@pytest.mark.parametrize("res", sorted(RESIDENCIES))
@pytest.mark.parametrize("b,t,w", SHAPES + [(2, 512, 2560), (8, 512, 2560),
                                             (1, 4096, 300)])
def test_geometry_rules(b, t, w, res):
    resident = RESIDENCIES[res]
    geo = plan.geometry(b, t, w, 132, resident)
    assert geo.tile in plan.TILES
    # the widest tile that gives each SM a block, else the narrowest
    wider = [x for x in plan.TILES if x > geo.tile]
    assert all(b * -(-w // x) < 132 for x in wider)
    assert b * geo.tiles >= 132 or geo.tile == plan.TILES[-1]
    # whole warps, a power of two of chunks within a warp's lanes
    assert geo.threads % 32 == 0 and geo.threads <= plan.MAX_THREADS
    assert geo.chunks & (geo.chunks - 1) == 0
    assert geo.chunks <= plan.MAX_CHUNKS
    assert geo.resident == resident(geo.threads)
    # halved only while more than one wave, and never below the least
    if geo.waves > 1:
        assert (geo.segment <= plan.MIN_SEGMENT
                or geo.threads == 32)
    grown = plan.geometry(b, t, w, 132, lambda n: 32)
    assert geo.chunks <= grown.chunks
    # as many chunks as T needs when nothing else binds
    need = -(-t // plan.STEPS)
    if grown.threads > 32 and grown.chunks < plan.MAX_CHUNKS and \
            grown.threads < plan.MAX_THREADS:
        assert grown.chunks >= need


@pytest.mark.parametrize("res", sorted(RESIDENCIES))
@pytest.mark.parametrize("b,t,w", SHAPES + [(2, 512, 2560)])
def test_the_carry_holds_a_channel_in_one_warp(b, t, w, res):
    geo = plan.geometry(b, t, w, 132, RESIDENCIES[res])
    chunk, channel = plan.carry_lanes(geo)
    # a bijection onto the block's (chunk, channel) slots
    slots = set(zip(chunk.tolist(), channel.tolist()))
    assert slots == {(j, c) for j in range(geo.chunks)
                     for c in range(geo.tile)}
    tid = np.arange(geo.threads)
    for c in range(geo.tile):
        lanes = tid[channel == c]
        # one warp, neighbouring lanes, chunk order
        assert len(set((lanes // 32).tolist())) == 1
        assert (np.diff(lanes) == 1).all()
        assert (chunk[lanes] == np.arange(geo.chunks)).all()


@pytest.mark.parametrize("threads", [32, 64, 128, 256, 512])
def test_the_bound_residency_fits_an_h100_sm(threads):
    """At the most registers the launch bound lets ptxas give a thread
    (65536 / 512 = 128), the blocks :func:`plan.bound_resident` counts fit
    one H100 SM: its 65536 registers, 2048 threads and 32 blocks."""
    r = plan.bound_resident(threads)
    assert r >= 1
    assert r * threads * (65536 // plan.MAX_THREADS) <= 65536
    assert r * threads <= 2048 and r <= 32


def test_the_kernel_uses_the_plan_constants():
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert const("kBwdL") == plan.STEPS
    assert const("kBwdMaxThreads") == plan.MAX_THREADS
    assert const("kBwdMaxChunks") == plan.MAX_CHUNKS
    assert const("kBwdMinSegment") == plan.MIN_SEGMENT
    assert "__launch_bounds__(kBwdMaxThreads)" in src


def _globals(path):
    """The ``__global__`` kernels a CUDA source defines, by name (past a
    ``__launch_bounds__(...)``, whose arguments may hold parentheses)."""
    src, names = path.read_text(), []
    for m in re.finditer(r"__global__\s+void\s+", src):
        i = m.end()
        if src.startswith("__launch_bounds__", i):
            depth, i = 0, src.index("(", i)
            while True:
                depth += {"(": 1, ")": -1}.get(src[i], 0)
                i += 1
                if depth == 0:
                    break
        names.append(re.match(r"\s*(\w+)\s*\(", src[i:])[1])
    return names


def _profile_groups():
    """``PROFILE_GROUPS`` of chip_smoke.py, read without importing it."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "PROFILE_GROUPS"
                for t in node.targets):
            return tuple(ast.literal_eval(node.value))
    raise AssertionError("chip_smoke.py has no PROFILE_GROUPS")


def test_the_profile_lists_each_rglru_kernel_on_its_own_line():
    """A profiled kernel joins the first group whose name it contains: each
    ``__global__`` of ``rglru_scan.cu``, as the profiler names it, finds a
    group, and no two of them the same one."""
    names = _globals(SOURCE)
    assert sorted(names) == ["rglru_scan_bwd_kernel", "rglru_scan_kernel"]
    groups = _profile_groups()
    found = {}
    for name in names:
        # the profiler's demangled name of an instantiation
        shown = f"void (anonymous namespace)::{name}<float>(float const*)"
        hits = [g for g in groups if g in shown]
        assert hits, name
        found[name] = hits[0]
    assert len(set(found.values())) == len(names)


def test_every_kernel_of_the_port_finds_a_profile_group():
    groups = _profile_groups()
    sources = sorted((ROOT / "src" / "repro_torch" / "kernels").rglob("*.cu"))
    names = [n for p in sources for n in _globals(p)]
    assert "rglru_scan_bwd_kernel" in names
    for name in names:
        assert any(g in name for g in groups), name
