"""``tp_matmul`` (``repro_torch.distributed.collective_matmul``) on 8 gloo
processes of the CPU over a 2 x 4 mesh, as the reference's test runs it
on 8 host devices (``tests/test_distributed.py:123``): bulk (COPIFT) and
ring (COPIFTv2) each equal the one-device ``x @ w`` to 1e-5, bulk issues
only an all-gather and ring only point-to-point sends, each moving
``collective_bytes_estimate``'s bytes for a device.  The processes run in
a child (``tests/_tp_matmul_child.py``) that destroys its process group,
so no test inherits one."""
import json
import os
import socket
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.distributed.collective_matmul import (
    collective_bytes_estimate, recording)
from repro_torch.roofline import collective_bytes

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def child():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "_tp_matmul_child.py"),
         str(port)], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("policy", ["copift", "copiftv2"])
def test_tp_matmul_equals_one_device(child, policy):
    r = child[policy]
    assert r["err"] <= 1e-5
    assert r["placements"] == ["Replicate()", "Shard(dim=1)"]


def test_bulk_issues_one_all_gather(child):
    r = child["copift"]
    assert r["comm"] == {"c10d._allgather_base_": 1}
    est = collective_bytes_estimate(64, 32, 4, 4)
    assert r["records"] == [["all-gather", est["bulk_front_loaded_bytes"]]]


def test_ring_sends_n_minus_one_shards(child):
    """No collective (``CommDebugMode`` sees none), n - 1 = 3 sends of
    ``ring_per_step_bytes`` each, ``bulk_front_loaded_bytes`` in all."""
    r = child["copiftv2"]
    assert r["comm"] == {}
    est = collective_bytes_estimate(64, 32, 4, 4)
    assert r["records"] == [["collective-permute",
                             est["ring_per_step_bytes"]]] * 3
    assert collective_bytes(map(tuple, r["records"]))["total"] == \
        est["bulk_front_loaded_bytes"]


def test_ring_and_bulk_bits(child):
    """On the CPU's plain product the row blocks sum alike: the same
    bits."""
    assert child["bit_equal"] is True


def test_rules_on_a_device_mesh(child):
    assert child["same_specs"] is True
    wq = child["wq"]
    assert wq["spec"] == [None, "data", "model"]
    assert wq["placements"] == ["Shard(dim=1)", "Shard(dim=2)"]
    assert wq["local"] == [2, 32, 2, 4] and wq["round_trip"]


def test_collective_bytes_estimate_as_the_reference():
    from repro.distributed.collective_matmul import (
        collective_bytes_estimate as jax_estimate)
    for args in ((64, 32, 4, 4), (1024, 3072, 16), (8, 8, 1)):
        assert collective_bytes_estimate(*args) == jax_estimate(*args)


def test_recording_nests_and_ends():
    from repro_torch.distributed.collective_matmul import _record
    with recording() as outer:
        _record("all-gather", 8)
        with recording() as inner:
            _record("collective-permute", 4)
    _record("all-reduce", 2)
    assert outer == [("all-gather", 8), ("collective-permute", 4)]
    assert inner == [("collective-permute", 4)]
