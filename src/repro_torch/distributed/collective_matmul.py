"""Collective matmul policies: COPIFTv2's queue idea at the mesh level.

Tensor-parallel ``y = x @ W`` with ``x`` gathered across one mesh axis
(``model`` by default): ``x`` is sharded on its rows over the axis
(``Shard(0)``), ``W`` on its columns (``Shard(1)``), and ``y`` comes out
sharded on its columns (``Shard(1)``), replicated over the other axes.

* COPIFT-analogue (``bulk``, BASELINE and COPIFT): one all-gather of x over
  the axis, then one local product: all communication completes before
  any compute starts.
* COPIFTv2-analogue (``ring``): the shards flow around the axis' ring by
  point-to-point sends and receives (``batch_isend_irecv``), the send of
  the shard that goes next issued before the current one is multiplied: a
  depth-1 queue of shards.  Each chunk's product is written at its source
  row block.  The ring sends n - 1 shards, not the reference's n: its last
  permute (``collective_matmul.py:54`` of the JAX package) carries a shard
  that nothing multiplies.  At n = 1 nothing is sent.

Every local product goes through ``queue_matmul`` (its plain version on a
CPU tensor), under the caller's policy, as every product of the port does.
The collectives are ``torch.distributed`` 's (NCCL on the card, gloo on the
CPU); no collective is a kernel of the port.

While :func:`recording` is active, each collective appends a record of its
kind and the bytes it moved for this device: the all-gather the (n - 1)
shards this device receives, each send the one shard it carries (kind
``collective-permute``, the reference's name for a ring step).
:func:`repro_torch.roofline.collective_bytes` sums them by kind.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, List, Tuple

import torch
import torch.distributed as dist

from ..core.policy import ExecutionPolicy
from ..kernels.queue_matmul import queue_matmul

#: the active recorders' lists of (kind, bytes moved for this device)
_RECORDERS: List[List[Tuple[str, int]]] = []


@contextlib.contextmanager
def recording() -> Iterator[List[Tuple[str, int]]]:
    """Collect the records of the collectives issued inside the block."""
    recs: List[Tuple[str, int]] = []
    _RECORDERS.append(recs)
    try:
        yield recs
    finally:
        _RECORDERS.remove(recs)


def _record(kind: str, nbytes: int) -> None:
    for recs in _RECORDERS:
        recs.append((kind, int(nbytes)))


def _bulk(x: torch.Tensor, w: torch.Tensor, group, n: int,
          policy: ExecutionPolicy) -> torch.Tensor:
    """All-gather x's row shards, then one product."""
    xg = torch.empty((n * x.shape[0], x.shape[1]), dtype=x.dtype,
                     device=x.device)
    dist.all_gather_into_tensor(xg, x.contiguous(), group=group)
    _record("all-gather", (n - 1) * x.numel() * x.element_size())
    return queue_matmul(xg, w, policy=policy)


def _ring(x: torch.Tensor, w: torch.Tensor, group, n: int,
          policy: ExecutionPolicy) -> torch.Tensor:
    """x: (m/n, k) local shard; w: (k, p/n) local shard -> (m, p/n), one
    shard's product a step while the next shard is on its way."""
    idx = dist.get_group_rank(group, dist.get_rank())
    nxt_peer = dist.get_global_rank(group, (idx + 1) % n)
    prv_peer = dist.get_global_rank(group, (idx - 1) % n)
    m = x.shape[0]
    out = torch.empty((n, m, w.shape[1]), dtype=x.dtype, device=x.device)
    buf, src = x.contiguous(), idx
    for step in range(n):
        works, nxt = [], None
        if step < n - 1:
            nxt = torch.empty_like(buf)
            works = dist.batch_isend_irecv(
                [dist.P2POp(dist.isend, buf, nxt_peer, group),
                 dist.P2POp(dist.irecv, nxt, prv_peer, group)])
            _record("collective-permute", buf.numel() * buf.element_size())
        out[src] = queue_matmul(buf, w, policy=policy)
        for wk in works:
            wk.wait()
        buf, src = nxt, (src - 1) % n
    return out.reshape(n * m, w.shape[1])


def tp_matmul(x, w, mesh, *,
              policy: ExecutionPolicy = ExecutionPolicy.COPIFTV2,
              axis: str = "model"):
    """Sequence-parallel x (rows over ``axis``) times column-parallel W
    (columns over ``axis``) -> y, a DTensor with columns over ``axis``.
    ``x`` and ``w`` are DTensors (redistributed to those placements when
    they hold others) or full tensors, the same on every rank, which are
    distributed.  ``policy`` picks the schedule: COPIFTV2 the ring, the
    others the bulk gather."""
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    dim = mesh.mesh_dim_names.index(axis)

    def on_axis(p):
        return tuple(p if i == dim else Replicate()
                     for i in range(mesh.ndim))

    def local(t, placements):
        if isinstance(t, DTensor):
            return t.redistribute(mesh, placements).to_local()
        return distribute_tensor(t, mesh, placements).to_local()

    xl, wl = local(x, on_axis(Shard(0))), local(w, on_axis(Shard(1)))
    group, n = mesh.get_group(dim), mesh.size(dim)
    run = _ring if policy is ExecutionPolicy.COPIFTV2 else _bulk
    y = run(xl, wl, group, n, policy)
    return DTensor.from_local(y, mesh, on_axis(Shard(1)), run_check=False)


def collective_bytes_estimate(m: int, k: int, n_shards: int,
                              dtype_bytes: int = 2) -> dict:
    """Napkin model: both policies move the same payload; the ring splits it
    into chunks that overlap compute."""
    payload = m * k * dtype_bytes * (n_shards - 1) / n_shards
    return {"bulk_front_loaded_bytes": payload,
            "ring_per_step_bytes": payload / max(n_shards - 1, 1),
            "ring_steps": n_shards}


__all__ = ["collective_bytes_estimate", "recording", "tp_matmul"]
