"""L6 — the rank mesh (port of ``hga_tpu.parallel.mesh``).

The JAX package runs one process over a mesh of devices on one "data" axis
and splits batches with ``shard_map``.  torch's idiom is one process per
card (``torchrun --nproc-per-node N``), so here the mesh is the world of
ranks: rank r holds one device, and a batch split over the mesh is split
over the ranks, each running the same kernels on its own card.

* ``init_distributed`` joins the world from torchrun's environment
  (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
  ``MASTER_ADDR``, ``MASTER_PORT``) and picks the backend by one rule:
  ``nccl`` when the ranks run on CUDA and each rank of this node has a card
  of its own, ``gloo`` for CPU ranks and for ranks that share a card (NCCL
  refuses two ranks on one card).  Without ``WORLD_SIZE`` it does nothing.
* Host arrays (hostpart) always go over a gloo group made once, whatever
  the main backend is; device tensors go over the main backend
  (collectives).
* ``Mesh`` is the world: its size and this process's rank.  The JAX
  package's ``data_sharding`` and ``replicated`` are sharding objects of
  a single-process program and have no counterpart here.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

_HOST_GROUP: list = []      # the gloo group host arrays go over
_IDLE_LOGGED: list = []


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The world of ranks on one "data" axis: `size` ranks, each with one
    device, and this process's `rank`."""

    size: int
    rank: int


def backend_rule(device_type: str, local_world: int, n_cards: int) -> str:
    """``nccl`` for CUDA ranks with a card each on this node, else
    ``gloo``."""
    if device_type == "cuda" and 0 < local_world <= n_cards:
        return "nccl"
    return "gloo"


def init_distributed(backend: Optional[str] = None, device="cuda",
                     init_method: Optional[str] = None) -> Optional[str]:
    """Join the world described by torchrun's environment; returns the
    backend, or None when ``WORLD_SIZE`` is not set (one process).

    `device` says where the ranks compute (``cuda`` by default; ``cpu``
    ranks always take gloo).  A `backend` the rule forbids raises; nothing
    turns an NCCL failure into gloo.  CUDA ranks bind their card
    (``LOCAL_RANK`` modulo the cards) before anything allocates.
    """
    if "WORLD_SIZE" not in os.environ:
        return None
    if dist.is_initialized():
        return dist.get_backend()
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ.get("RANK", "0"))
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    dev_type = torch.device(device).type
    n_cards = torch.cuda.device_count() if dev_type == "cuda" else 0
    if dev_type == "cuda" and n_cards == 0:
        raise RuntimeError("CUDA ranks were asked for but no card is "
                           "visible; pass device='cpu' for CPU ranks")
    rule = backend_rule(dev_type, local_world, n_cards)
    why = (f"{dev_type} ranks, {local_world} on this node, {n_cards} "
           f"card(s) visible")
    if backend is None:
        backend = rule
    elif backend not in ("nccl", "gloo") or (backend == "nccl"
                                              and rule != "nccl"):
        raise ValueError(f"backend {backend!r} is not allowed here ({why}): "
                         "nccl needs CUDA ranks with a card each")
    if dev_type == "cuda":
        torch.cuda.set_device(local_rank % n_cards)
    log.info("init_distributed: rank %d of %d, backend %s (rule: %s for "
             "%s)", rank, world, backend, rule, why)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world, rank=rank)
    host_group()
    return backend


def host_group():
    """The process group host arrays go over: the world itself when it
    runs gloo, else a gloo group over the same ranks, made once (every rank
    makes it at the same point, in init_distributed)."""
    if dist.get_backend() == "gloo":
        return None
    if not _HOST_GROUP:
        _HOST_GROUP.append(dist.new_group(backend="gloo"))
    return _HOST_GROUP[0]


def make_mesh() -> Mesh:
    """The mesh over the world (a mesh of one outside a world)."""
    if dist.is_available() and dist.is_initialized():
        return Mesh(size=dist.get_world_size(), rank=dist.get_rank())
    return Mesh(size=1, rank=0)


def auto_mesh(min_devices: int = 2) -> Optional[Mesh]:
    """The production mesh: the world when it has at least `min_devices`
    ranks, else None (the one-device path, no collectives).  One process
    that sees several cards outside a world uses one of them, and says once
    how to use the rest."""
    mesh = make_mesh()
    if mesh.size >= min_devices:
        return mesh
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if mesh.size == 1 and n > 1 and not _IDLE_LOGGED:
        _IDLE_LOGGED.append(True)
        log.info("auto_mesh: %d cards visible, one process uses one; %d stay "
                 "idle (torchrun --nproc-per-node %d uses them all)", n,
                 n - 1, n)
    return None


def shard_batch_fn(mesh: Optional[Mesh], inner, n_in: int, out_axes=None):
    """Wrap a leading-axis-batched function for data-parallel execution.

    `inner(*arrays)` maps a batch to same-leading-axis outputs with no
    cross-batch interaction.  On a mesh, rank r runs `inner` on its
    contiguous block of the batch and a rank-ordered all_gather rebuilds the
    whole; a batch not divisible by the mesh size runs whole on every rank.
    out_axes: the output's NamedTuple class, or None for one tensor.
    """
    if mesh is None or mesh.size <= 1:
        return inner
    from hga_tpu_torch.parallel.collectives import all_gather_cat

    P = mesh.size

    def f(*arrays):
        N = arrays[0].shape[0]
        if N % P:
            return inner(*arrays)
        nb = N // P
        lo = mesh.rank * nb
        out = inner(*(a[lo:lo + nb] for a in arrays[:n_in]),
                    *arrays[n_in:])
        if out_axes is None:
            return all_gather_cat(out)
        return out_axes(*(all_gather_cat(x) for x in out))

    return f


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
