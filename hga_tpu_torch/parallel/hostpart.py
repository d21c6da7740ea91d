"""L6 — host loops split over ranks (port of ``hga_tpu.parallel.hostpart``).

The stages with a large host part (candidate joins, window gathers, vote
packing) would be repeated on every rank of a naive run.  Here each rank
takes a contiguous block of the work items (`block_range`), so
concatenating the per-rank results in rank order reproduces the
one-process output exactly; the device work inside such a block runs on the
rank's own device only (`local_mesh`: None, one device a rank); results are
re-replicated by rank-ordered gathers of host arrays over the gloo group
(`allgather_concat`, `allgather_indexed_strings`).

Outside a world (or in a world of one) everything here is the identity.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# items each stage handled on this rank (stage -> count): what the
# partitioned runs' tests and chip_smoke.py read
WORK: Dict[str, int] = {}


def note(name: str, n: int) -> None:
    WORK[name] = WORK.get(name, 0) + int(n)


def _world() -> bool:
    return dist.is_available() and dist.is_initialized()


def pid() -> int:
    return dist.get_rank() if _world() else 0


def nproc() -> int:
    return dist.get_world_size() if _world() else 1


def is_main() -> bool:
    return pid() == 0


def block_range(n_items: int) -> Tuple[int, int]:
    """This rank's contiguous [lo, hi) block of n_items work items: sizes
    differ by at most 1, ordered by rank."""
    p, P = pid(), nproc()
    base, rem = divmod(n_items, P)
    lo = p * base + min(p, rem)
    return lo, lo + base + (1 if p < rem else 0)


def local_mesh(mesh):
    """The mesh for device work inside a partitioned region: the ranks hold
    different work there, so no collective may span them — None (the
    rank's own device) in a world of several ranks, else `mesh` as given."""
    return mesh if nproc() <= 1 else None


def fetch(x) -> np.ndarray:
    """A tensor (on any device) or an array, as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _padded_allgather(a: np.ndarray, n_max: int) -> np.ndarray:
    """Gather every rank's `a` padded to n_max rows -> (P, n_max, ...).
    The rows travel as bytes over the gloo group, so any dtype does."""
    from hga_tpu_torch.parallel.mesh import host_group

    a = np.ascontiguousarray(a)
    row = a.dtype.itemsize * int(np.prod(a.shape[1:], dtype=np.int64))
    buf = np.zeros((n_max, row), np.uint8)
    buf[: a.shape[0]] = a.view(np.uint8).reshape(a.shape[0], row)
    t = torch.from_numpy(buf)
    parts = [torch.empty_like(t) for _ in range(nproc())]
    dist.all_gather(parts, t, group=host_group())
    g = np.stack([p.numpy() for p in parts])
    return g.view(a.dtype).reshape(len(parts), n_max, *a.shape[1:])


def allgather_concat(arrays: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Rank-ordered concatenation of per-rank host arrays (axis 0).

    Every entry shares the leading dimension; counts may differ between
    ranks (zero included): padded to the largest, gathered, trimmed.
    """
    if nproc() <= 1:
        return arrays
    keys = sorted(arrays)
    n_local = int(arrays[keys[0]].shape[0]) if keys else 0
    counts = _padded_allgather(np.asarray([n_local], np.int64), 1).reshape(-1)
    n_max = int(counts.max())
    out: Dict[str, np.ndarray] = {}
    for k in keys:
        a = np.ascontiguousarray(arrays[k])
        assert a.shape[0] == n_local, (k, a.shape, n_local)
        if n_max == 0:
            out[k] = a
            continue
        g = _padded_allgather(a, n_max)
        out[k] = np.concatenate([g[r, : counts[r]] for r in range(g.shape[0])])
    return out


def allgather_indexed_strings(
    idx: Sequence[int], seqs: Sequence[str]
) -> Tuple[np.ndarray, List[str]]:
    """Gather (index, sequence) pairs from every rank, rank-ordered:
    sequences travel as one flat byte buffer and a length array."""
    idx = np.asarray(idx, np.int64)
    seqs = list(seqs)
    if nproc() <= 1:
        return idx, seqs
    lens = np.asarray([len(s) for s in seqs], np.int64)
    buf = np.frombuffer("".join(seqs).encode("ascii"), np.uint8)
    meta = allgather_concat({"idx": idx, "lens": lens})
    flat = allgather_concat({"buf": buf})["buf"]
    out: List[str] = []
    o = 0
    for L in meta["lens"]:
        out.append(flat[o : o + int(L)].tobytes().decode("ascii"))
        o += int(L)
    return meta["idx"], out
