"""Harness: banded SW over the band window, three layouts (X2), beside K3'.

Counterpart of exp/sw_variants.py.  ``sw_pallas_exp`` launches X2
(``csrc/sw_variants.cu``), which replaces the Pallas kernels ``_kernel_v1``
(exp/sw_variants.py:32), ``_kernel_v2`` (:95) and ``_kernel_v3`` (:326):
K3's function (SWResult: score, qend, tend) swept along anti-diagonals over
a window of S slots that follows the band (S = band + 1, rows i0(d) ..
i0(d) + band), or over the query's Lq rows where band + 1 >= Lq.

Variants, by the reference's names:
  v1            int32, a warp per pair (K slots a lane, 32 K >= S)
  v1no{ts,s1,mask,best}...  v1's timing ablations (compile-time flags at
                the timing shape's K 3; never compared, and with no plain
                version)
  v2            int16 state, two slots packed in 32 bits, a warp per pair;
                raises unless every score and anti-diagonal fit int16
  v3, v3g<G>    int32, G pairs a warp (G 4 by default), floor(32 / G) lanes
                a pair, all G advanced in the same step, each on its own
                window; G must divide pair_tile, as the reference's slicing
                h = P // G requires

Routes (plan): the slots in registers (K slots a lane, built K in REG_KS;
v2 H packed words a lane, built H in PACKED_HS); past them (S beyond 16
slots a lane, or 512 in v2, or G > 32) the slots in memory, in shared
memory or, past 227 KB a block, in a device scratch.  No query-length or
band cap: the windows are staged 256 anti-diagonals at a time.

What bounds it on an H100: about 12 int32 operations per in-band cell, but
a warp sweeps all its slots a step whatever the band; see
csrc/sw_variants.cu for the design.  ``pair_tile`` sets the block:
pair_tile / 32 warps (1..8), 4 by default.  The reference's ``blk``
(anti-diagonals per window copy) has its counterpart in the 256
anti-diagonals a staged window serves.

The wrapper checks dtype, shape and contiguity and raises on anything else.
On a CPU tensor it returns the plain version, ops.align.banded_sw_batch,
before any check of the kernel's shape; on a CUDA tensor it launches the
kernel (or raises).  There is no fallback.

    python -m hga_tpu_torch.exp.sw_variants [--time] [--variants v1,v2]
        [--band 64] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import ctypes
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from hga_tpu_torch.ops import cuda_build
from hga_tpu_torch.ops.align import (SWResult, banded_sw_batch, check_scores,
                                     sw_cells)
from hga_tpu_torch.ops import align_cuda as AC
from hga_tpu_torch.utils import spans
from hga_tpu_torch.utils.benchmarks import time_ms
from hga_tpu_torch.utils.device import resolve_device

# the name of each variant's launches by the wrapper (spans.launch); v1's
# timing ablations count apart
COUNTER = {"v1": "sw_variants_v1", "v2": "sw_variants_v2",
           "v3": "sw_variants_v3", "v1_ablation": "sw_variants_v1_ablation"}

SMEM_MAX = 232448              # shared memory a block may opt in to (227 KB)
I16_MAX = 32767
FLAG_BITS = {"ts": 1, "s1": 2, "mask": 4, "best": 8}
CHUNK = 256                    # anti-diagonals a staged window serves
REG_KS = (1, 2, 3, 4, 5, 6, 8, 9, 10, 12, 16)   # int32 slots a lane built
PACKED_HS = (1, 2, 3, 4, 6, 8)                   # v2 words a lane built
ABLATION_K = 3                 # the K v1's ablations are built at
ROUTES = {"registers": 0, "packed": 1, "memory": 2}
# every instantiation csrc/sw_variants.cu builds: (route, K, flags)
BUILT = ([("registers", k, 0) for k in REG_KS]
         + [("registers", ABLATION_K, f) for f in range(1, 16)]
         + [("packed", h, 0) for h in PACKED_HS] + [("memory", 0, 0)])

_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(cuda_build.build("sw_variants"))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.hga_swv_launch.argtypes = [vp] * 4 + [ci] * 12 + [vp] * 5
        lib.hga_swv_launch.restype = ci
        lib.hga_swv_attrs.argtypes = [ci] * 3 + [ctypes.POINTER(ci)] * 2
        lib.hga_swv_attrs.restype = ci
        _LIB = lib
    return _LIB


def parse_variant(variant: str) -> Tuple[bool, int, int]:
    """(packed int16, pairs a warp G, ablation flags) of a variant name, as
    the reference reads it."""
    if variant.startswith("v3"):
        g = int(variant[3:].lstrip("g") or 4) if len(variant) > 2 else 4
        if g < 1:
            raise ValueError(f"{variant}: G = {g} pair groups")
        return False, g, 0
    if variant.startswith("v1"):
        return False, 1, sum(bit for f, bit in FLAG_BITS.items()
                             if f"no{f}" in variant)
    if variant.startswith("v2"):
        return True, 1, 0
    raise ValueError(f"unknown variant {variant!r} (v1, v1no..., v2, v3, "
                     "v3g<G>)")


def window(Lq: int, Lt: int, band: int) -> Tuple[bool, int]:
    """(query layout, slots a pair S): the band window of band + 1 slots, or
    the query's Lq rows where band + 1 >= Lq (band clamped to Lq + Lt)."""
    band = min(band, Lq + Lt)
    return (True, Lq) if band + 1 >= Lq else (False, band + 1)


def pair_words(swept: int) -> int:
    """int32 words of shared memory a pair on the register routes (the
    staged windows for `swept` slots; csrc/sw_variants.cu pair_words)."""
    return 2 * ((CHUNK // 2 + swept + 5) & ~1)


def mem_words(S: int) -> int:
    """int32 words a pair on the memory route: three rows of S + 2 and each
    slot's best H and d."""
    return 3 * (S + 2) + 2 * S


class Plan(NamedTuple):
    route: str      # "registers", "packed" or "memory"
    K: int          # slots a lane (registers), words a lane (packed), 0
    G: int          # pairs a warp
    lanes: int      # lanes a pair (32 // G; 0 on the memory route)
    S: int          # slots a pair
    swept: int      # slots a pair sweeps a step (lanes x K, 64 H, or S)
    query: bool     # the query layout (else the band window)
    warps: int      # warps a block
    smem: int       # dynamic shared memory a block, bytes
    scratch: int    # int32 words of the memory route's device scratch


def plan(variant: str, N: int, Lq: int, Lt: int, band: int,
         pair_tile: int = 128) -> Plan:
    """The route csrc/sw_variants.cu takes for `variant` at this shape:
    the slots in registers where a built K (H) holds them and the windows
    fit 227 KB a block, else the slots in memory."""
    packed, G, flags = parse_variant(variant)
    warps = pair_tile // 32
    query, S = window(Lq, Lt, band)
    if packed:
        H = next((h for h in PACKED_HS if 64 * h >= S), 0)
        smem = warps * pair_words(64 * H) * 4
        if H and smem <= SMEM_MAX:
            return Plan("packed", H, 1, 32, S, 64 * H, query, warps, smem, 0)
    else:
        L = 32 // G if G <= 32 else 0
        K = next((k for k in REG_KS if L and L * k >= S), 0)
        smem = warps * G * pair_words(L * K) * 4
        if flags and K != ABLATION_K:
            raise ValueError(f"{variant} is built at {ABLATION_K} slots a "
                             f"lane (S <= {32 * ABLATION_K}); S = {S} here")
        if K and smem <= SMEM_MAX:
            return Plan("registers", K, G, L, S, L * K, query, warps, smem,
                        0)
    if flags:
        raise ValueError(f"{variant}: the ablations run on the register "
                         "route only")
    smem = warps * G * mem_words(S) * 4
    scratch = 0
    if smem > SMEM_MAX:
        blocks = -(-N // (warps * G))
        smem, scratch = 0, blocks * warps * G * mem_words(S)
    return Plan("memory", 0, G, 0, S, S, query, warps, smem, scratch)


def kernel_attrs(variant: str, Lq: int, Lt: int, band: int,
                 pair_tile: int = 128) -> Tuple[int, int]:
    """(registers per thread, local bytes per thread) of the instantiation
    that runs `variant` at this shape."""
    p = plan(variant, 1, Lq, Lt, band, pair_tile)
    regs, local = ctypes.c_int(), ctypes.c_int()
    err = _lib().hga_swv_attrs(ROUTES[p.route], p.K, parse_variant(variant)[2],
                               ctypes.byref(regs), ctypes.byref(local))
    if err:
        raise RuntimeError(f"cudaFuncGetAttributes failed with error {err}")
    return regs.value, local.value


def _dlohi(qlen: torch.Tensor, tlen: torch.Tensor, Lq: int, band: int):
    """Per-slot in-band anti-diagonal bounds (slot p -> i = p + 1): cell
    (i, d - i) is in the band and the lengths iff dlo <= d <= dhi (dhi -1:
    never): the reference's bounds, which the kernel's query layout
    computes in registers (tlen clamped to the target width, as
    banded_sw_batch clamps it); the band window's follow its rows."""
    i = torch.arange(1, Lq + 1, dtype=torch.int32, device=qlen.device)[None]
    ql = qlen.to(torch.int32)[:, None]
    tl = tlen.to(torch.int32)[:, None]
    dlo = (i + torch.clamp(i - band, min=1)).expand(qlen.shape[0], Lq)
    dhi = torch.where(i <= ql, i + torch.minimum(tl, i + band), -1)
    return dlo, dhi


def sw_pallas_exp(q: torch.Tensor, t: torch.Tensor, qlen: torch.Tensor,
                  tlen: torch.Tensor, band: int = 64, match: int = 2,
                  mismatch: int = -4, gap: int = -3, pair_tile: int = 128,
                  variant: str = "v2") -> SWResult:
    """X2: batched banded local SW, score + end cell, by the named variant;
    bit-exact with ops.align.banded_sw_batch (v2 within int16).  q, t int32
    (N, Lq), (N, Lt), lengths int32 (N,), on one CUDA device (CPU tensors:
    the plain version)."""
    AC.check_operands(q, t, qlen, tlen)
    check_scores(band, gap)
    packed, G, flags = parse_variant(variant)
    N, Lq = q.shape
    Lt = t.shape[1]
    if pair_tile % 32 or not 1 <= pair_tile // 32 <= 8:
        raise ValueError(f"pair_tile={pair_tile}: 32, 64, ..., 256 pairs "
                         "a block")
    if pair_tile % G:
        raise ValueError(f"{variant}: G = {G} pair groups must divide "
                         f"pair_tile={pair_tile}")
    if packed and (max(match, 1) * Lq > I16_MAX or Lq + Lt > I16_MAX - 4
                   or min(mismatch, gap) < -I16_MAX):
        raise ValueError(f"v2 keeps scores and anti-diagonals in int16: "
                         f"Lq={Lq}, Lt={Lt}, match={match} exceed it")
    if not q.is_cuda:
        if flags:
            raise ValueError(f"{variant} is a timing ablation of v1: it runs "
                             "only as a kernel and has no plain version")
        return banded_sw_batch(q, t, qlen, tlen, band=band, match=match,
                               mismatch=mismatch, gap=gap)
    outs = tuple(torch.zeros(N, dtype=torch.int32, device=q.device)
                 for _ in range(3))
    if N and Lq and Lt:
        with spans.launch(COUNTER["v1_ablation" if flags else variant[:2]]):
            run_kernel(q, t, qlen, tlen, outs, variant, band, match,
                       mismatch, gap, pair_tile)
    return SWResult(*outs)


def run_kernel(q, t, qlen, tlen, outs, variant: str, band: int = 64,
               match: int = 2, mismatch: int = -4, gap: int = -3,
               pair_tile: int = 128) -> None:
    """Launch X2 on the current stream into outs = (score, qend, tend);
    operands as sw_pallas_exp checks them.  The memory route's device
    scratch, where it needs one, is allocated here; device memory that
    cannot hold it raises with the byte count."""
    N, Lq = q.shape
    Lt = t.shape[1]
    p = plan(variant, N, Lq, Lt, band, pair_tile)
    scratch = None
    if p.scratch:
        free, _ = torch.cuda.mem_get_info(q.device)
        if 4 * p.scratch > free:
            raise ValueError(f"the slots' device scratch takes "
                             f"{4 * p.scratch} bytes; {free} are free")
        scratch = torch.empty(p.scratch, dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().hga_swv_launch(
            q.data_ptr(), t.data_ptr(), qlen.data_ptr(), tlen.data_ptr(), N,
            Lq, Lt, band, match, mismatch, gap, ROUTES[p.route], p.K, p.G,
            parse_variant(variant)[2], p.warps,
            None if scratch is None else scratch.data_ptr(),
            *(o.data_ptr() for o in outs), stream)
    if err:
        raise RuntimeError(f"sw variant {variant} launch failed ({p}): CUDA "
                           f"error {err}")


def swept_slot_steps(variant: str, qlen: torch.Tensor, tlen: torch.Tensor,
                     Lq: int, Lt: int, band: int,
                     pair_tile: int = 128) -> int:
    """The slot-steps `variant`'s warps sweep on these lengths: each warp
    runs its window's slots (idle lanes' included) over the anti-diagonals
    from its first step to its pairs' last in-band one, in whole unrolled
    bodies (2 steps; 4 in v2's band window; 1 on the memory route)."""
    N = qlen.shape[0]
    p = plan(variant, N, Lq, Lt, band, pair_tile)
    band = min(band, Lq + Lt)
    ql = qlen.to(torch.int64).clamp(0, Lq)
    tl = tlen.to(torch.int64).clamp(max=Lt)
    dend = torch.where(ql >= 1, ql + torch.minimum(tl, ql + band), 1)
    pad = (-N) % p.G
    dend = torch.cat([dend, dend.new_ones(pad)]).reshape(-1, p.G)
    dend = dend.max(dim=1).values
    if p.route == "memory":
        return int(p.G * p.S * (dend - 1).clamp(min=0).sum())
    d0 = 2 if p.query else 2 - (band & 1)
    body = 4 if p.route == "packed" and not p.query else 2
    steps = ((dend - d0 + 1).clamp(min=0) + body - 1) // body * body
    per_warp = 64 * p.K if p.route == "packed" else 32 * p.K
    return int(per_warp * steps.sum())


def planted_inputs(N: int, Lq: int, Lt: int, seed: int = 0):
    """check()'s inputs (the reference's, same numpy stream): random codes,
    a real overlap planted in every other pair, ragged lengths."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (N, Lq)).astype(np.int32)
    t = rng.integers(0, 4, (N, Lt)).astype(np.int32)
    for n in range(0, N, 2):
        L = int(rng.integers(40, Lq))
        off = int(rng.integers(0, Lt - L))
        t[n, off:off + L] = q[n, :L]
    ql = rng.integers(Lq // 2, Lq + 1, N).astype(np.int32)
    tl = rng.integers(Lt // 2, Lt + 1, N).astype(np.int32)
    return q, t, ql, tl


def check(variant: str, band: int = 64, N: int = 256, Lq: int = 128,
          Lt: int = 256, seed: int = 0, device="cuda") -> None:
    """Raise unless `variant` equals banded_sw_batch on planted pairs."""
    dev = resolve_device(device)
    args = [torch.from_numpy(x).to(dev)
            for x in planted_inputs(N, Lq, Lt, seed)]
    ref = banded_sw_batch(*args, band=band)
    got = sw_pallas_exp(*args, band=band, variant=variant)
    for f in ("score", "qend", "tend"):
        a, b = getattr(ref, f).cpu(), getattr(got, f).cpu()
        bad = torch.nonzero(a != b)[:, 0]
        if bad.numel():
            raise AssertionError((variant, f, bad[:5].tolist(),
                                  a[bad[:5]].tolist(), b[bad[:5]].tolist()))
    print(f"{variant}: exact on {N} pairs (band={band}, {dev.type})",
          flush=True)


def timing_sets(n_pairs: int, Lq: int, Lt: int, dev):
    """timeit()'s inputs: uniform random pairs at full lengths, 4 distinct
    query sets (q + i) % 4 (1 on the CPU) sharing one target set."""
    rng = np.random.default_rng(0)
    q = rng.integers(0, 4, (n_pairs, Lq)).astype(np.int32)
    t = torch.from_numpy(rng.integers(0, 4, (n_pairs, Lt)).astype(np.int32))
    ql = torch.full((n_pairs,), Lq, dtype=torch.int32)
    tl = torch.full((n_pairs,), Lt, dtype=torch.int32)
    n_sets = 4 if dev.type == "cuda" else 1
    return [tuple(x.to(dev) for x in (torch.from_numpy((q + i) % 4), t, ql,
                                      tl)) for i in range(n_sets)]


def timeit(variant: str, n_pairs: int = 4096, Lq: int = 128, Lt: int = 256,
           band: int = 64, device="cuda", pair_tile: int = 128) -> Dict:
    """GCUPS of `variant` (v0 = the production kernel: K3' at Lq <= 256)
    beside the production kernel's at the same shape; on the card also each
    kernel's launch alone, without the wrappers' torch preprocessing."""
    dev = resolve_device(device)
    reps = 20 if dev.type == "cuda" else 1
    sets = timing_sets(n_pairs, Lq, Lt, dev)

    def k3(*a):
        return AC.banded_sw_batch_cuda(*a, band=band)

    fn = k3 if variant == "v0" else (
        lambda *a: sw_pallas_exp(*a, band=band, variant=variant,
                                 pair_tile=pair_tile))
    ms = time_ms(fn, sets, reps, dev)
    k3_ms = time_ms(k3, sets, reps, dev)
    cells = sw_cells([Lq], [Lt], band) * n_pairs
    row = dict(variant=variant, n_pairs=n_pairs, Lq=Lq, Lt=Lt, band=band,
               pair_tile=pair_tile, ms=ms, cells=cells,
               gcups=cells / (ms * 1e-3) / 1e9, k3_ms=k3_ms,
               k3_gcups=cells / (k3_ms * 1e-3) / 1e9, device=dev.type)
    msg = (f"{variant} pt={pair_tile}: {row['gcups']:8.2f} GCUPS "
           f"({ms:.3f} ms/call, {n_pairs} pairs, {dev.type})   K3' "
           f"{row['k3_gcups']:8.2f} GCUPS ({k3_ms:.3f} ms)")
    if variant != "v0":
        # the slot-steps the variant's warps sweep beside the cells
        row["swept"] = swept_slot_steps(variant, sets[0][2], sets[0][3],
                                        Lq, Lt, band, pair_tile)
        row["in_band"] = cells / row["swept"]
    if dev.type == "cuda":
        row["k3_kernel_ms"] = time_ms(
            AC.run_kernel, [AC.kernel_operands(*a, band=band) for a in sets],
            reps, dev)
        row["kernel_ms"] = row["k3_kernel_ms"] if variant == "v0" else \
            time_ms(lambda *a: run_kernel(*a, variant=variant, band=band,
                                          pair_tile=pair_tile),
                    [(*a, tuple(torch.empty(n_pairs, dtype=torch.int32,
                                            device=dev) for _ in range(3)))
                     for a in sets], reps, dev)
        msg += (f"   kernels alone: {row['kernel_ms']:.3f} ms, K3' "
                f"{row['k3_kernel_ms']:.3f} ms")
    print(msg, flush=True)
    return row


def timeit_pt(variant: str, pair_tile: int, n_pairs: int = 4096,
              Lq: int = 128, Lt: int = 256, band: int = 64,
              device="cuda") -> Dict:
    """timeit at another block size (pair_tile / 32 warps)."""
    return timeit(variant, n_pairs=n_pairs, Lq=Lq, Lt=Lt, band=band,
                  device=device, pair_tile=pair_tile)


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--variants", default="v1,v2")
    ap.add_argument("--band", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rows = []
    for v in args.variants.split(","):
        ablation = "no" in v
        if v.startswith(("v1", "v2", "v3")) and not ablation:
            check(v, band=args.band, device=dev)
        if args.time:
            if ablation and dev.type == "cpu":
                print(f"{v}: an ablation runs only as a kernel; not timed "
                      "on cpu", flush=True)
                continue
            rows.append(timeit(v, band=args.band, device=dev))
    return rows


if __name__ == "__main__":
    main()
