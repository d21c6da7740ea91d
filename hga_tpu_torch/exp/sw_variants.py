"""Harness: banded SW by anti-diagonals, a warp per pair (X2), beside K3'.

Counterpart of exp/sw_variants.py.  ``sw_pallas_exp`` launches X2
(``csrc/sw_variants.cu`` ``swv_kernel<PACKED, K, G, FLAGS>``), which
replaces the Pallas kernels ``_kernel_v1`` (exp/sw_variants.py:32),
``_kernel_v2`` (:95) and ``_kernel_v3`` (:326): K3's function (SWResult:
score, qend, tend) swept along anti-diagonals over the query slots, with the
per-slot band bounds of ``_dlohi`` and a reversed, padded target window.

Variants, by the reference's names:
  v1            int32 state, a warp per pair
  v1no{ts,s1,mask,best}...  v1's timing ablations (compile-time flags;
                never compared, and with no plain version)
  v2            int16 state, two slots packed in 32 bits (SIMD + DPX);
                raises unless every score and anti-diagonal fit int16
  v3, v3g<G>    int32, a warp walks G pairs interleaved (G 4 by default)

What bounds it on an H100: about 12 int32 operations per in-band cell, but a
warp sweeps 32 K slots a step whatever the band (K = slots a lane); see
csrc/sw_variants.cu for the design.  ``pair_tile`` sets the block: pair_tile
/ 32 warps (1..8), 4 by default.  The reference's ``blk`` (anti-diagonals
per window copy) has no counterpart: the whole window sits in shared memory.

The wrapper checks dtype, shape and contiguity and raises on anything else.
On a CUDA tensor it launches the kernel (or raises); on a CPU tensor it
returns the plain version, ops.align.banded_sw_batch.  There is no
fallback.

    python -m hga_tpu_torch.exp.sw_variants [--time] [--variants v1,v2]
        [--band 64] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import ctypes
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from hga_tpu_torch.ops import cuda_build
from hga_tpu_torch.ops.align import (SWResult, banded_sw_batch, check_scores,
                                     sw_cells)
from hga_tpu_torch.ops import align_cuda as AC
from hga_tpu_torch.utils.benchmarks import time_ms
from hga_tpu_torch.utils.device import resolve_device

# launches of each variant's kernel by the wrapper (reset_launches())
LAUNCHES: Dict[str, int] = {"v1": 0, "v2": 0, "v3": 0, "v1_ablation": 0}

SMEM_MAX = 232448              # shared memory a block may opt in to (227 KB)
I16_MAX = 32767
FLAG_BITS = {"ts": 1, "s1": 2, "mask": 4, "best": 8}
# (packed, G, flags) -> slots a lane (K) that csrc/sw_variants.cu builds
BUILT: Dict[Tuple[bool, int, int], Tuple[int, ...]] = {
    (False, 1, 0): (1, 2, 4, 8),
    **{(False, 1, f): (4,) for f in range(1, 16)},
    (False, 2, 0): (1, 2, 4),
    (False, 4, 0): (1, 2, 4),
    (True, 1, 0): (2, 4, 8),
}

_LIB: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(cuda_build.build("sw_variants"))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.hga_swv_launch.argtypes = [vp] * 4 + [ci] * 12 + [vp] * 4
        lib.hga_swv_launch.restype = ci
        lib.hga_swv_attrs.argtypes = [ci] * 4 + [ctypes.POINTER(ci)] * 2
        lib.hga_swv_attrs.restype = ci
        _LIB = lib
    return _LIB


def parse_variant(variant: str) -> Tuple[bool, int, int]:
    """(packed int16, pair groups G, ablation flags) of a variant name, as
    the reference reads it."""
    if variant.startswith("v3"):
        g = int(variant[3:].lstrip("g") or 4) if len(variant) > 2 else 4
        return False, g, 0
    if variant.startswith("v1"):
        return False, 1, sum(bit for f, bit in FLAG_BITS.items()
                             if f"no{f}" in variant)
    if variant.startswith("v2"):
        return True, 1, 0
    raise ValueError(f"unknown variant {variant!r} (v1, v1no..., v2, v3, "
                     "v3g<G>)")


def slots_per_lane(variant: str, Lq: int) -> int:
    """The smallest built K (slots a lane) with 32 K >= Lq."""
    key = parse_variant(variant)
    if key not in BUILT:
        raise ValueError(f"no kernel for variant {variant!r}: built "
                         f"{sorted(BUILT)} (packed, G, flags)")
    for K in BUILT[key]:
        if 32 * K >= Lq:
            return K
    raise ValueError(f"Lq={Lq} exceeds {32 * BUILT[key][-1]} slots of "
                     f"variant {variant!r}")


def kernel_attrs(variant: str, Lq: int) -> Tuple[int, int]:
    """(registers per thread, local bytes per thread) of the instantiation
    that runs `variant` at query length Lq."""
    packed, G, flags = parse_variant(variant)
    K = slots_per_lane(variant, Lq)
    regs, local = ctypes.c_int(), ctypes.c_int()
    err = _lib().hga_swv_attrs(int(packed), K, G, flags, ctypes.byref(regs),
                               ctypes.byref(local))
    if err:
        raise RuntimeError(f"cudaFuncGetAttributes failed with error {err}")
    return regs.value, local.value


def _dlohi(qlen: torch.Tensor, tlen: torch.Tensor, Lq: int, band: int):
    """Per-slot in-band anti-diagonal bounds (slot p -> i = p + 1): cell
    (i, d - i) is in the band and the lengths iff dlo <= d <= dhi (dhi -1:
    never).  The kernel computes the same bounds in registers, with tlen
    clamped to the target width as banded_sw_batch clamps it."""
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
    if packed and (max(match, 1) * Lq > I16_MAX or Lq + Lt > I16_MAX
                   or min(mismatch, gap) < -I16_MAX):
        raise ValueError(f"v2 keeps scores and anti-diagonals in int16: "
                         f"Lq={Lq}, Lt={Lt}, match={match} exceed it")
    K = slots_per_lane(variant, Lq)
    if not q.is_cuda:
        if flags:
            raise ValueError(f"{variant} is a timing ablation of v1: it runs "
                             "only as a kernel and has no plain version")
        return banded_sw_batch(q, t, qlen, tlen, band=band, match=match,
                               mismatch=mismatch, gap=gap)
    win = Lt + 64 * K
    smem = (pair_tile // 32) * (((win + 1) // 2 + 1) * 4 if packed
                                else G * win * 4)
    if smem > SMEM_MAX:
        raise ValueError(f"the target windows take {smem} bytes of shared "
                         f"memory a block > {SMEM_MAX}")
    outs = tuple(torch.zeros(N, dtype=torch.int32, device=q.device)
                 for _ in range(3))
    if N and Lq and Lt:
        run_kernel(q, t, qlen, tlen, outs, variant, band, match, mismatch,
                   gap, pair_tile)
        LAUNCHES["v1_ablation" if flags else variant[:2]] += 1
    return SWResult(*outs)


def run_kernel(q, t, qlen, tlen, outs, variant: str, band: int = 64,
               match: int = 2, mismatch: int = -4, gap: int = -3,
               pair_tile: int = 128) -> None:
    """Launch X2 on the current stream into outs = (score, qend, tend);
    operands as sw_pallas_exp checks them."""
    packed, G, flags = parse_variant(variant)
    N, Lq = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().hga_swv_launch(
            q.data_ptr(), t.data_ptr(), qlen.data_ptr(), tlen.data_ptr(), N,
            Lq, t.shape[1], band, match, mismatch, gap, int(packed),
            slots_per_lane(variant, Lq), G, flags, pair_tile // 32,
            *(o.data_ptr() for o in outs), stream)
    if err:
        raise RuntimeError(f"sw variant {variant} launch failed: CUDA error "
                           f"{err}")


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
        # a warp sweeps all 32 K slots of each anti-diagonal up to its last
        # one in band (dhi.max): the slot-steps it does beside the cells
        _, dhi = _dlohi(sets[0][2], sets[0][3], Lq, band)
        row["swept"] = int(32 * slots_per_lane(variant, Lq)
                           * (dhi.max(dim=1).values - 1).sum())
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
