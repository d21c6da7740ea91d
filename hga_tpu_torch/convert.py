"""Loaders from the JAX package's stage artifacts to the port's objects.

For this system the state carried between stages is its artifacts, not
weights.  Each loader takes an artifact as ``hga_tpu`` writes it — a path
to the ``.npz`` file, or a mapping of its numpy arrays — and returns the
port's object.  Both packages write byte-compatible artifacts under the same
config+input digests, so ``run_pipeline(..., resume=True)`` in the port
resumes from a directory the JAX package wrote, through these loaders.

* ``spectrum.npz``  -> models.spectrum.SpectrumResult
* ``corrected.npz`` -> io.encode.PackedReads (corrected long reads)
* ``overlaps.npz``  -> models.overlap.OverlapRecords
* ``candidates.npz`` -> models.seeding.SeedingResult
* packed reads      -> DeviceReads: the host PackedReads plus its packed
  words and lengths on a device (the copy correction/overlap gather from)
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Union

import numpy as np
import torch

from hga_tpu_torch.io.encode import PackedReads
from hga_tpu_torch.ops.kmer import words_to_tensor
from hga_tpu_torch.utils.device import resolve_device

Source = Union[str, Mapping[str, np.ndarray]]


def _arrays(src: Source) -> Mapping[str, np.ndarray]:
    if isinstance(src, Mapping):
        return src
    z = np.load(src, allow_pickle=False)
    return {k: z[k] for k in z.files}


def load_spectrum(src: Source):
    from hga_tpu_torch.models.spectrum import SpectrumResult

    z = _arrays(src)
    return SpectrumResult(hi=np.asarray(z["hi"]), lo=np.asarray(z["lo"]),
                          count=np.asarray(z["count"]),
                          hist=np.asarray(z["hist"]),
                          threshold=int(z["threshold"]), k=int(z["k"]),
                          distinct=int(z["distinct"]) if "distinct" in z
                          else -1)


def load_corrected(src: Source) -> PackedReads:
    z = _arrays(src)
    return PackedReads(
        packed=np.asarray(z["packed"]), bad=np.asarray(z["bad"]),
        length=np.asarray(z["length"]),
        names=[str(x) for x in z["names"]],
        category=np.asarray(z["category"]), pad_len=int(z["pad_len"]),
        qual=np.asarray(z["qual"]) if "qual" in z else None)


def load_overlaps(src: Source):
    from hga_tpu_torch.models.overlap import OverlapRecords

    z = _arrays(src)
    names = {f.name for f in dataclasses.fields(OverlapRecords)}
    return OverlapRecords(**{k: np.asarray(v) for k, v in z.items()
                             if k in names})


def load_candidates(src: Source):
    from hga_tpu_torch.models.seeding import SeedingResult

    z = _arrays(src)
    return SeedingResult(a=np.asarray(z["a"]), b=np.asarray(z["b"]),
                         rel=np.asarray(z["rel"]), diag=np.asarray(z["diag"]),
                         shared=np.asarray(z["shared"]),
                         overflow=int(z["overflow"]))


@dataclasses.dataclass
class DeviceReads:
    """A packed read set with its device copy."""

    host: PackedReads
    packed: torch.Tensor   # int32 (R, W): the uint32 words' bit patterns
    length: torch.Tensor   # int32 (R,)


def load_packed_reads(src: Union[Source, PackedReads],
                      device="cuda") -> DeviceReads:
    """Packed reads (a ``PackedReads.save`` file, its arrays, or a
    PackedReads of either package) with their words placed on `device`."""
    dev = resolve_device(device)
    if isinstance(src, (str, Mapping)):
        pr = load_corrected(src)
    else:
        pr = PackedReads(packed=src.packed, bad=src.bad, length=src.length,
                         names=list(src.names), category=src.category,
                         pad_len=int(src.pad_len), qual=src.qual)
    return DeviceReads(host=pr, packed=words_to_tensor(pr.packed, dev),
                       length=torch.from_numpy(
                           pr.length.astype(np.int32)).to(dev))
