"""L0 — 2-bit base encoding and fixed-width packed read batches.

A copy of ``hga_tpu.io.encode`` (numpy only).  Every read batch is a dense,
fixed-width, 2-bit-packed `uint32` array (16 bases per word, LSB-first),
padded to one length so the whole batch moves to the device in one copy.

Encoding: A=0, C=1, G=2, T=3.  Ambiguous bases (N and other IUPAC codes) are
encoded as A (code 0) and flagged in a packed 1-bit "bad base" mask; any
k-mer window containing a flagged base is discarded downstream (SURVEY.md
Appendix A: N-handling policy).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

BASES = "ACGT"
BASES_PER_WORD = 16  # 2 bits/base, uint32 words
MASK_BITS_PER_WORD = 32

# byte -> 2-bit code lookup (uppercase + lowercase); ambiguous -> 0 (+bad flag)
_CODE_LUT = np.zeros(256, dtype=np.uint8)
_BAD_LUT = np.ones(256, dtype=np.uint8)
for _i, _b in enumerate(BASES):
    _CODE_LUT[ord(_b)] = _i
    _CODE_LUT[ord(_b.lower())] = _i
    _BAD_LUT[ord(_b)] = 0
    _BAD_LUT[ord(_b.lower())] = 0

_DECODE_LUT = np.frombuffer(b"ACGT", dtype=np.uint8)


def encode_bases(seq: str | bytes) -> Tuple[np.ndarray, np.ndarray]:
    """str/bytes -> (codes uint8[L], bad uint8[L])."""
    raw = np.frombuffer(seq.encode() if isinstance(seq, str) else seq, dtype=np.uint8)
    return _CODE_LUT[raw], _BAD_LUT[raw]


def decode_bases(codes: np.ndarray) -> str:
    return _DECODE_LUT[np.asarray(codes, dtype=np.uint8) & 3].tobytes().decode()


def revcomp_str(seq: str) -> str:
    codes, _ = encode_bases(seq)
    return decode_bases((3 - codes)[::-1])


@dataclasses.dataclass
class PackedReads:
    """A fixed-width batch of 2-bit-packed reads.

    packed:  uint32[R, ceil(pad_len/16)]  (LSB-first, 16 bases/word)
    bad:     uint32[R, ceil(pad_len/32)]  (1 bit/base; 1 = ambiguous base)
    length:  int32[R]   true read lengths (<= pad_len)
    names:   read ids (host-side only)
    category:int32[R]   source-file category (0=short/Illumina, 1=long/nanopore)
    qual:    optional uint8[R, pad_len] phred scores (0 past length) — the
             FASTQ quality plane, carried only when quality-weighted
             consensus is requested (cfg.use_quality; SURVEY.md L0
             per-read metadata).  None by default (io/fastq.py policy).
    """

    packed: np.ndarray
    bad: np.ndarray
    length: np.ndarray
    names: List[str]
    category: np.ndarray
    pad_len: int
    qual: Optional[np.ndarray] = None

    @property
    def n_reads(self) -> int:
        return int(self.packed.shape[0])

    def __len__(self) -> int:
        return self.n_reads

    def subset(self, idx) -> "PackedReads":
        idx = np.asarray(idx)
        return PackedReads(
            packed=self.packed[idx],
            bad=self.bad[idx],
            length=self.length[idx],
            names=[self.names[int(i)] for i in idx],
            category=self.category[idx],
            pad_len=self.pad_len,
            qual=self.qual[idx] if self.qual is not None else None,
        )

    def with_pad(self, pad_len: int) -> "PackedReads":
        """Truncate (or zero-extend) the pad width; lengths must fit.

        Length-bucketed processing (models/correction.py) uses this so a few
        very long reads don't force every batch to the maximum pad.
        pad_len must be a multiple of 32 (whole `bad` bitmask words).
        """
        if pad_len % 32:
            raise ValueError(f"pad_len={pad_len} not a multiple of 32")
        if int(self.length.max(initial=0)) > pad_len:
            raise ValueError("reads longer than requested pad")
        W = pad_len // 16
        WB = pad_len // 32
        if W <= self.packed.shape[1]:
            packed = self.packed[:, :W]
            bad = self.bad[:, :WB]
        else:
            packed = np.pad(self.packed, ((0, 0), (0, W - self.packed.shape[1])))
            bad = np.pad(self.bad, ((0, 0), (0, WB - self.bad.shape[1])))
        qual = None
        if self.qual is not None:
            if pad_len <= self.qual.shape[1]:
                qual = self.qual[:, :pad_len]
            else:
                qual = np.pad(self.qual,
                              ((0, 0), (0, pad_len - self.qual.shape[1])))
        return PackedReads(packed=packed, bad=bad, length=self.length,
                           names=self.names, category=self.category,
                           pad_len=pad_len, qual=qual)

    def save(self, path: str) -> None:
        extra = {} if self.qual is None else {"qual": self.qual}
        np.savez_compressed(
            path,
            packed=self.packed,
            bad=self.bad,
            length=self.length,
            names=np.array(self.names),
            category=self.category,
            pad_len=np.int64(self.pad_len),
            **extra,
        )

    @staticmethod
    def load(path: str) -> "PackedReads":
        z = np.load(path, allow_pickle=False)
        return PackedReads(
            packed=z["packed"],
            bad=z["bad"],
            length=z["length"],
            names=[str(x) for x in z["names"]],
            category=z["category"],
            pad_len=int(z["pad_len"]),
            qual=z["qual"] if "qual" in z.files else None,
        )


def _pack_2bit(codes: np.ndarray, pad_words: int) -> np.ndarray:
    """uint8[L] codes -> uint32[pad_words], 16 bases/word LSB-first."""
    L = codes.shape[0]
    buf = np.zeros(pad_words * BASES_PER_WORD, dtype=np.uint32)
    buf[:L] = codes
    buf = buf.reshape(pad_words, BASES_PER_WORD)
    shifts = (2 * np.arange(BASES_PER_WORD, dtype=np.uint32))[None, :]
    return np.bitwise_or.reduce(buf << shifts, axis=1).astype(np.uint32)


def _pack_1bit(bits: np.ndarray, pad_words: int) -> np.ndarray:
    L = bits.shape[0]
    buf = np.zeros(pad_words * MASK_BITS_PER_WORD, dtype=np.uint32)
    buf[:L] = bits
    buf = buf.reshape(pad_words, MASK_BITS_PER_WORD)
    shifts = np.arange(MASK_BITS_PER_WORD, dtype=np.uint32)[None, :]
    return np.bitwise_or.reduce(buf << shifts, axis=1).astype(np.uint32)


def pack_reads(
    seqs: Sequence[str | bytes],
    names: Optional[Sequence[str]] = None,
    category: Optional[Sequence[int]] = None,
    pad_len: Optional[int] = None,
    quals: Optional[Sequence[Optional[str]]] = None,
) -> PackedReads:
    """Pack a list of sequences into a fixed-width PackedReads batch.

    pad_len defaults to the max read length rounded up to a multiple of 16.
    Reads longer than pad_len are truncated (callers bucket by length first).
    quals: optional per-read FASTQ quality strings (phred+33); when given,
    the batch carries a uint8 quality plane (missing entries score 0).
    """
    n = len(seqs)
    lengths = np.array([len(s) for s in seqs], dtype=np.int32)
    if pad_len is None:
        pad_len = int(max(1, lengths.max() if n else 1))
    pad_len = ((pad_len + BASES_PER_WORD - 1) // BASES_PER_WORD) * BASES_PER_WORD
    n_words = pad_len // BASES_PER_WORD
    n_mask_words = (pad_len + MASK_BITS_PER_WORD - 1) // MASK_BITS_PER_WORD

    packed = np.zeros((n, n_words), dtype=np.uint32)
    bad = np.zeros((n, n_mask_words), dtype=np.uint32)
    for i, s in enumerate(seqs):
        codes, badbits = encode_bases(s)
        codes = codes[:pad_len]
        badbits = badbits[:pad_len]
        packed[i] = _pack_2bit(codes, n_words)
        bad[i] = _pack_1bit(badbits, n_mask_words)
    lengths = np.minimum(lengths, pad_len)

    qual = None
    if quals is not None:
        qual = np.zeros((n, pad_len), dtype=np.uint8)
        for i, qs in enumerate(quals):
            if not qs:
                continue
            raw = np.frombuffer(qs.encode("ascii"), np.uint8)[:pad_len]
            qual[i, : raw.size] = np.maximum(raw, 33) - 33  # phred+33

    return PackedReads(
        packed=packed,
        bad=bad,
        length=lengths,
        names=list(names) if names is not None else [f"read_{i}" for i in range(n)],
        category=(
            np.asarray(category, dtype=np.int32)
            if category is not None
            else np.zeros(n, dtype=np.int32)
        ),
        pad_len=pad_len,
        qual=qual,
    )


def unpack_read(pr: PackedReads, i: int) -> str:
    """Recover the base string of read i (for tests / FASTA output)."""
    words = pr.packed[i]
    L = int(pr.length[i])
    shifts = (2 * np.arange(BASES_PER_WORD, dtype=np.uint32))[None, :]
    codes = ((words[:, None] >> shifts) & 3).reshape(-1)[:L]
    return decode_bases(codes)


def unpack_codes(packed: np.ndarray) -> np.ndarray:
    """uint32[..., W] -> uint8[..., W*16] base codes (numpy oracle helper)."""
    shifts = (2 * np.arange(BASES_PER_WORD, dtype=np.uint32))
    out = (packed[..., None] >> shifts) & 3
    return out.reshape(*packed.shape[:-1], -1).astype(np.uint8)


def unpack_bad(bad: np.ndarray) -> np.ndarray:
    """uint32[..., W] -> uint8[..., W*32] bad-base flags."""
    shifts = np.arange(MASK_BITS_PER_WORD, dtype=np.uint32)
    out = (bad[..., None] >> shifts) & 1
    return out.reshape(*bad.shape[:-1], -1).astype(np.uint8)
