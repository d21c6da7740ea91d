"""ctypes bridge to the native C++ FASTQ/FASTA parser and 2-bit packer
(``hga_tpu_torch/native/fastq_pack.cpp``): the port's copy of
``hga_tpu.io.native``.

The library is built with g++ at first use into ``hga_tpu_torch/_build/``
under a file name keyed by a hash of the source and the flags (as
ops/cuda_build.py names the CUDA libraries).  It is written under a
temporary name and moved into place with ``os.replace``, so processes that
build at once never load a half-written file.

The library is optional: a missing compiler or ``zlib.h`` makes
``available()`` False (``UNAVAILABLE`` holds the reason, which is also
logged at warning level), and models/pipeline.load_reads takes the
pure-Python reader (io/fastq.py), which defines the semantics.  It is the
host reader; no device or kernel depends on it.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from typing import Iterator, List, Optional, Tuple

import numpy as np

log = logging.getLogger(__name__)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "native", "fastq_pack.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ("-O3", "-shared", "-fPIC")
LINK = ("-lz",)
NAME_CAP = 128

_lib: Optional[ctypes.CDLL] = None
# why the library is unavailable (the compiler's or loader's message), or
# None while it is available or not tried yet
UNAVAILABLE: Optional[str] = None


def lib_path() -> str:
    h = hashlib.sha256(" ".join(("g++",) + CXX_FLAGS + LINK).encode())
    with open(SRC, "rb") as fh:
        h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libhga_native_{h.hexdigest()[:16]}.so")


def _build(lib: str) -> Optional[str]:
    """Compile the library to `lib`; returns None, or why it failed."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = ["g++", *CXX_FLAGS, SRC, "-o", tmp, *LINK]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        return f"{' '.join(cmd)}: {e}"
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        return (f"{' '.join(cmd)} exited {proc.returncode}:\n"
                f"{proc.stderr.strip()}")
    os.replace(tmp, lib)
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, UNAVAILABLE
    if _lib is not None or UNAVAILABLE is not None:
        return _lib
    lib = lib_path()
    err = None if os.path.exists(lib) else _build(lib)
    if err is None:
        try:
            handle = ctypes.CDLL(lib)
        except OSError as e:
            err = f"loading {lib}: {e}"
    if err is not None:
        UNAVAILABLE = err
        log.warning("native reader unavailable, the Python reader runs: %s",
                    err)
        return None
    handle.hga_open.restype = ctypes.c_void_p
    handle.hga_open.argtypes = [ctypes.c_char_p]
    handle.hga_close.restype = None
    handle.hga_close.argtypes = [ctypes.c_void_p]
    handle.hga_read_batch.restype = ctypes.c_long
    handle.hga_read_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p, ctypes.c_int,
    ]
    _lib = handle
    return handle


def available() -> bool:
    """Whether the native library is built (building it at first call)."""
    return _load() is not None


def read_packed_batches(
    path: str, pad_len: int, batch_reads: int = 8192
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray, List[str]]]:
    """Stream (packed, bad, lengths, names) batches from one file natively.

    The same arrays as io/encode.pack_reads over io/fastq.iter_records(path)
    with the same pad_len; raises RuntimeError if the native library is
    unavailable.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native reader unavailable: {UNAVAILABLE}")
    if pad_len % 16:
        raise ValueError("pad_len must be a multiple of 16")
    h = lib.hga_open(path.encode())
    if not h:
        raise OSError(f"cannot open {path}")
    n_words = pad_len // 16
    n_bad = (pad_len + 31) // 32
    try:
        while True:
            packed = np.zeros((batch_reads, n_words), np.uint32)
            bad = np.zeros((batch_reads, n_bad), np.uint32)
            lengths = np.zeros(batch_reads, np.int32)
            names_buf = ctypes.create_string_buffer(batch_reads * NAME_CAP)
            n = lib.hga_read_batch(
                h, batch_reads, pad_len,
                packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                bad.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                names_buf, NAME_CAP)
            if n < 0:
                raise ValueError(f"parse error in {path}")
            if n == 0:
                return
            raw = names_buf.raw
            names = [raw[i * NAME_CAP:(i + 1) * NAME_CAP]
                     .split(b"\0", 1)[0].decode() for i in range(n)]
            yield packed[:n], bad[:n], lengths[:n], names
    finally:
        lib.hga_close(h)
