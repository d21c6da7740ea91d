"""The k-mer key kernel (csrc/kmer.cu) on the card against its plain
version (ops/kmer._keys_plain), bit for bit, and count_reads on the card
against the CPU.  Skips without a card.  This file imports no JAX; on a
machine with a card and without JAX run it alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kmer_cuda.py
"""

import numpy as np
import pytest
import torch

from hga_tpu_torch.config import AssemblerConfig
from hga_tpu_torch.io.encode import pack_reads
from hga_tpu_torch.models.spectrum import count_reads
from hga_tpu_torch.ops import kmer as K
from hga_tpu_torch.ops import kmer_cuda as KC
from hga_tpu_torch.utils import sim
from hga_tpu_torch.utils import spans


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _batch(rng, R, pad, dev):
    """R reads padded to `pad`: random words, N flags on the borders of
    packed (16) and bad-flag (32) words in every third read, lengths 0 to
    the pad."""
    packed = rng.integers(0, 2**32, (R, pad // 16),
                          dtype=np.uint64).astype(np.uint32)
    bad = np.zeros((R, -(-pad // 32)), np.uint32)
    for b in (15, 16, 31, 32, 47, 48, 63, 64):
        if b < pad:
            rows = np.arange(0, R, 3)[rng.random(-(-R // 3)) < 0.5]
            bad[rows, b >> 5] |= np.uint32(1 << (b & 31))
    length = np.full(R, max(0, pad - 12), np.int32)
    ragged = rng.random(R) < 0.25
    length[ragged] = rng.integers(0, pad + 1, int(ragged.sum()))
    return tuple(torch.from_numpy(x).to(dev) for x in (
        packed.view(np.int32), bad.view(np.int32), length))


CASES = [(65536, 112, 21), (1, 112, 21)] + [
    (4099, pad, k) for pad in (16, 288, 1024) for k in (1, 16, 17, 32)
    if k <= pad]


@pytest.mark.cuda
def test_kmer_keys_kernel_matches_plain(cuda):
    """The count's batch (65,536 reads of 7 words, k 21), a one-read tail
    batch, k 1, 16, 17 and 32 on pads 16, 288 and 1,024: equal slot for
    slot, one launch a call."""
    rng = np.random.default_rng(18)
    for R, pad, k in CASES:
        args = _batch(rng, R, pad, cuda)
        n = spans.launches()[KC.COUNTER]
        got = K.kmer_keys(*args, k)
        torch.cuda.synchronize()
        assert spans.launches()[KC.COUNTER] == n + 1
        assert torch.equal(got, K._keys_plain(*args, k)), (R, pad, k)


@pytest.mark.cuda
def test_count_reads_on_the_card_matches_cpu(cuda):
    """count_reads of a small read set on the card, field for field the
    CPU's, with one kernel launch a batch."""
    ds = sim.make_dataset(genome_len=30_000, short_cov=20, long_cov=0,
                          seed=18, short_err=0.01)
    pr = pack_reads(ds.short_seqs, names=ds.short_names, pad_len=112)
    cfg = AssemblerConfig(k=21, batch_reads=2048)
    n = spans.launches()[KC.COUNTER]
    card = count_reads(pr, cfg, device="cuda")
    assert spans.launches()[KC.COUNTER] - n == -(-pr.n_reads // 2048)
    cpu = count_reads(pr, cfg, device="cpu")
    for f in ("hi", "lo", "count", "hist"):
        np.testing.assert_array_equal(getattr(card, f), getattr(cpu, f))
    assert (card.threshold, card.n_distinct) == (cpu.threshold,
                                                 cpu.n_distinct)
