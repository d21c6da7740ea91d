from hga_tpu_torch.io.encode import (  # noqa: F401
    PackedReads,
    pack_reads,
    unpack_read,
    encode_bases,
    decode_bases,
    revcomp_str,
)
from hga_tpu_torch.io.fastq import read_sequence_files, write_fasta  # noqa: F401
