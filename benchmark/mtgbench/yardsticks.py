"""Yardsticks of the kernels (roofline/<kernel>.py names its own).

The reference scans (K1, K6): the least time one job's scan of the
reference could take, from the reference's length and k alone, whatever
the map's layout.

Bytes: the 2-bit reference read once, one 32-byte sector for each k-mer
queried, one result byte a position. Operations: a rolling update of the
k-mer and its reverse complement, the canonical choice, a 64-bit hash and
a compare, counted as 12 int32 operations a k-mer. The bound is the larger
of bytes over the memory's rate and operations over the int32 rate."""

SECTOR_BYTES = 32
OPS_PER_KMER = 12


def scan_least_seconds(inputs: dict, peaks: dict) -> float:
    n, k = inputs["ref_bp"], inputs["k"]
    kmers = max(n - k + 1, 0)
    n_bytes = n / 4 + kmers * SECTOR_BYTES + n
    return max(n_bytes / peaks["bytes_per_s"], kmers * OPS_PER_KMER / peaks["int32_ops_per_s"])
