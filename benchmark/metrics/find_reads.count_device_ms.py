"""find_reads.count_device_ms: device milliseconds a job spends in the
counting kernels (K3 kmer_keys, K4 partition/merge_fold/pad) and the sort
kernels, from the trace."""

from mtgbench.readers import SORT_KERNELS, device_seconds

KERNELS = ("kmer_keys_kernel", "partition_kernel", "merge_fold_kernel", "pad_kernel")


def read(run):
    s = device_seconds(run, KERNELS, SORT_KERNELS)
    return None if s is None else 1e3 * s / len(run.jobs)
