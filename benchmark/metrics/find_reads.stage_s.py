"""find_reads.stage_s: seconds a job spends staging the reads' codes into
the counter's buffers, read by read: the -profile span "graph build" less
its direct children (parse, flush, readback, solid filter, branching,
save), the mean over jobs. None where "graph build" has no child span."""

from mtgbench.readers import phase_mean

PARENT = "graph build"


def read(run):
    head = PARENT + " / "
    children = sorted({p for j in run.jobs for p in j.phases if p.startswith(head) and " / " not in p[len(head):]})
    total, inner = phase_mean(run, PARENT), phase_mean(run, *children)
    if total is None or inner is None:
        return None
    return total - inner
