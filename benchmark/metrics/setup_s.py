"""setup_s: seconds from the start of the run to the window's opening (the
inputs made, the kernels loaded or built, the warm-up job), host clock."""


def read(run):
    return run.setup_s
