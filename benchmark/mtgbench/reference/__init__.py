"""The benchmark's plain reference: what each job's output files must hold,
worked out from the inputs the benchmark made. It imports nothing of the
program."""
