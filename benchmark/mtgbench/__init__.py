"""The benchmark of mindthegap_tpu_torch: the harness (harness.py), the
inputs (gen.py), the plain reference (reference/), the comparison
(compare.py), the device trace (trace.py), the readers' helpers
(readers.py), the kernels' yardsticks (yardsticks.py) and the control
(control.py). It imports neither JAX nor the JAX package."""
