"""Multi-process runs (the counterpart of mindthegap_tpu/parallel/distributed.py).

The JAX package scales past one process with jax.distributed and a global
mesh. The port runs one process, whose mesh holds the devices it sees
(mesh.py); a run across processes, through torch.distributed, is not yet
ported.
"""

from __future__ import annotations

from .. import NotYetPorted


def init_distributed(coordinator_address: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Raises NotYetPorted: a run across processes is not yet ported."""
    raise NotYetPorted("a multi-process run (parallel/distributed.py init_distributed)")
