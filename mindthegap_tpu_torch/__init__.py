"""mindthegap_tpu_torch — the PyTorch/CUDA port of mindthegap_tpu.

Same `find`/`fill` CLI surface, flags, defaults and output bytes as the JAX
package; the reference scan runs on an NVIDIA GPU through hand-written CUDA
kernels (csrc/), everything else runs on the host. The package imports
torch and never jax: the host modules it shares with the JAX package are
copies, because importing any module of `mindthegap_tpu` imports jax.
"""

__version__ = "0.1.0"

# Version string of the reference tool whose behavior we reproduce
# (reference src/main.cpp:29).
MTG_COMPAT_VERSION = "2.3.0"

KSIZE_LIST = (32, 64, 96, 128)  # supported kmer-size spans (reference CMakeLists.txt:62)
KSIZE_STRING = " ".join(str(x) for x in KSIZE_LIST)


class NotYetPorted(RuntimeError):
    """An engine or option of the JAX package that this port does not run yet."""

    def __init__(self, what: str):
        super().__init__(f"{what} is not yet ported to mindthegap_tpu_torch")
