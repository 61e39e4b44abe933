"""The port's build helper: native libraries build into the port's own
build directory (never next to the sources, where the JAX package builds),
and a failed build raises instead of falling back."""

import os

import pytest

from mindthegap_tpu_torch import _build
from mindthegap_tpu_torch.ops import kmers as PK


def test_native_library_builds_into_the_port_build_dir():
    lib = PK._load_native()
    assert os.path.dirname(lib._name) == _build.BUILD_DIR
    assert os.path.exists(os.path.join(_build.BUILD_DIR, "libmtgkmers.so"))


def test_failed_build_raises():
    with pytest.raises(_build.BuildError, match="build failed"):
        _build.native_library("no_such_source.cpp", "libmtg_missing.so")
    assert not os.path.exists(os.path.join(_build.BUILD_DIR, "libmtg_missing.so"))
