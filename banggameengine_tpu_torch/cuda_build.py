"""Build the package's CUDA kernels at first use and load them with ctypes.

Every kernel source under ``*/csrc/`` has a plain ``extern "C"`` launcher
and includes no PyTorch header, so ``nvcc`` builds it in seconds.  Each
library goes to its own directory under :data:`BUILD_DIR` (ninja rebuilds
it when the source or the flags change); separate directories hold
separate build locks, so several kernels may build at once from different
threads.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import os
from typing import Sequence

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
CUDA_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a")


def load_library(name: str, source: str,
                 extra_flags: Sequence[str] = ()) -> ctypes.CDLL:
    """Build ``source`` for sm_90a into ``BUILD_DIR/name`` and load it."""
    from torch.utils.cpp_extension import load

    build_dir = os.path.join(BUILD_DIR, name)
    os.makedirs(build_dir, exist_ok=True)
    path = load(name=name, sources=[source],
                extra_cuda_cflags=[*CUDA_FLAGS, *extra_flags],
                build_directory=build_dir, is_python_module=False,
                verbose=False)
    return ctypes.CDLL(path or os.path.join(build_dir, name + ".so"))
