"""Build the package's CUDA kernels at first use, load them with ctypes,
and keep the registry of the hand kernels.

Every kernel source under ``*/csrc/`` has a plain ``extern "C"`` launcher
and includes no PyTorch header, so ``nvcc`` builds it in seconds.  Each
library goes to its own directory under :data:`BUILD_DIR` (ninja rebuilds
it when the source or the flags change); separate directories hold
separate build locks, so several kernels may build at once from different
threads.  A failed build raises.

- :class:`Library`: one source, its flags and its launcher.  It builds and
  loads the library at first use, launches on the current stream of a
  device and turns a launcher's non-zero return into a ``RuntimeError``.
- :class:`HandKernel`: a library that stands in for a kernel of the JAX
  package, with the wrapper the main path calls, the wrapper's plain
  PyTorch twin and a count of its launches.  Each wrapper module makes
  its one ``HandKernel`` when it is imported, which enters it into
  :data:`KERNELS`, the registry.  ``graphs.py`` counts launches through
  the registry; the card's tools and tests read their kernels from it.

A wrapper module loaded from outside this package (another tree's copy,
as ``scripts/compare_kernels.py`` loads one) makes a kernel that builds
its own library, under the name ``other_<library>``, and stays out of
the registry.
"""

from __future__ import annotations

import ctypes
import os
from typing import Callable, Sequence

import torch

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
CUDA_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a")
_PACKAGE = __name__.rpartition(".")[0]

# the registry: every hand kernel of the modules imported so far, by key
KERNELS: dict[str, "HandKernel"] = {}


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


class Library:
    """The CUDA library ``name`` built from ``source`` with ``flags``.

    Its launcher ``<symbols>_launch`` takes ``argtypes``, the last of them
    the stream, and returns 0 or an error code that
    ``<symbols>_error_string`` names; ``symbols`` defaults to ``name``
    without its ``bge_`` prefix.  ``on_load(lib)`` checks the loaded
    library (it raises on a mismatch)."""

    def __init__(self, name: str, source: str, argtypes: Sequence,
                 flags: Sequence[str] = (), symbols: str | None = None,
                 on_load: Callable[[ctypes.CDLL], None] | None = None):
        self.name = name
        self.source = source
        self.argtypes = list(argtypes)
        self.flags = tuple(flags)
        self.symbols = symbols or name.removeprefix("bge_")
        self.on_load = on_load
        self._lib: ctypes.CDLL | None = None

    def load(self) -> ctypes.CDLL:
        """Build the library for sm_90a at first use and load it.  A failed
        build raises."""
        if self._lib is None:
            lib = load_library(self.name, self.source, self.flags)
            self._launch = getattr(lib, self.symbols + "_launch")
            self._launch.argtypes = self.argtypes
            self._launch.restype = ctypes.c_int
            self._error = getattr(lib, self.symbols + "_error_string")
            self._error.argtypes = [ctypes.c_int]
            self._error.restype = ctypes.c_char_p
            if self.on_load is not None:
                self.on_load(lib)
            self._lib = lib
        return self._lib

    def launch(self, device: torch.device, *args) -> None:
        """The launcher on ``args`` and the current stream of ``device``;
        a non-zero return raises ``RuntimeError``."""
        self.load()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = self._launch(*args, stream)
        if err != 0:
            msg = self._error(err).decode()
            raise RuntimeError(f"{self.symbols} kernel launch failed: {msg}")


class HandKernel(Library):
    """A hand kernel: a :class:`Library` under the registry's ``key``,
    with ``wrapper`` (the public function the main path calls, which takes
    the kernel for CUDA tensors), its plain PyTorch twin ``plain`` (same
    arguments, same outputs, on any device) and ``replaces``, the TPU
    kernel of the JAX package it stands for (``path:line``; None where
    XLA fuses plain code).  ``launches`` counts its launches, and through
    ``graphs.py`` the launches that graph replays ran."""

    def __init__(self, key: str, name: str, source: str, argtypes: Sequence,
                 *, wrapper: Callable, plain: Callable,
                 replaces: str | None, flags: Sequence[str] = (),
                 on_load: Callable[[ctypes.CDLL], None] | None = None):
        own = wrapper.__module__.partition(".")[0] == _PACKAGE
        super().__init__(name if own else "other_" + name, source, argtypes,
                         flags, name.removeprefix("bge_"), on_load)
        self.key = key
        self.wrapper = wrapper
        self.plain = plain
        self.replaces = replaces
        self.launches = 0
        if own:
            KERNELS[key] = self

    def launch(self, device: torch.device, *args) -> None:
        super().launch(device, *args)
        self.launches += 1
