"""Native (C++) runtime components, loaded through ctypes.

Counterpart of ``banggameengine_tpu/native``: the OBJ loader
(``objloader.cpp``) and the xcb presentation window (``xcbwindow.cpp``),
the JAX package's sources copied verbatim.  :func:`build_native` compiles
them with ``g++`` at first use into ``banggameengine_tpu_torch/_build/``
(never into the JAX package).  Every native entry point has a Python
counterpart that stays the semantics-defining reference; a failed build
is logged, and its callers take the Python route.
"""

from banggameengine_tpu_torch.native.build import (  # noqa: F401
    LIB_PATH,
    build_native,
    native_available,
)
from banggameengine_tpu_torch.native.objloader_binding import (  # noqa: F401
    load_obj_native,
)

__all__ = ["LIB_PATH", "build_native", "native_available", "load_obj_native"]
