"""On-demand build of the native shared library.

``g++ -O2 -std=c++17 -shared -fPIC`` of the two sources into
``banggameengine_tpu_torch/_build/native/libbangnative.so``, rebuilt when
a source is newer.  Each build writes a file of its own and renames it
into place, so processes that build at once never load a half-written
library.
"""

from __future__ import annotations

import logging
import os
import subprocess
import tempfile

log = logging.getLogger("native")

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build", "native")
LIB_PATH = os.path.join(BUILD_DIR, "libbangnative.so")
SOURCES = (
    os.path.join(_DIR, "objloader.cpp"),
    os.path.join(_DIR, "xcbwindow.cpp"),
)


def build_native(force: bool = False) -> str | None:
    """Compile the native library if needed.  Returns its path, or None
    (with the reason logged) when the build fails."""
    if not force and os.path.exists(LIB_PATH):
        newest_src = max(os.path.getmtime(s) for s in SOURCES)
        if os.path.getmtime(LIB_PATH) >= newest_src:
            return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", *SOURCES,
           "-o", tmp, "-ldl"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, LIB_PATH)
        return LIB_PATH
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired,
            FileNotFoundError) as e:
        err = getattr(e, "stderr", b"")
        log.warning("native build failed: %s %s", e, err[:500] if err else "")
        return None
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def native_available() -> bool:
    return build_native() is not None
