"""Build the native C runtime once, before any test module is collected.

``desamba_tpu/io/native.py`` compiles ``csrc/*.c`` into one fixed
``<tmp>/libdesnative_<tag>.so.tmp`` and renames it into place, and its
``available()`` turns any exception into "unavailable". On a cold temp
directory the test workers (pytest-xdist) import the modules that need the
library at the same moment, race on that one file, and the losers skip
their tests ("native library unavailable"). Here every process takes an
``fcntl`` lock and loads the library under it: the first one builds it, the
rest find it built. The port's own library (``desamba_tpu_torch/io``) is
built the same way, so that the workers do not all compile it at once.
"""
import fcntl
import os
import tempfile


def pytest_configure(config):
    lock = os.path.join(tempfile.gettempdir(), "desamba_native_build.lock")
    with open(lock, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            from desamba_tpu.io import native
            from desamba_tpu_torch.io import native as port_native

            native.available()
            try:
                port_native.available()
            except (RuntimeError, OSError):
                pass    # the port's tests raise it again where they need it
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)
