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

The fixture below contains a second fault of the same kind. The JAX
tests keep a persistent compilation cache in ``/tmp/desamba_jax_cache``
(``tests/conftest.py``), and ``tools/multihost_worker.py`` uses the same
directory. In a multi-process run jaxlib writes cache entries from process
0 only (``jax/_src/compiler.py``: "Not writing persistent cache entry since
process_id != 0"). So after a first run of ``tests/test_multihost.py``,
worker 0 loads its programs from the cache while worker 1 compiles them
anew every time, reaches the final allgather more than 30 s after worker 0
(the gloo key exchange's timeout, fixed inside jaxlib), and the test fails
on every later run over the same ``/tmp``. With the cache switched off in
the processes that tests start, both workers compile, as on a first run,
and arrive together. The fixture runs at the first test of each process
that runs tests, so the test processes themselves have imported jax by then
(``tests/conftest.py``'s ``pytest_configure``) and keep their cache, and
the pytest-xdist controller does not hand the setting to its workers.

A third fault is at the end of a run. When every worker has reported its
session finished, the controller closes their gateways, and execnet sends a
worker SIGINT if it is still running 5 s later (execnet's
``_terminate_execution``). After that report a worker still runs pytest's
cleanup, which calls ``gc.collect()`` five times (the unraisable-exception
plugin); each walks every live object and runs JAX's ``_xla_gc_callback``,
and a worker that has run many of these files holds millions of objects
(1-3 s for the five on a worker of only three files). The SIGINT then lands
inside a collection ("Exception ignored in: <function _xla_gc_callback>
... KeyboardInterrupt") or in the cleanup itself, whose traceback ends the
worker. ``pytest_sessionfinish`` below runs before the report: it collects
once and freezes what survives (``gc.freeze``), so the cleanup's
collections skip the frozen objects and end within the window.
"""
import fcntl
import gc
import os
import tempfile

import pytest


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


@pytest.fixture(scope="session", autouse=True)
def no_persistent_jax_cache_in_started_processes():
    os.environ["JAX_ENABLE_COMPILATION_CACHE"] = "false"
    yield


def pytest_sessionfinish(session):
    """Collect once and freeze the survivors before an xdist worker reports
    its session finished (the module docstring): the collections of
    pytest's cleanup then skip them."""
    gc.collect()
    gc.freeze()
