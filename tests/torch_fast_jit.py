"""A module-scoped fixture that compiles the JAX package's index entry
points with XLA's cheapest optimization.

The port's tests hold it against ``repro``, whose indexes (``complete``,
sessions, the scheduler's slabs, the sharded local mode) each ``jax.jit``
a program per config on first use, and keep it in the index's own compile
cache.  XLA's default optimization spends most of those seconds on
programs that then run once or twice on a few queries; level 0 without
LLVM's expensive passes compiles them in about half the time, and their
answers (integer scores, ids and flags) do not depend on it.

Only the ``jax`` that ``repro.api.index`` and ``repro.core.distributed``
see is replaced, by one whose ``jit`` passes :data:`FAST`: those modules
make their programs when called and keep them on the index.  ``jax.jit``
itself is not touched, so no module-level ``jit`` (a kernel's decorator,
bound when its module is first imported) takes the options, which a
``jit`` nested in another refuses.  A test module opts in with
``from torch_fast_jit import fast_jax_jit  # noqa: F401``; the modules'
``jax`` is restored after it.
"""

import jax
import pytest

import repro.api.index
import repro.core.distributed

FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}


def fast_jit(fun=None, **kw):
    """``jax.jit`` with :data:`FAST` (also as ``@jax.jit(...)``), for a
    top-level program."""
    kw.setdefault("compiler_options", FAST)
    if fun is None:
        return lambda f: jax.jit(f, **kw)
    return jax.jit(fun, **kw)


class _JaxWithFastJit:
    """``jax`` with :func:`fast_jit` as its ``jit``."""

    jit = staticmethod(fast_jit)

    def __getattr__(self, name):
        return getattr(jax, name)


@pytest.fixture(autouse=True, scope="module")
def fast_jax_jit():
    with pytest.MonkeyPatch.context() as mp:
        for mod in (repro.api.index, repro.core.distributed):
            mp.setattr(mod, "jax", _JaxWithFastJit())
        yield
