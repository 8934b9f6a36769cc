"""Planted SHM001 and SHM002: shared-memory byte counts made outside the
launch plans, and launch plans that do not check them against the
limit; beside launches and plans that do it right (clean)."""

from types import SimpleNamespace

MAX_SHARED_BYTES = 232_448


def _lib():
    return lambda *args: 0


def launch_shape(cfg, k):
    """Clean: checked before the return."""
    shared = 8 * (cfg.gens + k)
    if shared > MAX_SHARED_BYTES:
        raise ValueError("too much shared memory")
    return SimpleNamespace(threads=32, shared=shared)


def launch_plan(F, K):
    """SHM002 on the path that skips the check."""
    if F * K <= 1024:
        shared = 8 * F
        return 32, shared  # PLANT: SHM002
    shared = 4 * F * K
    if shared > MAX_SHARED_BYTES:
        raise ValueError("too much shared memory")
    return 256, shared


def launch_plan_unchecked(F):
    return F


def launch_clean(cfg, loci, k):
    ls = launch_shape(cfg, k)
    threads, shared = launch_plan(loci.shape[1], k)
    _lib()(loci, ls.threads, ls.shared)
    return _lib()(loci, threads, shared)


def launch_own_count(cfg, loci, k):
    ls = launch_shape(cfg, k)
    shared_bytes = 4 * loci.shape[1]
    return _lib()(loci, ls.threads,
                  shared_bytes)  # PLANT: SHM001


def launch_keyword(loci):
    return _lib()(loci, smem=1024)


def launch_keyword_name(loci, smem):
    return _lib()(loci, smem=smem)  # PLANT: SHM001
