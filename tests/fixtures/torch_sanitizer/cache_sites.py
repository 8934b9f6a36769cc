"""Planted KEY001: compile-cache keys that miss config fields read on a
cached path; and keys that hold the whole config (clean)."""


def walk(t, cfg, qs):
    # a cached path reads these fields
    return t.first_child[: cfg.frontier], cfg.gens, cfg.edit_budget


class Index:
    def _fn(self, B, k):
        key = ("batch", B, k, self.cfg.frontier)  # PLANT: KEY001

        def factory():
            return lambda qs: walk(self.tensors, self.cfg, qs)

        return self._compile_cache.get(key, factory)

    def _session_fns(self, k):
        key = ("session", k, self.cfg)

        def factory():
            return walk

        return self._compile_cache.get(key, factory)

    def _local_fn(self, B, L, k):
        return self._local_cache.get((B, L, k, self.cfg), lambda: walk)

    def _slab_fn(self, block):
        return self._local_cache.get(  # a key of shapes alone
            ("slab", block), lambda: walk)  # PLANT: KEY001
