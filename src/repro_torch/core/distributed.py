"""Sharded completion index: the dictionary split across shards.

Strings are hash-partitioned into shards; each shard is an independent
TT/ET/HT over its subset with the (small) rule set replicated.  A query
batch is answered by every shard, the per-shard sids are rebased to
global ids (``sid + shard * stride``), and one top-k merge over the
``[S, B, k]`` answers gives the global top-k.

The cross-shard merge routes through ``Substrate.topk_with_payload``
(:func:`merge_shard_topk`), so on the ``"cuda"`` substrate the
``[B, S*k]`` reduction is the ``topk_select`` kernel; score ties go to
the lower shard, then the lower per-shard rank.  Two execution paths
share that merge:

- :meth:`ShardedCompletionIndex._complete_local` (``mesh=None``): one
  process holds every shard stacked on one device (a leading shard
  dimension, each table padded to the widest shard) and answers them one
  after another with the merged config;
- :func:`sharded_complete` (``mesh=`` a ``torch.distributed`` DeviceMesh):
  each rank holds its own shard on its own device; the query batch is
  split over the data axes, each rank answers from its shard, and the
  answers are all-gathered over the model axis, merged, and all-gathered
  over the data axes so every rank returns the global ``[B, k]``.

As in the JAX package, a shard answers with the merged config and is not
retried wider: an inexact shard answer (an overflowed frontier or a beam
cut short) is returned as it is and counted in
:attr:`ShardedCompletionIndex.inexact`.  Two faults of the JAX package's
sharded mode are repaired here: queries are padded by their UTF-8 bytes
(not their characters), and a shard that got no string — built, as in
the JAX package, over the placeholder ``""`` with score 1 so the stride
and the containers stay the same — contributes no answer.
"""

from __future__ import annotations

import json
import os
import zlib

import numpy as np
import torch

from repro_torch.api.compile_cache import CompileCache, bucket_size
from repro_torch.api.index import CompletionIndex
from repro_torch.api.spec import IndexSpec
from repro_torch.core.alphabet import pad_queries
from repro_torch.core.engine import substrate as subs
from repro_torch.core.engine.structs import (DeviceTrie, EngineConfig,
                                             resolve_device)

#: the meta.json format of a saved sharded index (the JAX package's)
FORMAT_VERSION = 1


class UnsupportedOnShardedIndex(NotImplementedError):
    """An operation that needs a local :class:`CompletionIndex` was called
    on a :class:`ShardedCompletionIndex` (or a service wrapping one).

    Raised instead of a bare ``NotImplementedError`` so callers can catch
    the *category* — per-keystroke sessions, mutation/compaction — and
    the message always names the local-mode alternative."""


_NO_SESSION = (
    "ShardedCompletionIndex has no per-keystroke session: a resumable "
    "locus frontier would have to live on every shard and merge per "
    "keystroke — use complete() for batch lookups, or a local "
    "CompletionIndex for incremental typing")


def shard_strings(strings, scores, n_shards: int):
    """Hash-partition (deterministic, seed-free) strings into shards:
    ``[(strings, scores)] * n_shards`` by crc32 of the UTF-8 bytes."""
    buckets = [([], []) for _ in range(n_shards)]
    for s, r in zip(strings, scores):
        b = s.encode() if isinstance(s, str) else bytes(s)
        h = zlib.crc32(b) % n_shards
        buckets[h][0].append(s)
        buckets[h][1].append(r)
    return buckets


# ---------------------------------------------------------------------------
# stacking: every shard's tables padded to one shape
# ---------------------------------------------------------------------------

#: flat tables a streamed window may read past a row start: each keeps
#: one merged tile of tail slack (the config field naming the tile)
_TILE_SLACK = {
    "edge_char": "walk_tile", "edge_child": "walk_tile",
    "s_edge_char": "walk_tile", "s_edge_child": "walk_tile",
    "emit_node": "emit_tile", "emit_score": "emit_tile",
    "emit_is_leaf": "emit_tile",
    "link_rule": "link_tile", "link_target": "link_tile",
}


def _shapes(t: DeviceTrie) -> dict:
    return {f: None if x is None else tuple(x.shape)
            for f, x in zip(DeviceTrie._fields, t)}


def target_shapes(shapes: list[dict], cfgs: list[EngineConfig]) -> dict:
    """Per field, the padded shape of one shard's table: the maximum over
    the shards of each dimension (at least 1), plus one merged tile of
    tail slack on every streamable flat table longer than one entry;
    None where a shard has no such table."""
    slack = {f: max(getattr(c, tile) for c in cfgs)
             for f, tile in _TILE_SLACK.items()}
    out = {}
    for f in DeviceTrie._fields:
        per = [sh[f] for sh in shapes]
        if any(p is None for p in per):
            out[f] = None
            continue
        tgt = tuple(max(max(p[i] for p in per), 1)
                    for i in range(len(per[0])))
        if f in slack and tgt[0] > 1:
            tgt = (tgt[0] + slack[f],) + tgt[1:]
        out[f] = tgt
    return out


def _pad_into(dst: torch.Tensor, a: torch.Tensor) -> None:
    """Write ``a`` into the larger ``dst``: bool tables padded with False,
    1-D tables by repeating their last entry (a CSR pointer array gains
    empty rows; data past the real pointers is never addressed), 2-D
    planes with -1 (empty); an empty table counts as one zero."""
    if a.numel() == 0:
        a = torch.zeros((1,) * dst.dim(), dtype=a.dtype, device=a.device)
    if a.dtype == torch.bool:
        dst.fill_(False)
    elif a.dim() == 1:
        dst[a.shape[0]:].copy_(a[-1:].expand(dst.shape[0] - a.shape[0]))
    else:
        dst.fill_(-1)
    dst[tuple(slice(0, n) for n in a.shape)].copy_(a)


def pad_shard(t: DeviceTrie, targets: dict) -> DeviceTrie:
    """One shard's tables padded to ``targets`` (:func:`target_shapes`) on
    their device: equal to that shard's slice of :func:`stack_shards`."""
    out = []
    for f, x in zip(DeviceTrie._fields, t):
        if targets[f] is None:
            out.append(None)
            continue
        dst = torch.empty(targets[f], dtype=x.dtype, device=x.device)
        _pad_into(dst, x)
        out.append(dst)
    return DeviceTrie(*out)


def merged_config(cfgs: list[EngineConfig]) -> EngineConfig:
    """The one config every shard runs with: maxima of the widths, the
    cache only where every shard has one (at the smallest depth), the
    first shard's substrate (shards share one IndexSpec).  The fields the
    JAX package's merge leaves out keep their defaults, so a sharded
    index runs at edit budget 0, as the JAX package's does."""
    return EngineConfig(
        frontier=max(c.frontier for c in cfgs),
        gens=max(c.gens for c in cfgs),
        expand=max(c.expand for c in cfgs),
        max_steps=max(c.max_steps for c in cfgs),
        rule_matches=max(c.rule_matches for c in cfgs),
        max_lhs_len=max(c.max_lhs_len for c in cfgs),
        max_terms_per_node=max(c.max_terms_per_node for c in cfgs),
        teleports=max(c.teleports for c in cfgs),
        tele_width=max(c.tele_width for c in cfgs),
        term_width=max(c.term_width for c in cfgs),
        walk_tile=max(c.walk_tile for c in cfgs),
        emit_tile=max(c.emit_tile for c in cfgs),
        link_tile=max(c.link_tile for c in cfgs),
        memory_budget=max(c.memory_budget for c in cfgs),
        use_cache=all(c.use_cache for c in cfgs),
        cache_k=min(c.cache_k for c in cfgs),
        substrate=cfgs[0].substrate,
    )


def _check_dense(cfgs) -> None:
    if any(c.compression != "none" for c in cfgs):
        raise NotImplementedError(
            "stack_shards does not support the compressed (packed) layout: "
            "padding would break the sorted side-table rank invariants — "
            "build shards with compression='none'")


def stack_shards(indexes: list[CompletionIndex]):
    """Stack the shards' device tables into one :class:`DeviceTrie` with a
    leading shard dimension, on the shards' device (see
    :func:`target_shapes` and :func:`_pad_into` for the padding).
    Returns (stacked DeviceTrie, merged EngineConfig, stride): the stride
    is the longest shard's string count, the base of the global sids."""
    cfgs = [ix.cfg for ix in indexes]
    _check_dense(cfgs)
    targets = target_shapes([_shapes(ix.tensors) for ix in indexes], cfgs)
    stacked = []
    for i, f in enumerate(DeviceTrie._fields):
        if targets[f] is None:
            stacked.append(None)
            continue
        first = indexes[0].tensors[i]
        out = torch.empty((len(indexes),) + targets[f], dtype=first.dtype,
                          device=first.device)
        for s, ix in enumerate(indexes):
            _pad_into(out[s], ix.tensors[i])
        stacked.append(out)
    stride = max(len(ix.strings) for ix in indexes)
    return DeviceTrie(*stacked), merged_config(cfgs), stride


# ---------------------------------------------------------------------------
# the merge and the mesh path
# ---------------------------------------------------------------------------


def merge_shard_topk(all_scores: torch.Tensor, all_gsids: torch.Tensor,
                     k: int, sub):
    """Fuse per-shard answers [S, B, k] into the global (scores[B, k],
    gsids[B, k]) with one substrate-routed top-k with payload over the
    ``[B, S*k]`` relayout; ties go to the lower shard, then the lower
    per-shard rank."""
    S, B = all_scores.shape[0], all_scores.shape[1]
    flat_s = all_scores.transpose(0, 1).reshape(B, S * k).contiguous()
    flat_i = all_gsids.transpose(0, 1).reshape(B, S * k).contiguous()
    return sub.topk_with_payload(flat_s, flat_i, k)


def _rebase(sids: torch.Tensor, shard: int, stride: int) -> torch.Tensor:
    """Global sids (int32; -1 stays the empty slot)."""
    return torch.where(sids >= 0, sids + shard * stride,
                       torch.full_like(sids, -1))


def _all_gather(x: torch.Tensor, group) -> list[torch.Tensor]:
    import torch.distributed as dist

    parts = [torch.empty_like(x)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


def _mesh_axes(mesh, model_axis: str, data_axes) -> dict:
    """Sizes of the named mesh dimensions; unknown names raise."""
    sizes = dict(zip(mesh.mesh_dim_names or (), mesh.mesh.shape))
    for name in (model_axis, *data_axes):
        if name not in sizes:
            raise ValueError(f"mesh has no dimension {name!r}; its "
                             f"dimensions are {tuple(sizes)}")
    return sizes


def _data_coordinate(mesh, data_axes) -> tuple[int, int]:
    """(this rank's flat coordinate over the data axes, their rank
    count), the first axis major."""
    import torch.distributed as dist

    coord, count = 0, 1
    for name in data_axes:
        group = mesh.get_group(name)
        n = dist.get_world_size(group)
        coord = coord * n + dist.get_rank(group)
        count *= n
    return coord, count


def sharded_complete(trie: DeviceTrie, cfg: EngineConfig, qs, qlens, k: int,
                     *, mesh, sid_stride: int, data_axes=("data",),
                     model_axis: str = "model", empty: bool = False,
                     n_real: int | None = None):
    """Global top-k over a DeviceMesh: this rank's shard answers its slice
    of the batch, one all-gather over the model axis and the substrate
    merge give the slice's global top-k, and one all-gather over the data
    axes gives every rank the whole batch's.

    trie: this rank's shard (padded to the shared shapes, on its device);
    qs int32[B, L] / qlens int32[B]: the global batch, the same on every
    rank, with B a multiple of the data ranks, its first ``n_real`` rows
    real (all when None); ``empty``: the shard got no string and answers
    nothing.  Returns (scores[B, k], global_sids[B, k], inexact): the last
    is this rank's count (a 0-d tensor on its device) of its shard's
    answers to real rows that came back inexact (0 for an empty
    shard)."""
    import torch.distributed as dist

    _mesh_axes(mesh, model_axis, data_axes)
    d, n_data = _data_coordinate(mesh, data_axes)
    B = int(qs.shape[0])
    if B % n_data:
        raise ValueError(f"a batch of {B} queries does not split over "
                         f"{n_data} data ranks")
    b = B // n_data
    model = mesh.get_group(model_axis)
    shard = dist.get_rank(model)
    sub = subs.get_substrate(cfg.substrate)
    inexact = torch.zeros((), dtype=torch.int64, device=qs.device)
    if empty:
        scores = torch.full((b, k), -1, dtype=torch.int32, device=qs.device)
        gsids = scores.clone()
    else:
        scores, sids, exact = subs.complete_batch(
            trie, cfg, qs[d * b:(d + 1) * b], qlens[d * b:(d + 1) * b], k,
            sub)
        gsids = _rebase(sids, shard, sid_stride)
        real = B if n_real is None else n_real
        inexact = (~exact[:max(0, min(b, real - d * b))]).sum()
    top_s, top_i = merge_shard_topk(torch.stack(_all_gather(scores, model)),
                                    torch.stack(_all_gather(gsids, model)),
                                    k, sub)
    # the data axes gathered last-first, so the first is the major one
    for name in reversed(tuple(data_axes)):
        group = mesh.get_group(name)
        top_s = torch.cat(_all_gather(top_s, group))
        top_i = torch.cat(_all_gather(top_i, group))
    return top_s, top_i, inexact


def _sum_over_mesh(n: torch.Tensor, mesh, model_axis: str,
                   data_axes) -> int:
    """``n`` (a 0-d tensor on this rank's device) summed over every rank
    of the mesh: over the model group, then over each data axis's
    group."""
    import torch.distributed as dist

    total = n.reshape(1).to(torch.int64)
    for name in (model_axis, *data_axes):
        dist.all_reduce(total, group=mesh.get_group(name))
    return int(total.item())


# ---------------------------------------------------------------------------
# the index
# ---------------------------------------------------------------------------


def _empty_flags(shards, empty) -> list[bool]:
    """Which shards got no string: ``empty`` where the caller knows (a
    build, or a meta.json that records it), else inferred.  An empty
    bucket is built over ``""`` alone with score 1, and a real ``""``
    can only hash to shard 0, so elsewhere such a shard is the
    placeholder."""
    if empty is not None:
        return [bool(e) for e in empty]
    return [s > 0 and ix is not None and list(ix.strings) == [b""]
            and [int(x) for x in ix.scores] == [1]
            for s, ix in enumerate(shards)]


class ShardedCompletionIndex:
    """Host-facing wrapper: build shards, stack them, serve them in one
    process (``n_shards=``) or over a DeviceMesh (``mesh=``).

    Shards share one :class:`IndexSpec`; ``save``/``load`` persist every
    shard's npz container beside a ``meta.json`` (the JAX package's
    layout: either package loads what the other saved), so a serving
    process restarts without rebuilding any sub-trie.

    Over a mesh every rank of the default process group constructs the
    index with the same arguments and calls :meth:`complete` with the
    same queries; each builds or loads its own shard only, on its device
    (the current CUDA device on a CUDA mesh).  ``shards[i]`` is ``None``
    for the shards other ranks hold; :attr:`shard_strings` has them all.
    """

    def __init__(self, strings, scores, rules, *, mesh=None, n_shards=None,
                 kind=None, model_axis="model", data_axes=("data",),
                 spec=None, device=None, **build_kwargs):
        from repro_torch.api.build import build_index

        if spec is None:
            spec = IndexSpec(kind=kind or "et", **build_kwargs)
        elif kind is not None or build_kwargs:
            raise TypeError("pass either spec= or IndexSpec kwargs, not both")
        spec.validate_sharded()   # before any shard is built, not after
        if mesh is not None:
            mesh_shards = _mesh_axes(mesh, model_axis, data_axes)[model_axis]
            if n_shards is not None and n_shards != mesh_shards:
                raise ValueError(
                    f"n_shards={n_shards} but mesh axis {model_axis!r} has "
                    f"{mesh_shards} devices")
            n_shards = mesh_shards
            device = _mesh_device(mesh, device)
        elif n_shards is None:
            raise TypeError(
                "pass mesh= (device-sharded serving) or n_shards= "
                "(single-process local mode)")
        else:
            device = resolve_device(device)
        buckets = shard_strings(strings, scores, n_shards)
        own = (range(n_shards) if mesh is None
               else [_model_rank(mesh, model_axis)])

        def build(b):
            return build_index(b[0] or [""], b[1] or [1], rules, spec=spec,
                               device=device)

        shards = [build(buckets[s]) if s in own else None
                  for s in range(n_shards)]
        self._init_from_shards(shards, mesh=mesh, model_axis=model_axis,
                               data_axes=data_axes, spec=spec,
                               empty=[not b[0] for b in buckets])

    def _init_from_shards(self, shards, *, mesh, model_axis, data_axes,
                          spec, empty=None):
        self.mesh = mesh
        self.model_axis = model_axis
        self.data_axes = tuple(data_axes)
        # fail unsupported-on-sharded spec combinations (packed layout)
        # here, with the workaround in the message, instead of deep in
        # stack_shards — every construction path funnels through this
        self.spec = spec.validate_sharded()
        self.shards = list(shards)
        #: shard answers returned inexact (no widened retry), summed over
        #: every lookup since the index was made (over a mesh, summed over
        #: every rank, so each rank reports the whole mesh's count)
        self.inexact = 0
        #: the local mode's prepared batch entry points, by (B, L, k, cfg)
        self._local_cache = CompileCache(maxsize=16)
        if mesh is None:
            devices = {ix.device for ix in self.shards}
            if len(devices) != 1:
                raise ValueError(f"shards on several devices: {devices}")
            self.device = self.shards[0].device
            self.empty = _empty_flags(self.shards, empty)
            self.tensors, self.cfg, self.stride = stack_shards(self.shards)
            # one view of the stacked tables per shard, made once: the
            # kernels cache their table checks by the tensors' identity
            self.shard_tries = [
                DeviceTrie(*(None if x is None else x[s]
                             for x in self.tensors))
                for s in range(len(self.shards))]
            self.shard_strings = [ix.strings for ix in self.shards]
        else:
            self._init_mesh(empty)

    def _init_mesh(self, empty) -> None:
        """Exchange every rank's shard shapes, config, strings and empty
        flag in one all_gather_object, then pad this rank's shard to the
        shapes every rank agrees on."""
        import torch.distributed as dist

        n_shards = _mesh_axes(self.mesh, self.model_axis,
                              self.data_axes)[self.model_axis]
        s = _model_rank(self.mesh, self.model_axis)
        shards = self.shards
        if len(shards) == 1:            # this rank's shard alone
            shards = [shards[0] if i == s else None for i in range(n_shards)]
        if len(shards) != n_shards:
            raise ValueError(
                f"{len(shards)} shards but mesh axis {self.model_axis!r} "
                f"has {n_shards} devices")
        self.shards = [ix if i == s else None for i, ix in enumerate(shards)]
        own = self.shards[s]
        if own is None:
            raise ValueError(f"this rank holds shard {s}, which is missing")
        empty = _empty_flags(self.shards, empty)
        d, _ = _data_coordinate(self.mesh, self.data_axes)
        info = [None] * dist.get_world_size()
        dist.all_gather_object(info, {
            "shard": s, "shapes": _shapes(own.tensors), "cfg": own.cfg,
            "empty": bool(empty[s]),
            "strings": list(own.strings) if d == 0 else None})
        by_shard = {}
        for entry in info:
            if entry["strings"] is not None:
                by_shard.setdefault(entry["shard"], entry)
        per = [by_shard[i] for i in range(n_shards)]
        cfgs = [p["cfg"] for p in per]
        _check_dense(cfgs)
        targets = target_shapes([p["shapes"] for p in per], cfgs)
        self.device = own.device
        self.empty = [p["empty"] for p in per]
        self.cfg = merged_config(cfgs)
        self.shard_strings = [p["strings"] for p in per]
        self.stride = max(len(x) for x in self.shard_strings)
        self.tensors = pad_shard(own.tensors, targets)

    @classmethod
    def from_shards(cls, shards, *, mesh=None, model_axis="model",
                    data_axes=("data",), spec=None):
        """Wrap already-built per-shard indexes (skips construction).
        Over a mesh pass every shard (each rank keeps its own) or this
        rank's alone."""
        self = cls.__new__(cls)
        held = next(ix for ix in shards if ix is not None)
        self._init_from_shards(shards, mesh=mesh, model_axis=model_axis,
                               data_axes=data_axes, spec=spec or held.spec)
        return self

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    # -- persistence -------------------------------------------------------

    def save(self, path: str) -> None:
        """Write a directory: meta.json + one npz container per shard.
        Over a mesh the ranks at data coordinate 0 write their shards and
        rank 0 the meta.json."""
        rank, d = 0, 0
        if self.mesh is not None:
            import torch.distributed as dist

            rank = dist.get_rank()
            d, _ = _data_coordinate(self.mesh, self.data_axes)
        os.makedirs(path, exist_ok=True)
        if d == 0:
            for i, shard in enumerate(self.shards):
                if shard is not None:
                    shard.save(os.path.join(path, f"shard_{i:04d}.npz"))
        if rank == 0:
            spec = self.spec.to_dict()
            if spec["substrate"] in subs.available_substrates():
                spec["substrate"] = "auto"   # the loading host resolves it
            meta = {"format_version": FORMAT_VERSION,
                    "n_shards": self.n_shards, "spec": spec,
                    "empty_shards": [i for i, e in enumerate(self.empty)
                                     if e]}
            with open(os.path.join(path, "meta.json"), "w") as f:
                json.dump(meta, f)
        if self.mesh is not None:
            import torch.distributed as dist

            dist.barrier()

    @classmethod
    def load(cls, path: str, *, mesh=None, model_axis="model",
             data_axes=("data",), device=None) -> "ShardedCompletionIndex":
        """Load a directory saved by either package onto ``device`` (CUDA
        unless the caller passes another; over a mesh, this rank's
        device)."""
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        n_shards = meta["n_shards"]
        own = range(n_shards)
        if mesh is not None:
            mesh_shards = _mesh_axes(mesh, model_axis, data_axes)[model_axis]
            if n_shards != mesh_shards:
                raise ValueError(
                    f"saved index has {n_shards} shards but mesh axis "
                    f"{model_axis!r} has {mesh_shards} devices")
            device = _mesh_device(mesh, device)
            own = [_model_rank(mesh, model_axis)]
        else:
            device = resolve_device(device)
        shards = [CompletionIndex.load(
            os.path.join(path, f"shard_{i:04d}.npz"), device=device)
            if i in own else None for i in range(n_shards)]
        spec_d = dict(meta["spec"])
        if spec_d.get("substrate") not in subs.available_substrates():
            spec_d["substrate"] = "auto"
        empty = None
        if "empty_shards" in meta:
            empty = [i in meta["empty_shards"] for i in range(n_shards)]
        self = cls.__new__(cls)
        self._init_from_shards(shards, mesh=mesh, model_axis=model_axis,
                               data_axes=data_axes,
                               spec=IndexSpec.from_dict(spec_d), empty=empty)
        return self

    # -- lookup ------------------------------------------------------------

    def lookup_string(self, gsid: int) -> str:
        shard, sid = divmod(int(gsid), self.stride)
        return self.shard_strings[shard][sid].decode("utf-8",
                                                     errors="replace")

    def _local_fn(self, B: int, L: int, k: int):
        """The local mode's entry point for one bucketed batch shape:
        (qs, qlens) on the device -> (scores[B, k], gsids[B, k], the
        non-empty shards' exact flags [S', B]): every shard's tables in
        turn with the merged config, the sids rebased, one merge."""
        key = (B, L, k, self.cfg)

        def factory():
            cfg, stride = self.cfg, self.stride
            sub = subs.get_substrate(cfg.substrate)
            tries, empty, device = self.shard_tries, self.empty, self.device

            def run(q, ql):
                per_s, per_i, exact = [], [], []
                for s, t in enumerate(tries):
                    if empty[s]:
                        none = torch.full((B, k), -1, dtype=torch.int32,
                                          device=device)
                        per_s.append(none)
                        per_i.append(none)
                        continue
                    scores, sids, ex = subs.complete_batch(t, cfg, q, ql, k,
                                                           sub)
                    per_s.append(scores)
                    per_i.append(_rebase(sids, s, stride))
                    exact.append(ex)
                top_s, top_i = merge_shard_topk(torch.stack(per_s),
                                                torch.stack(per_i), k, sub)
                return top_s, top_i, exact

            return run

        return self._local_cache.get(key, factory)

    def _complete_local(self, qs, qlens, k: int, n_real: int):
        """Answer a padded query batch without a mesh; the batch is
        bucketed up to a power of two (at least 8) so shapes re-hit the
        cache."""
        B = bucket_size(n_real)
        qs_p = np.zeros((B, qs.shape[1]), np.int32)
        qlens_p = np.zeros((B,), np.int32)
        qs_p[:n_real], qlens_p[:n_real] = qs, qlens
        fn = self._local_fn(B, qs.shape[1], k)
        top_s, top_i, exact = fn(torch.from_numpy(qs_p).to(self.device),
                                 torch.from_numpy(qlens_p).to(self.device))
        if exact:
            self.inexact += int((~torch.stack(exact)[:, :n_real]).sum())
        return top_s[:n_real], top_i[:n_real]

    def _complete_mesh(self, qs, qlens, k: int, n_real: int):
        _, n_data = _data_coordinate(self.mesh, self.data_axes)
        B = -(-bucket_size(n_real) // n_data) * n_data
        qs_p = np.zeros((B, qs.shape[1]), np.int32)
        qlens_p = np.zeros((B,), np.int32)
        qs_p[:n_real], qlens_p[:n_real] = qs, qlens
        scores, gsids, inexact = sharded_complete(
            self.tensors, self.cfg, torch.from_numpy(qs_p).to(self.device),
            torch.from_numpy(qlens_p).to(self.device), k, mesh=self.mesh,
            sid_stride=self.stride, data_axes=self.data_axes,
            model_axis=self.model_axis,
            empty=self.empty[_model_rank(self.mesh, self.model_axis)],
            n_real=n_real)
        self.inexact += _sum_over_mesh(inexact, self.mesh, self.model_axis,
                                       self.data_axes)
        return scores[:n_real], gsids[:n_real]

    def complete(self, queries, k: int = 10):
        """Top-k (score, string) pairs per query.  Queries are padded by
        their UTF-8 bytes to ``max(8, the next power of two)``."""
        max_len = max((len(q.encode() if isinstance(q, str) else q)
                       for q in queries), default=1)
        L = max(8, 1 << (max_len - 1).bit_length())
        qs, qlens = pad_queries(queries, L)
        run = self._complete_local if self.mesh is None \
            else self._complete_mesh
        scores, gsids = run(qs, qlens, k, len(queries))
        scores, gsids = scores.cpu().tolist(), gsids.cpu().tolist()
        return [[(s, self.lookup_string(g)) for s, g in zip(srow, grow)
                 if s >= 0 and g >= 0]
                for srow, grow in zip(scores, gsids)]

    def session(self, k: int = 10):
        raise UnsupportedOnShardedIndex(_NO_SESSION)

    def open_session(self, k: int = 10):
        raise UnsupportedOnShardedIndex(_NO_SESSION)


def _model_rank(mesh, model_axis: str) -> int:
    """This rank's shard: its rank in the mesh's model-axis group (the
    order the model all-gather returns the shards in)."""
    import torch.distributed as dist

    return dist.get_rank(mesh.get_group(model_axis))


def _mesh_device(mesh, device) -> torch.device:
    """This rank's device on ``mesh``: the current CUDA device on a CUDA
    mesh unless the caller names one."""
    if device is not None:
        return resolve_device(device)
    if mesh.device_type == "cuda":
        return resolve_device(torch.device("cuda",
                                           torch.cuda.current_device()))
    return torch.device(mesh.device_type)
