"""The versioned npz container of a completion index, shared with the JAX
package.

``save_index(index, path)`` writes every host array of the built
structures (dict trie, rule trie, sorted strings, scores, rules) and a JSON
``__meta__`` (format version, IndexSpec, epoch, EngineConfig, BuildStats,
trie scalars) into one compressed ``.npz``: format 4, with the array names
and metadata keys ``repro``'s ``save_index`` writes, so either package
loads what the other saved.  ``load_index(path, device=None)`` reads such
a container into the port's host structures and :class:`EngineConfig` and
puts the index on the device with its node ids intact.

Formats 1-4 load, with or without a per-node top-K cache.  Older
containers have their rule planes and tile layout rebuilt here.  A format
4 packed container holds only the compressed side tables (u8/u16/i32
tiers, carried over unchanged), the link store and the rule trie; a
pre-v4 container whose spec asks for compression is packed here.
``branch_width`` and the plane and tile widths are recomputed from the
structures where they are there, and come from the saved config where a
packed container elides them.

The substrate is a property of the host that loads: each package resolves
the saved spec's substrate against its own registry, so the port writes
its ``"torch"`` / ``"cuda"`` as ``"auto"`` (which ``repro`` resolves) and
reads ``repro``'s ``"jnp"`` / ``"pallas"`` as ``"auto"``.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from repro_torch.api.spec import IndexSpec
from repro_torch.core import trie_build as tb
from repro_torch.core.engine.structs import EngineConfig
from repro_torch.core.engine.substrate import (available_substrates,
                                               resolve_substrate)

FORMAT_VERSION = 4
_SUPPORTED_VERSIONS = (1, 2, 3, 4)
_META_KEY = "__meta__"


def _pack_bytes(items: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    blob = np.frombuffer(b"".join(items), dtype=np.uint8)
    offsets = np.zeros(len(items) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in items], out=offsets[1:])
    return blob, offsets


def _unpack_bytes(blob: np.ndarray, offsets: np.ndarray) -> list[bytes]:
    raw = blob.tobytes()
    return [raw[offsets[i]:offsets[i + 1]] for i in range(len(offsets) - 1)]


def save_index(index, path: str) -> None:
    """Serialize a built CompletionIndex to ``path`` (.npz appended by numpy
    if missing)."""
    if index.stats is None:
        raise ValueError(
            "the index carries no BuildStats (from_parts without stats=); "
            "pass stats= to from_parts to save it")
    trie: tb.DictTrie = index.trie
    rule_trie: tb.RuleTrie = index.rule_trie
    arrays: dict[str, np.ndarray] = {}
    # a packed index keeps only the compressed side tables and the link
    # store: the container shrinks with the device footprint
    packed_keep = (set(tb.PACKED_ONLY_FIELDS) | set(tb.PACKED_KEEP_FIELDS)
                   if trie.has_packed else None)
    for f in dataclasses.fields(trie):
        v = getattr(trie, f.name)
        if isinstance(v, np.ndarray) and \
                (packed_keep is None or f.name in packed_keep):
            arrays[f"trie__{f.name}"] = v
    for f in dataclasses.fields(rule_trie):
        v = getattr(rule_trie, f.name)
        if isinstance(v, np.ndarray):
            arrays[f"rule_trie__{f.name}"] = v
    (arrays["strings__blob"], arrays["strings__offsets"]) = _pack_bytes(
        index.strings)
    arrays["scores"] = np.asarray(index.scores, dtype=np.int32)
    (arrays["rules__lhs_blob"], arrays["rules__lhs_offsets"]) = _pack_bytes(
        [r.lhs for r in index.rules])
    (arrays["rules__rhs_blob"], arrays["rules__rhs_offsets"]) = _pack_bytes(
        [r.rhs for r in index.rules])

    spec = index.spec.to_dict()
    if spec["substrate"] in available_substrates():
        spec["substrate"] = "auto"
    meta = {
        "format_version": FORMAT_VERSION,
        "spec": spec,
        # a restarting service resumes epoch numbering
        "epoch": index.epoch,
        "cfg": dataclasses.asdict(index.cfg),
        "stats": dataclasses.asdict(index.stats),
        "trie_scalars": {"max_depth": trie.max_depth,
                         "max_syn_targets": trie.max_syn_targets,
                         "walk_tile": trie.walk_tile,
                         "emit_tile": trie.emit_tile,
                         "link_tile": trie.link_tile,
                         "has_cache": trie.topk_score is not None
                         or trie.pc_score is not None},
        "rule_trie_scalars": {
            "max_lhs_len": rule_trie.max_lhs_len,
            "max_matches_per_pos": rule_trie.max_matches_per_pos,
            "max_terms_per_node": rule_trie.max_terms_per_node,
        },
    }
    arrays[_META_KEY] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def engine_config(cfg, trie: tb.DictTrie, rule_trie: tb.RuleTrie,
                  substrate: str, device) -> EngineConfig:
    """The port's EngineConfig from a saved or foreign config (a dict or a
    dataclass with the JAX package's field names), with ``branch_width``
    and the plane and tile widths recomputed from the structures."""
    if dataclasses.is_dataclass(cfg):
        cfg = dataclasses.asdict(cfg)
    known = {f.name for f in dataclasses.fields(EngineConfig)}
    kw = {k: v for k, v in cfg.items() if k in known}
    # a JSON round trip turns the (name, dtype) pairs into lists
    kw["table_widths"] = tuple((str(n), str(d))
                               for n, d in kw.get("table_widths", ()))
    kw.update(substrate=resolve_substrate(substrate, device),
              term_width=rule_trie.term_plane.shape[1])
    if trie.first_child is not None:
        bw = int(np.diff(trie.first_child).max(initial=0))
    else:
        # packed container without the dense CSR: branch rows carry every
        # fanout >= 2 node; any DICT_UNARY flag means fanout 1 exists
        bw = int(np.diff(trie.b_ptr.astype(np.int64)).max(initial=0))
        if (trie.p_flags & tb.PACK_DICT_UNARY).any():
            bw = max(bw, 1)
    kw["branch_width"] = max(bw, 1)
    if trie.tele_plane is not None:
        kw.update(tele_width=trie.tele_plane.shape[1],
                  walk_tile=trie.walk_tile, emit_tile=trie.emit_tile,
                  link_tile=trie.link_tile)
    return EngineConfig(**kw)


def load_index_parts(path: str, device) -> dict:
    """Read the container into constructor-ready parts."""
    from repro_torch.api.build import BuildStats, validate_rule_planes

    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path = path + ".npz"   # np.savez appended the suffix on save
    with np.load(path) as z:
        if _META_KEY not in z:
            raise ValueError(f"{path}: not a completion-index container")
        meta = json.loads(z[_META_KEY].tobytes().decode())
        version = meta.get("format_version")
        if version not in _SUPPORTED_VERSIONS:
            raise ValueError(
                f"{path}: unsupported index format version {version!r} "
                f"(this build reads versions {_SUPPORTED_VERSIONS})")

        def group(prefix: str) -> dict[str, np.ndarray]:
            return {k[len(prefix):]: z[k] for k in z.files
                    if k.startswith(prefix)}

        trie_arrays = group("trie__")
        rt_arrays = group("rule_trie__")
        ts = meta["trie_scalars"]
        if not ts["has_cache"]:
            trie_arrays.pop("topk_score", None)
            trie_arrays.pop("topk_sid", None)
        trie = tb.DictTrie(**trie_arrays,
                           max_depth=ts["max_depth"],
                           max_syn_targets=ts["max_syn_targets"],
                           walk_tile=ts.get("walk_tile", 0),
                           emit_tile=ts.get("emit_tile", 0),
                           link_tile=ts.get("link_tile", 0))
        rule_trie = tb.RuleTrie(**rt_arrays, **meta["rule_trie_scalars"])
        if version < 2:   # pre-rule-plane container: rebuild from the CSRs
            tb.pack_rule_planes(trie, rule_trie)
        if version < 3:   # pre-stream-layout container: re-pack the tiles
            tb.pack_stream_tiles(trie, rule_trie)
        # a pre-v4 container whose spec asks for compression is packed here;
        # the dtype tiers computed now replace what its metadata carried
        repacked_widths = None
        if meta["spec"].get("compression", "none") == "packed" \
                and not trie.has_packed:
            repacked_widths = tb.pack_compressed(trie)
        strings = _unpack_bytes(z["strings__blob"], z["strings__offsets"])
        scores = z["scores"]
        rules = [tb.SynonymRule(lhs, rhs) for lhs, rhs in zip(
            _unpack_bytes(z["rules__lhs_blob"], z["rules__lhs_offsets"]),
            _unpack_bytes(z["rules__rhs_blob"], z["rules__rhs_offsets"]))]

    # the substrate is a property of the host that loads, not of the one
    # that saved: the JAX package's names ("jnp", "pallas") become "auto"
    spec_d = dict(meta["spec"])
    if spec_d.get("substrate") not in available_substrates():
        spec_d["substrate"] = "auto"
    spec = IndexSpec.from_dict(spec_d)
    cfg = engine_config(meta["cfg"], trie, rule_trie, spec.substrate, device)
    if repacked_widths is not None:
        cfg = dataclasses.replace(
            cfg, compression="packed",
            table_widths=tuple(sorted(repacked_widths.items())))
    validate_rule_planes(trie, rule_trie, cfg)
    known = {f.name for f in dataclasses.fields(BuildStats)}
    return {
        "spec": spec,
        "trie": trie,
        "rule_trie": rule_trie,
        "rules": rules,
        "strings": strings,
        "scores": scores,
        "cfg": cfg,
        "stats": BuildStats(**{k: v for k, v in meta["stats"].items()
                               if k in known}),
        "epoch": int(meta.get("epoch", 0)),   # pre-mutation containers: 0
    }


def load_index(path: str, device=None):
    """Load a container saved by either package onto ``device`` (CUDA
    unless the caller passes another)."""
    from repro_torch.api.index import CompletionIndex

    return CompletionIndex.load(path, device=device)
