#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py            # from the repository root

Phases, each of which fails the run (non-zero exit) when it fails:

1. print the card (``nvidia-smi``), the torch and CUDA versions, and build
   the hand-written kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all at once);
2. build the indexes.  USPS ET at 1,000,000 strings (the paper's size,
   seed 0) is built once; its cached (``cache_k=16``) and packed
   (``compression="packed"``) variants are derived from the same host trie
   by the build's own later steps (the top-K cache, then the compressed
   layout), so the 1M host build is paid once;
3. hold each kernel against its plain PyTorch version on the card,
   element for element, at the main path's shapes (B=64, L bucket 32,
   k=10) with the default widths, the first retry round's and the widest:
   the dense and the packed locus DP and beam on DBLP TT, DBLP HT (24,810
   strings) and USPS ET 1M; ``trie_walk``; ``locus_topk_merge`` on the
   dense and the packed K=16 cache, ``k >= F*K`` included; ``topk_select``
   at the rule-free cached route's shape (C=K=16, k=10) and on [64, 512]
   rows with seeded ties;
4. drive the main path through ``CompletionService.complete`` with the
   launcher's batch workload (512 queries of ``make_workload(seed=1)``,
   batch 64, k=10, one warm-up batch) on: USPS ET 1M dense (beam), USPS
   plain 100k dense (beam), USPS ET 1M packed (beam), USPS ET 1M packed
   with ``cache_k=16``, USPS ET 1M dense with ``cache_k=16`` and USPS
   plain 100k with ``cache_k=16``.  Every kernel of a path must launch in
   it, no plain version may run, the answers must equal the ``"torch"``
   substrate's on the same index, and each packed index's answers must
   equal the dense index's of the same cache depth (node ids are shared,
   so the layouts agree bit for bit);
5. time each kernel against its plain version, its bound and (where one
   exists) a PyTorch library call at the main path's shapes; print one
   JSON line of kernels, the card, and, last, the device line.

``--small`` runs every phase on small corpora (a quick compile-and-check).
Without a CUDA device the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the card's published peaks (H100 SXM data sheet): HBM bandwidth and the
# float32 rate outside the tensor cores, against which the kernels' int32
# compares are counted
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

B, L_BUCKET, K, CACHE_K = 64, 32, 10, 16
RETRY = dict(frontier=64, gens=192, max_steps=2048)     # first retry round
WIDEST = dict(frontier=256, gens=3072, max_steps=32768)  # third retry round
PAPER_B_PER_STRING = (160, 200)   # the paper's space claim


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls (after one warm-up),
    by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


#: per kernel, the largest |kernel - plain| seen in the parity phase
MAX_ABS_ERR: dict[str, int] = {}


def check_equal(name: str, what: str, got, want) -> None:
    """Outputs are integers (and flags): the tolerance is exact equality."""
    import torch

    err = max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
              for g, w in zip(got, want))
    MAX_ABS_ERR[name] = max(MAX_ABS_ERR.get(name, 0), err)
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            bad = (g != w).nonzero()[:5].tolist()
            raise AssertionError(f"{name} {what}: kernel and plain version "
                                 f"differ at {bad}")
    log(f"  {name} {what}: equal")


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_bytes(idx) -> int:
    """Bytes of every tensor the index holds on the card."""
    return sum(t.numel() * t.element_size() for t in idx.tensors
               if t is not None)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="small corpora: a quick compile-and-check run")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from dataclasses import replace

    import repro_torch as rt
    from repro_torch.core import trie_build as tb
    from repro_torch.core.alphabet import pad_queries
    from repro_torch.core.engine import beam, cached, locus
    from repro_torch.core.trie_build import make_rules
    from repro_torch.data.strings import make_dblp, make_usps, make_workload
    from repro_torch.kernels import (_build, beam_topk, locus_dp,
                                     locus_merge, topk_select, trie_walk)

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = nvidia_smi()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, python {sys.version.split()[0]}")

    # -- phase 1: build the kernels -------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    for name in _build.SOURCES:
        _build.library(name)
    log(f"kernel build: {time.perf_counter() - t0:.3f} s wall "
        f"(nvcc {_build.build_seconds} s)")
    for name, text in _build.ptxas_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # -- phase 2: the indexes -------------------------------------------------------
    n_dblp, n_usps_plain, n_usps_et = ((2_000, 5_000, 20_000) if args.small
                                       else (24_810, 100_000, 1_000_000))
    builds = {}

    def build(name, ds, kind):
        t = time.perf_counter()
        rules = make_rules(ds.rules) if kind != "plain" else []
        idx = rt.build_index(ds.strings, ds.scores, rules,
                             rt.IndexSpec(kind=kind), device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        log(f"build {name} {kind} ({len(ds.strings)} strings): {secs:.3f} s, "
            f"{idx.stats.n_nodes} nodes, {idx.stats.bytes_per_string:.1f} "
            f"B/string, rule_matches={idx.cfg.rule_matches}, "
            f"teleports={idx.cfg.teleports}")
        builds[name, kind] = secs
        return idx

    def cached_trie(idx):
        """The index's host trie with the per-node top-K cache added (the
        build's step after the rule side; the dense arrays are shared)."""
        t = time.perf_counter()
        trie = dataclasses.replace(idx.trie)
        tb.build_topk_cache(trie, CACHE_K)
        builds["top-K cache", len(idx.strings)] = time.perf_counter() - t
        return trie

    def derive(name, idx, trie, compression):
        """An index over ``trie`` (the host trie of ``idx``, cached or not)
        in the given layout: the build's last step (pack_compressed) on a
        copy, then the public ``CompletionIndex.from_parts``."""
        t = time.perf_counter()
        trie = dataclasses.replace(trie)
        widths = tb.pack_compressed(trie) if compression == "packed" else {}
        cache_k = CACHE_K if trie.topk_score is not None else 0
        cfg = replace(idx.cfg, use_cache=cache_k > 0, cache_k=cache_k,
                      compression=compression,
                      table_widths=tuple(sorted(widths.items())))
        out = rt.CompletionIndex.from_parts(
            trie, idx.rule_trie, idx.rules, idx.strings, idx.scores, cfg,
            device=dev, spec=idx.spec.replace(cache_k=cache_k,
                                              compression=compression))
        torch.cuda.synchronize()
        builds[name] = time.perf_counter() - t
        n = len(out.strings)
        host = (trie.packed_nbytes() + idx.rule_trie.nbytes()
                if compression == "packed" else None)
        log(f"derive {name}: {builds[name]:.3f} s, device tensors "
            f"{device_bytes(out)} B = {device_bytes(out) / n:.1f} B/string"
            + (f", packed layout + rule trie {host / n:.1f} B/string "
               f"(tiers {dict(out.cfg.table_widths)})" if host else ""))
        return out

    dblp = make_dblp(n_dblp, seed=0)
    usps_small = make_usps(n_usps_plain, seed=0)
    t = time.perf_counter()
    usps = make_usps(n_usps_et, seed=0)
    log(f"make_usps({n_usps_et}): {time.perf_counter() - t:.3f} s")
    dblp_tt = build("DBLP", dblp, "tt")
    dblp_ht = build("DBLP", dblp, "ht")
    usps_plain = build("USPS", usps_small, "plain")
    usps_et = build("USPS", usps, "et")
    dblp_tt_p = derive("DBLP TT packed", dblp_tt, dblp_tt.trie, "packed")
    dblp_ht_p = derive("DBLP HT packed", dblp_ht, dblp_ht.trie, "packed")
    usps_et_p = derive("USPS ET packed", usps_et, usps_et.trie, "packed")
    et_cached = cached_trie(usps_et)
    usps_et_pc = derive("USPS ET packed cache_k=16", usps_et, et_cached,
                        "packed")
    usps_et_c = derive("USPS ET cache_k=16", usps_et, et_cached, "none")
    usps_plain_c = derive("USPS plain cache_k=16", usps_plain,
                          cached_trie(usps_plain), "none")
    del et_cached

    def batch(ds, seed, n=B):
        qs, ql = pad_queries(make_workload(ds, n, seed=seed), L_BUCKET)
        return (torch.from_numpy(qs).to(dev), torch.from_numpy(ql).to(dev))

    # -- phase 3: each kernel against its plain version -------------------------
    log("kernel parity (kernel vs plain version on the card):")
    loci_sets = {}
    for name, idx, ds in (("DBLP TT", dblp_tt, dblp),
                          ("DBLP HT", dblp_ht, dblp),
                          ("USPS ET", usps_et, usps),
                          ("DBLP TT packed", dblp_tt_p, dblp),
                          ("DBLP HT packed", dblp_ht_p, dblp),
                          ("USPS ET packed", usps_et_p, usps)):
        kern = "locus_dp_packed" if "packed" in name else "locus_dp"
        q, ql = batch(ds, seed=1)
        for label, widths in (("default", {}), ("retry", RETRY)):
            cfg = replace(idx.cfg, **widths)
            got = locus_dp.locus_dp_walk(idx.tensors, cfg, q, ql)
            want = locus_dp.locus_dp_plain(idx.tensors, cfg, q, ql)
            check_equal(kern, f"{name} {label} F={cfg.frontier}", got, want)
            loci_sets[name, label] = (idx, cfg, got[0])
    for layout in ("DBLP TT", "DBLP HT", "USPS ET"):
        for label in ("default", "retry"):
            a, b = (loci_sets[layout, label][2],
                    loci_sets[layout + " packed", label][2])
            if not torch.equal(a, b):
                raise AssertionError(f"{layout} {label}: packed and dense "
                                     "loci differ")
    log("  dense and packed loci equal on DBLP TT, DBLP HT and USPS ET")
    q, ql = batch(usps_small, seed=1)
    tp = usps_plain.tensors
    got = trie_walk.trie_walk(tp.first_child, tp.edge_char, tp.edge_child,
                              q, ql)
    want = trie_walk.trie_walk_plain(tp.first_child, tp.edge_char,
                                     tp.edge_child, q, ql)
    check_equal("trie_walk", "USPS plain", got, want)
    for (name, label), (idx, cfg, loci) in loci_sets.items():
        kern = "beam_topk_packed" if "packed" in name else "beam_topk"
        got = beam_topk.beam_topk_batch(idx.tensors, cfg, loci, K)
        want = beam_topk.beam_topk_plain(idx.tensors, cfg, loci, K)
        check_equal(kern, f"{name} {label} W={cfg.gens} exact="
                    f"{int(got[2].sum())}/{B}", got, want)
    # the widest retry round the default spec can reach, on a few queries
    q, ql = batch(usps, seed=2)
    for name, idx in (("USPS ET", usps_et), ("USPS ET packed", usps_et_p)):
        sfx = "_packed" if "packed" in name else ""
        cfg = replace(idx.cfg, **WIDEST)
        got = locus_dp.locus_dp_walk(idx.tensors, cfg, q[:8], ql[:8])
        check_equal("locus_dp" + sfx, f"{name} widest F=256", got,
                    locus_dp.locus_dp_plain(idx.tensors, cfg, q[:8], ql[:8]))
        got_b = beam_topk.beam_topk_batch(idx.tensors, cfg, got[0], K)
        check_equal("beam_topk" + sfx, f"{name} widest W=3072", got_b,
                    beam_topk.beam_topk_plain(idx.tensors, cfg, got[0], K))
    # the cached merge on both cache layouts, k < F*K, k == F*K, k > F*K
    loci_et = loci_sets["USPS ET", "default"][2]
    F = int(loci_et.shape[1])
    for name, idx in (("USPS ET cache", usps_et_c),
                      ("USPS ET packed cache", usps_et_pc)):
        for k in (K, CACHE_K, F * CACHE_K, F * CACHE_K + 88):
            got = locus_merge.locus_topk_merge(idx.tensors, loci_et, k)
            want = locus_merge.locus_merge_plain(idx.tensors, loci_et, k)
            check_equal("locus_topk_merge", f"{name} F={F} K={CACHE_K} "
                        f"k={k}", got, want)
        one = loci_et[:, :1].contiguous()
        got = locus_merge.locus_topk_merge(idx.tensors, one, CACHE_K + 4)
        check_equal("locus_topk_merge", f"{name} F=1 k=K+4", got,
                    locus_merge.locus_merge_plain(idx.tensors, one,
                                                  CACHE_K + 4))
    # topk_select at the rule-free cached route's shape and on wide rows
    q, ql = batch(usps_small, seed=1)
    node, depth = trie_walk.trie_walk(tp.first_child, tp.edge_char,
                                      tp.edge_child, q, ql)
    loci_plain = torch.where(depth == ql, node, -1)[:, None].contiguous()
    sel_s, sel_p = cached.gather_cached(usps_plain_c.tensors, loci_plain)
    got = topk_select.topk_select(sel_s, sel_p, K)
    check_equal("topk_select", f"USPS plain cache C={CACHE_K} k={K}", got,
                topk_select.topk_select_plain(sel_s, sel_p, K))
    got = topk_select.topk_select(sel_s, sel_p, CACHE_K)
    check_equal("topk_select", f"USPS plain cache k=C={CACHE_K}", got,
                topk_select.topk_select_plain(sel_s, sel_p, CACHE_K))
    gen = torch.Generator().manual_seed(0)
    wide_s = torch.randint(0, 40, (64, 512), generator=gen,
                           dtype=torch.int32).to(dev)
    wide_p = torch.randint(0, 10**6, (64, 512), generator=gen,
                           dtype=torch.int32).to(dev)
    for k in (K, 512):
        got = topk_select.topk_select(wide_s, wide_p, k)
        check_equal("topk_select", f"[64, 512] seeded ties k={k}", got,
                    topk_select.topk_select_plain(wide_s, wide_p, k))

    # -- phase 4: the main path ---------------------------------------------------
    counters = {
        "trie_walk": (trie_walk, "launches"),
        "locus_dp": (locus_dp, "launches"),
        "locus_dp_packed": (locus_dp, "packed_launches"),
        "beam_topk": (beam_topk, "launches"),
        "beam_topk_packed": (beam_topk, "packed_launches"),
        "topk_select": (topk_select, "launches"),
        "locus_topk_merge": (locus_merge, "launches"),
    }
    plain_counters = ((trie_walk, "plain_calls"), (locus, "calls"),
                      (beam, "calls"), (cached, "calls"),
                      (cached, "select_calls"))

    def reset_counts():
        for mod, attr in list(counters.values()) + list(plain_counters):
            setattr(mod, attr, 0)

    def counts():
        c = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
        c["plain"] = sum(getattr(mod, attr) for mod, attr in plain_counters)
        return c

    answers = {}

    def main_path(name, idx, ds, must_launch):
        queries = make_workload(ds, 512, seed=1)
        batches = [queries[i:i + B] for i in range(0, len(queries), B)]
        service = rt.CompletionService(idx)
        service.complete(batches[0], k=K)           # warm-up
        service.reset_stats()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        reset_counts()
        lat = []
        results = []
        for b in batches:
            t = time.perf_counter()
            results += service.complete(b, k=K)
            lat.append((time.perf_counter() - t) * 1e3)
        c = counts()
        peak = torch.cuda.max_memory_allocated()
        st = service.stats
        lat_sorted = sorted(lat)
        hits = sum(1 for r in results if r) / len(results)
        n = len(idx.strings)
        log(f"main path {name}: {st.n_queries} queries in {st.batches} "
            f"batches of {B}, k={K}: "
            f"{st.total_seconds / st.n_queries * 1e6:.1f} us/completion, "
            f"batch p50 {lat_sorted[len(lat) // 2]:.3f} ms, p99 "
            f"{lat_sorted[min(int(len(lat) * 0.99), len(lat) - 1)]:.3f} ms, "
            f"hit rate {hits:.4f}, index {device_bytes(idx)} B on the card "
            f"= {device_bytes(idx) / n:.1f} B/string (the paper claims "
            f"{PAPER_B_PER_STRING[0]}-{PAPER_B_PER_STRING[1]}), "
            f"max_memory_allocated {peak} B (all indexes resident: "
            f"{resident} B; the path's own peak {peak - resident} B), "
            f"launches {c}")
        for k_name in must_launch:
            if c[k_name] <= 0:
                raise AssertionError(f"{name}: {k_name} never launched")
        if c["plain"]:
            raise AssertionError(f"{name}: a plain version ran on the main "
                                 "path")
        idx.reconfigure(substrate="torch")
        want = [r for b in batches for r in idx.complete(b, k=K)]
        idx.reconfigure(substrate="cuda")
        if results != want:
            bad = [i for i, (a, b) in enumerate(zip(results, want)) if a != b]
            raise AssertionError(f"{name}: cuda and torch substrates differ "
                                 f"on queries {bad[:5]}")
        log(f"  {name}: cuda answers equal the torch substrate's "
            f"({len(results)} queries)")
        answers[name] = results
        return c

    def same_answers(a, b):
        if answers[a] != answers[b]:
            bad = [i for i, (x, y) in enumerate(zip(answers[a], answers[b]))
                   if x != y]
            raise AssertionError(f"{a} and {b} answer differently on "
                                 f"queries {bad[:5]}")
        log(f"  {a}: answers equal {b}'s ({len(answers[a])} queries)")

    if usps_et.substrate != "cuda":
        raise AssertionError(f"auto resolved to {usps_et.substrate} on CUDA")
    launched = {}

    def record(c, *names):
        for k_name in names:
            launched[k_name] = launched.get(k_name, 0) + c[k_name]

    record(main_path("USPS ET", usps_et, usps, ("locus_dp", "beam_topk")),
           "locus_dp", "beam_topk")
    record(main_path("USPS plain", usps_plain, usps_small,
                     ("trie_walk", "beam_topk")), "trie_walk")
    record(main_path("USPS ET packed", usps_et_p, usps,
                     ("locus_dp_packed", "beam_topk_packed")),
           "locus_dp_packed", "beam_topk_packed")
    same_answers("USPS ET packed", "USPS ET")
    record(main_path("USPS ET packed cache_k=16", usps_et_pc, usps,
                     ("locus_dp_packed", "locus_topk_merge")),
           "locus_topk_merge")
    main_path("USPS ET cache_k=16", usps_et_c, usps,
              ("locus_dp", "locus_topk_merge"))
    same_answers("USPS ET packed cache_k=16", "USPS ET cache_k=16")
    record(main_path("USPS plain cache_k=16", usps_plain_c, usps_small,
                     ("trie_walk", "topk_select")), "topk_select")

    # the paper's Figure 1 example, answered by hand, in every layout
    fig1 = (["andrew pavlo", "andrew parker", "andrew packard",
             "william smith", "bill of rights"], [50, 40, 30, 20, 10],
            make_rules([("andy", "andrew"), ("bill", "william")]))
    want_fig1 = [[(50, "andrew pavlo"), (40, "andrew parker"),
                  (30, "andrew packard")], [(20, "william smith")], []]
    for kind in ("tt", "et", "ht"):
        for opt in ({}, {"compression": "packed"}, {"cache_k": 4},
                    {"compression": "packed", "cache_k": 4}):
            got = rt.build_index(*fig1, kind=kind, device=dev, **opt)\
                .complete(["andy pa", "bill sm", "xyz"], k=3)
            if got != want_fig1:
                raise AssertionError(f"Figure 1 example, {kind} {opt}: {got}")
    log("Figure 1 example: tt/et/ht answers as expected, dense and packed, "
        "with and without a cache")

    # -- phase 5: kernel times and bounds at the main path's shapes ---------------
    q, ql = batch(usps, seed=1)
    q_plain, ql_plain = batch(usps_small, seed=1)
    t_et, cfg_et = usps_et.tensors, usps_et.cfg
    t_etp, cfg_etp = usps_et_p.tensors, usps_et_p.cfg
    t_pc = usps_et_pc.tensors
    loci_et = locus_dp.locus_dp_walk(t_et, cfg_et, q, ql)[0]
    loci_etp = locus_dp.locus_dp_walk(t_etp, cfg_etp, q, ql)[0]
    node, depth = trie_walk.trie_walk(tp.first_child, tp.edge_char,
                                      tp.edge_child, q_plain, ql_plain)
    loci_plain = torch.where(depth == ql_plain, node, -1)[:, None]
    sel_s, sel_p = cached.gather_cached(usps_plain_c.tensors, loci_plain)
    scores, sids, _ = beam_topk.beam_topk_batch(t_et, cfg_et, loci_et, K)
    n_chars = int(ql.sum())
    n_found = int((sids >= 0).sum())
    n_loci = int((loci_et >= 0).sum())
    tiers = dict(cfg_etp.table_widths)
    w_esc = 2 if tiers["c_escore"] == "uint16" else 4
    w_sid = 2 if tiers["l_sid"] == "uint16" else 4
    pc = dict(usps_et_pc.cfg.table_widths)
    w_pc = ((2 if pc["pc_score"] == "uint16" else 4)
            + (2 if pc["pc_sid"] == "uint16" else 4))
    tc = usps_et_c.tensors

    def merge_library():
        # gather the dense cache rows, mask the empty slots, then one
        # torch.topk over the union and a gather of the sids: two calls
        # around the selection
        n = torch.where(loci_et >= 0, loci_et, 0)
        sc = torch.where((loci_et >= 0)[..., None], tc.topk_score[n], -1)
        si = torch.where((loci_et >= 0)[..., None], tc.topk_sid[n], -1)
        top = torch.topk(sc.reshape(B, -1), K, dim=1)
        return top.values, torch.gather(si.reshape(B, -1), 1, top.indices)

    def select_library():
        top = torch.topk(sel_s, K, dim=1)
        return top.values, torch.gather(sel_p, 1, top.indices)

    rows = []
    specs = [
        ("trie_walk", "src/repro_torch/kernels/csrc/trie_walk.cu",
         "src/repro/kernels/trie_walk.py:81",
         lambda: trie_walk.trie_walk(tp.first_child, tp.edge_char,
                                     tp.edge_child, q_plain, ql_plain),
         lambda: trie_walk.trie_walk_plain(tp.first_child, tp.edge_char,
                                           tp.edge_child, q_plain, ql_plain),
         None,
         # queries, lengths, outputs, and per consumed character a pointer
         # pair, the matching character and the child
         B * L_BUCKET * 4 + B * 4 + B * 8 + int(depth.sum()) * 16,
         int(depth.sum()) * 8),
        ("locus_dp", "src/repro_torch/kernels/csrc/locus_dp.cu",
         "src/repro/kernels/locus_dp.py:732",
         lambda: locus_dp.locus_dp_walk(t_et, cfg_et, q, ql),
         lambda: locus_dp.locus_dp_plain(t_et, cfg_et, q, ql),
         None,
         # queries, lengths, outputs, and per query character one lookup
         # (pointer pair, character, child) and one teleport row
         B * L_BUCKET * 4 + B * 4 + B * cfg_et.frontier * 4 + B * 4
         + n_chars * (16 + 4 * cfg_et.tele_width),
         n_chars * 8),
        ("locus_dp_packed", "src/repro_torch/kernels/csrc/locus_dp.cu",
         "src/repro/kernels/locus_dp.py:832",
         lambda: locus_dp.locus_dp_walk(t_etp, cfg_etp, q, ql),
         lambda: locus_dp.locus_dp_plain(t_etp, cfg_etp, q, ql),
         None,
         # queries, lengths, outputs, and per query character the u8 flag
         # and label of a unary step and one teleport-id probe and row
         B * L_BUCKET * 4 + B * 4 + B * cfg_etp.frontier * 4 + B * 4
         + n_chars * (2 + 4 + 4 * cfg_etp.tele_width),
         n_chars * 8),
        ("beam_topk", "src/repro_torch/kernels/csrc/beam_topk.cu",
         "src/repro/kernels/beam_topk.py:413",
         lambda: beam_topk.beam_topk_batch(t_et, cfg_et, loci_et, K),
         lambda: beam_topk.beam_topk_plain(t_et, cfg_et, loci_et, K),
         None,
         # loci, outputs, a pointer pair per locus, and per result found
         # its emission (node, score, leaf flag) and string id
         B * cfg_et.frontier * 4 + B * K * 8 + B + n_loci * 8
         + n_found * 13,
         n_found * 8),
        ("beam_topk_packed", "src/repro_torch/kernels/csrc/beam_topk.cu",
         "src/repro/kernels/beam_topk.py:440",
         lambda: beam_topk.beam_topk_batch(t_etp, cfg_etp, loci_etp, K),
         lambda: beam_topk.beam_topk_plain(t_etp, cfg_etp, loci_etp, K),
         None,
         # loci, outputs, a c_ids entry and pointer pair per locus, and per
         # result found its emission (node, tiered score, u8 leaf flag),
         # an l_ids entry and its tiered string id
         B * cfg_etp.frontier * 4 + B * K * 8 + B + n_loci * 12
         + n_found * (4 + w_esc + 1 + 4 + w_sid),
         n_found * 8),
        ("topk_select", "src/repro_torch/kernels/csrc/topk_select.cu",
         "src/repro/kernels/topk_select.py:37",
         lambda: topk_select.topk_select(sel_s, sel_p, K),
         lambda: topk_select.topk_select_plain(sel_s, sel_p, K),
         select_library,
         # scores and payload read once, the top-k written once; one
         # compare per candidate
         sel_s.numel() * 8 + B * K * 8, sel_s.numel()),
        ("locus_topk_merge", "src/repro_torch/kernels/csrc/locus_merge.cu",
         "src/repro/kernels/locus_merge.py:53",
         lambda: locus_merge.locus_topk_merge(t_pc, loci_etp, K),
         lambda: locus_merge.locus_merge_plain(t_pc, loci_etp, K),
         merge_library,
         # loci, outputs, and per live locus a c_ids entry, its base and
         # its cache row of K (score, sid) entries at their tiers; one
         # compare per candidate
         B * cfg_etp.frontier * 4 + B * K * 8
         + n_loci * (8 + CACHE_K * w_pc),
         n_loci * CACHE_K),
    ]
    saved = counts()
    for name, source, replaces, kern, plain, library, nbytes, ops in specs:
        ms = cuda_ms(kern, 20)
        plain_ms = cuda_ms(plain, 3)
        library_ms = cuda_ms(library, 20) if library else None
        bound_ms, bound_by = bound(nbytes, ops)
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launched[name],
                     "max_abs_err": MAX_ABS_ERR[name], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms})
        log(f"time {name}: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, "
            f"library {library_ms if library_ms is None else f'{library_ms:.4f} ms'}, "
            f"bound {bound_ms:.6f} ms ({bound_by}, {nbytes} B, {ops} ops)")
    log("time locus_topk_merge on the dense cache, same loci: "
        f"{cuda_ms(lambda: locus_merge.locus_topk_merge(tc, loci_et, K), 20):.4f}"
        " ms")
    for k_name, (mod, attr) in counters.items():
        setattr(mod, attr, saved[k_name])
    log("build seconds: " + json.dumps(
        {" ".join(map(str, k)) if isinstance(k, tuple) else k: v
         for k, v in builds.items()}))
    log(f"smoke wall time: {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
