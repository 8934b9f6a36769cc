#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py            # from the repository root

Phases, each of which fails the run (non-zero exit) when it fails:

1. print the card (``nvidia-smi``), the torch and CUDA versions, and build
   the hand-written kernels from ``src/repro_torch/kernels/csrc``;
2. hold each kernel against its plain PyTorch version on the card, element
   for element, at the main path's shapes (B=64, L bucket 32, k=10) with
   the default widths and with widened retry-round widths;
3. drive the main path through ``CompletionService.complete``: USPS ET at
   1,000,000 strings (the paper's size, seed 0) with the launcher's batch
   workload (512 queries, batch 64, one warm-up batch), and USPS plain at
   100,000 strings for the rule-free walk.  Every kernel of a path must
   launch in it, no plain version may run, and the answers must equal the
   ``"torch"`` substrate's on the same index;
4. print one JSON line per kernel set and, last, the device line.

``--small`` runs every phase on small corpora (a quick compile-and-check).
Without a CUDA device the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
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

B, L_BUCKET, K = 64, 32, 10
RETRY = dict(frontier=64, gens=192, max_steps=2048)     # first retry round
WIDEST = dict(frontier=256, gens=3072, max_steps=32768)  # third retry round


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


def check_equal(what: str, got, want) -> None:
    """Outputs are integers (and flags): the tolerance is exact equality."""
    import torch

    err = max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
              for g, w in zip(got, want))
    name = what.split()[0]
    MAX_ABS_ERR[name] = max(MAX_ABS_ERR.get(name, 0), err)
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            bad = (g != w).nonzero()[:5].tolist()
            raise AssertionError(f"{what}: kernel and plain version differ "
                                 f"at {bad}")
    log(f"  {what}: equal")


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    from repro_torch.core.alphabet import pad_queries
    from repro_torch.core.engine import beam, locus
    from repro_torch.core.trie_build import make_rules
    from repro_torch.data.strings import make_dblp, make_usps, make_workload
    from repro_torch.kernels import _build, beam_topk, locus_dp, trie_walk

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

    # -- the indexes --------------------------------------------------------------
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

    dblp = make_dblp(n_dblp, seed=0)
    usps_small = make_usps(n_usps_plain, seed=0)
    t = time.perf_counter()
    usps = make_usps(n_usps_et, seed=0)
    log(f"make_usps({n_usps_et}): {time.perf_counter() - t:.3f} s")
    dblp_tt = build("DBLP", dblp, "tt")
    dblp_ht = build("DBLP", dblp, "ht")
    usps_plain = build("USPS", usps_small, "plain")
    usps_et = build("USPS", usps, "et")

    def batch(ds, seed):
        qs, ql = pad_queries(make_workload(ds, B, seed=seed), L_BUCKET)
        return (torch.from_numpy(qs).to(dev), torch.from_numpy(ql).to(dev))

    # -- phase 2: each kernel against its plain version -------------------------
    log("kernel parity (kernel vs plain version on the card):")
    loci_sets = {}
    for name, idx, ds in (("DBLP TT", dblp_tt, dblp),
                          ("DBLP HT", dblp_ht, dblp),
                          ("USPS ET", usps_et, usps)):
        q, ql = batch(ds, seed=1)
        for label, widths in (("default", {}), ("retry", RETRY)):
            cfg = replace(idx.cfg, **widths)
            got = locus_dp.locus_dp_walk(idx.tensors, cfg, q, ql)
            want = locus_dp.locus_dp_plain(idx.tensors, cfg, q, ql)
            check_equal(f"locus_dp {name} {label} F={cfg.frontier}", got,
                        want)
            loci_sets[name, label] = (idx, cfg, got[0])
    q, ql = batch(usps_small, seed=1)
    got = trie_walk.trie_walk(usps_plain.tensors.first_child,
                              usps_plain.tensors.edge_char,
                              usps_plain.tensors.edge_child, q, ql)
    want = trie_walk.trie_walk_plain(usps_plain.tensors.first_child,
                                     usps_plain.tensors.edge_char,
                                     usps_plain.tensors.edge_child, q, ql)
    check_equal("trie_walk USPS plain", got, want)
    for (name, label), (idx, cfg, loci) in loci_sets.items():
        got = beam_topk.beam_topk_batch(idx.tensors, cfg, loci, K)
        want = beam_topk.beam_topk_plain(idx.tensors, cfg, loci, K)
        check_equal(f"beam_topk {name} {label} W={cfg.gens} exact="
                    f"{int(got[2].sum())}/{B}", got, want)
    # the widest retry round the default spec can reach, on a few queries
    q, ql = batch(usps, seed=2)
    cfg = replace(usps_et.cfg, **WIDEST)
    got = locus_dp.locus_dp_walk(usps_et.tensors, cfg, q[:8], ql[:8])
    check_equal("locus_dp USPS ET widest F=256", got,
                locus_dp.locus_dp_plain(usps_et.tensors, cfg, q[:8], ql[:8]))
    got_b = beam_topk.beam_topk_batch(usps_et.tensors, cfg, got[0], K)
    check_equal("beam_topk USPS ET widest W=3072", got_b,
                beam_topk.beam_topk_plain(usps_et.tensors, cfg, got[0], K))

    # -- phase 3: the main path ---------------------------------------------------
    def reset_counts():
        trie_walk.launches = locus_dp.launches = beam_topk.launches = 0
        trie_walk.plain_calls = locus.calls = beam.calls = 0

    def counts():
        return {"trie_walk": trie_walk.launches,
                "locus_dp": locus_dp.launches,
                "beam_topk": beam_topk.launches,
                "plain": trie_walk.plain_calls + locus.calls + beam.calls}

    def main_path(name, idx, ds, must_launch):
        queries = make_workload(ds, 512, seed=1)
        batches = [queries[i:i + B] for i in range(0, len(queries), B)]
        service = rt.CompletionService(idx)
        service.complete(batches[0], k=K)           # warm-up
        service.reset_stats()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
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
        log(f"main path {name}: {st.n_queries} queries in {st.batches} "
            f"batches of {B}, k={K}: {st.total_seconds / st.n_queries * 1e6:.1f}"
            f" us/completion, batch p50 {lat_sorted[len(lat) // 2]:.3f} ms, "
            f"p99 {lat_sorted[min(int(len(lat) * 0.99), len(lat) - 1)]:.3f} "
            f"ms, hit rate {hits:.4f}, max_memory_allocated {peak} B, "
            f"launches {c}")
        for k_name in must_launch:
            if c[k_name] <= 0:
                raise AssertionError(f"{name}: {k_name} never launched")
        if c["plain"]:
            raise AssertionError(f"{name}: a plain version ran on the main "
                                 "path")
        idx.reconfigure(substrate="torch")
        try:
            want = [r for b in batches for r in idx.complete(b, k=K)]
        finally:
            idx.reconfigure(substrate="cuda")
        if results != want:
            bad = [i for i, (a, b) in enumerate(zip(results, want)) if a != b]
            raise AssertionError(f"{name}: cuda and torch substrates differ "
                                 f"on queries {bad[:5]}")
        log(f"  {name}: cuda answers equal the torch substrate's "
            f"({len(results)} queries)")
        return c

    if usps_et.substrate != "cuda":
        raise AssertionError(f"auto resolved to {usps_et.substrate} on CUDA")
    launched = {}
    c = main_path("USPS ET", usps_et, usps, ("locus_dp", "beam_topk"))
    launched.update(locus_dp=c["locus_dp"], beam_topk=c["beam_topk"])
    c = main_path("USPS plain", usps_plain, usps_small,
                  ("trie_walk", "beam_topk"))
    launched["trie_walk"] = c["trie_walk"]

    # the paper's Figure 1 example, answered by hand
    fig1 = (["andrew pavlo", "andrew parker", "andrew packard",
             "william smith", "bill of rights"], [50, 40, 30, 20, 10],
            make_rules([("andy", "andrew"), ("bill", "william")]))
    want_fig1 = [[(50, "andrew pavlo"), (40, "andrew parker"),
                  (30, "andrew packard")], [(20, "william smith")], []]
    for kind in ("tt", "et", "ht"):
        got = rt.build_index(*fig1, kind=kind, device=dev).complete(
            ["andy pa", "bill sm", "xyz"], k=3)
        if got != want_fig1:
            raise AssertionError(f"Figure 1 example, {kind}: {got}")
    log("Figure 1 example: tt/et/ht answers as expected")

    # -- phase 4: kernel times and bounds at the main path's shapes -------------
    q, ql = batch(usps, seed=1)
    q_plain, ql_plain = batch(usps_small, seed=1)
    t_et, cfg_et = usps_et.tensors, usps_et.cfg
    loci_et = locus_dp.locus_dp_walk(t_et, cfg_et, q, ql)[0]
    tp = usps_plain.tensors
    node, depth = trie_walk.trie_walk(tp.first_child, tp.edge_char,
                                      tp.edge_child, q_plain, ql_plain)
    scores, sids, _ = beam_topk.beam_topk_batch(t_et, cfg_et, loci_et, K)
    n_chars = int(ql.sum())
    n_found = int((sids >= 0).sum())
    n_loci = int((loci_et >= 0).sum())
    rows = []
    specs = [
        ("trie_walk", "src/repro_torch/kernels/csrc/trie_walk.cu",
         "src/repro/kernels/trie_walk.py:81",
         lambda: trie_walk.trie_walk(tp.first_child, tp.edge_char,
                                     tp.edge_child, q_plain, ql_plain),
         lambda: trie_walk.trie_walk_plain(tp.first_child, tp.edge_char,
                                           tp.edge_child, q_plain, ql_plain),
         # queries, lengths, outputs, and per consumed character a pointer
         # pair, the matching character and the child
         B * L_BUCKET * 4 + B * 4 + B * 8 + int(depth.sum()) * 16,
         int(depth.sum()) * 8),
        ("locus_dp", "src/repro_torch/kernels/csrc/locus_dp.cu",
         "src/repro/kernels/locus_dp.py:732",
         lambda: locus_dp.locus_dp_walk(t_et, cfg_et, q, ql),
         lambda: locus_dp.locus_dp_plain(t_et, cfg_et, q, ql),
         # queries, lengths, outputs, and per query character one lookup
         # (pointer pair, character, child) and one teleport row
         B * L_BUCKET * 4 + B * 4 + B * cfg_et.frontier * 4 + B * 4
         + n_chars * (16 + 4 * cfg_et.tele_width),
         n_chars * 8),
        ("beam_topk", "src/repro_torch/kernels/csrc/beam_topk.cu",
         "src/repro/kernels/beam_topk.py:413",
         lambda: beam_topk.beam_topk_batch(t_et, cfg_et, loci_et, K),
         lambda: beam_topk.beam_topk_plain(t_et, cfg_et, loci_et, K),
         # loci, outputs, a pointer pair per locus, and per result found
         # its emission (node, score, leaf flag) and string id
         B * cfg_et.frontier * 4 + B * K * 8 + B + n_loci * 8
         + n_found * 13,
         n_found * 8),
    ]
    saved = (trie_walk.launches, locus_dp.launches, beam_topk.launches)
    for name, source, replaces, kern, plain, nbytes, ops in specs:
        ms = cuda_ms(kern, 20)
        plain_ms = cuda_ms(plain, 3)
        bound_ms, bound_by = bound(nbytes, ops)
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launched[name],
                     "max_abs_err": MAX_ABS_ERR[name], "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": None})
        log(f"time {name}: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, "
            f"bound {bound_ms:.6f} ms ({bound_by}, {nbytes} B)")
    trie_walk.launches, locus_dp.launches, beam_topk.launches = saved
    log(f"build seconds: {json.dumps({f'{a} {b}': v for (a, b), v in builds.items()})}")

    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
