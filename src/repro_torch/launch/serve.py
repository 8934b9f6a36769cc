"""Serving launcher.

  python -m repro_torch.launch.serve --arch autocomplete-usps --queries 1000
  python -m repro_torch.launch.serve --arch autocomplete-usps --workload keystroke
  python -m repro_torch.launch.serve --arch autocomplete-usps \\
      --device cpu --substrate torch --n-strings 3000        (on the CPU)
  python -m repro_torch.launch.serve --arch h2o-danube-1.8b  (LM decode)

The paper's end-to-end system for the autocomplete archs: build (or
``--load-index``) the index, replay a workload — one-shot batches, a
per-keystroke stream through a stateful session, many Zipf-skewed
sessions sequential against the continuous-batching scheduler, or that
stream with the dictionary churning underneath it — and print one JSON
line of latency and throughput (Fig. 7-style numbers).  ``--substrate``
picks the execution substrate (``torch``: the plain PyTorch versions,
``cuda``: the hand-written kernels, ``auto``: cuda on a CUDA device).
The index lives on ``--device`` (CUDA unless told otherwise).

For an LM arch it serves the arch's smoke config, random weights, through
the continuous-batching ``LMServer`` (``serve_lm``).  The recsys and GNN
archs have no serve mode here, as in ``repro``'s launcher: they exit
with ``no serve mode for family ...``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.api import CompletionIndex, IndexSpec, build_index
from repro_torch.configs import get_arch
from repro_torch.core.trie_build import make_rules
from repro_torch.data.strings import (DATASETS, make_keystroke_events,
                                      make_workload)
from repro_torch.models.transformer import init_lm
from repro_torch.serving import (BatchStats, CompletionService, LMServer,
                                 Request)


def _make_index(spec, args):
    """Build the index from the arch's dataset, or restore a saved one."""
    name = spec.arch_id.split("-")[-1]
    cfg = spec.make_config()
    n = min(cfg.n_strings, args.n_strings)
    ds = DATASETS[name](n=n, seed=0)
    t0 = time.perf_counter()
    if args.load_index:
        # loading re-resolves the *saved* spec's substrate for this host;
        # only an explicit --substrate flag overrides it
        idx = CompletionIndex.load(args.load_index, device=args.device)
        overrides = {}
        if args.substrate is not None:
            overrides["substrate"] = args.substrate
        if args.memory_budget is not None:
            overrides["memory_budget"] = args.memory_budget
        if overrides:
            idx.reconfigure(**overrides)
    else:
        idx = build_index(
            ds.strings, ds.scores, make_rules(ds.rules),
            IndexSpec(kind=args.index_kind, cache_k=args.cache_k,
                      substrate=args.substrate or "auto",
                      memory_budget=args.memory_budget or 0,
                      compression=args.compression), device=args.device)
    build_s = time.perf_counter() - t0
    if args.save_index:
        idx.save(args.save_index)
    return ds, idx, build_s


def serve_autocomplete(spec, args):
    ds, idx, build_s = _make_index(spec, args)
    svc = CompletionService(idx)
    queries = make_workload(ds, args.queries, seed=1)
    # warmup + timed batches
    svc.complete(queries[:32], k=10)
    t0 = time.perf_counter()
    bs = args.batch
    results = []
    for i in range(0, len(queries), bs):
        results.extend(svc.complete(queries[i : i + bs], k=10))
    dt = time.perf_counter() - t0
    hit = sum(bool(r) for r in results) / max(len(results), 1)
    out = {
        "arch": spec.arch_id, "kind": idx.kind,
        "substrate": idx.substrate,
        "compression": idx.compression,
        "memory_budget": idx.memory_budget,
        "workload": "batch",
        "n_strings": idx.stats.n_strings,
        "bytes_per_string": round(idx.stats.bytes_per_string, 1),
        "build_seconds": round(build_s, 2),
        "queries": len(results),
        "us_per_completion": round(dt / max(len(results), 1) * 1e6, 1),
        "hit_rate": round(hit, 3),
    }
    print(json.dumps(out))
    return out


def serve_keystroke(spec, args):
    """Incremental replay: every query is typed char-by-char through a
    stateful session, i.e. the per-keystroke serving contract."""
    ds, idx, build_s = _make_index(spec, args)
    svc = CompletionService(idx)
    queries = make_workload(ds, args.queries, seed=1)
    sess = svc.open_session(k=10)
    sess.type(queries[0])                         # warm-up
    svc.stats.reset_keystrokes()
    hits = 0
    for q in queries:
        sess.reset()
        rows = sess.type(q)
        hits += bool(rows)
    st = svc.stats
    out = {
        "arch": spec.arch_id, "kind": idx.kind,
        "substrate": idx.substrate,
        "compression": idx.compression,
        "memory_budget": idx.memory_budget,
        "workload": "keystroke",
        "n_strings": idx.stats.n_strings,
        "build_seconds": round(build_s, 2),
        "queries": len(queries),
        "keystrokes": st.n_keystrokes,
        "us_per_keystroke": round(st.mean_keystroke_ms * 1e3, 1),
        "p99_keystroke_ms": round(st.p99_keystroke_ms(), 3),
        "hit_rate": round(hits / max(len(queries), 1), 3),
    }
    print(json.dumps(out))
    return out


def _replay_sequential(svc, events, n_sessions, k=10):
    """One advance and one phase 2 per keystroke: the pre-batching serving
    shape."""
    sessions = [svc.open_session(k=k) for _ in range(n_sessions)]
    out = []
    for s, c in events:
        if c < 0:
            sessions[s].reset()
        else:
            out.append(sessions[s].type(bytes([c])))
    for sess in sessions:
        sess.close()
    return out


def _submit_events(svc, events, n_sessions, k=10, before=None):
    """Keystrokes submitted without blocking so concurrent sessions
    coalesce into shared micro-batches.  A full admission queue sheds load
    with one forced flush before the submit it would refuse; a session
    whose stream ends is closed at once so its idle lane stops holding
    back the full-flush condition, and a session dealt no event is closed
    before the first (the JAX package's replay leaves it open, so a
    second replay through the same service finds no free lane).
    ``before(i, tickets)`` runs ahead of event i.  Returns the tickets, in
    submit order, once drained."""
    remaining = [0] * n_sessions
    for s, _ in events:
        remaining[s] += 1
    sessions = [svc.open_session(k=k) for _ in range(n_sessions)]
    for s in range(n_sessions):
        if not remaining[s]:
            sessions[s].close()
    tickets = []
    for i, (s, c) in enumerate(events):
        if before is not None:
            before(i, tickets)
        if c < 0:
            sessions[s].reset()
        else:
            if svc.scheduler.pending >= svc.scheduler.max_queue:
                svc.flush()
            tickets.append(sessions[s].submit(c))
        remaining[s] -= 1
        if remaining[s] == 0:
            sessions[s].close()
    svc.drain()
    return tickets


def _replay_batched(svc, events, n_sessions, k=10):
    """:func:`_submit_events`' answers, one per keystroke."""
    return [t.results for t in _submit_events(svc, events, n_sessions, k)]


def serve_zipf(spec, args):
    """Multi-session Zipf keystroke load, sequential per-session dispatch
    vs the continuous-batching scheduler — same events, bit-identity
    checked, speedup and tail latency reported."""
    ds, idx, build_s = _make_index(spec, args)
    events = make_keystroke_events(ds, args.sessions, args.queries, seed=1)
    seq = CompletionService(idx)
    bat = CompletionService(idx, batching=True, block=args.block,
                            max_wait_ms=args.max_wait_ms,
                            max_queue=args.max_queue)

    # untimed warm-up replay through both paths
    seq_results = _replay_sequential(seq, events, args.sessions)
    bat_results = _replay_batched(bat, events, args.sessions)

    def timed(svc, replay):
        svc.stats.reset_keystrokes()
        if svc.batching:
            svc.scheduler.stats = BatchStats()
        t0 = time.perf_counter()
        replay(svc, events, args.sessions)
        return time.perf_counter() - t0

    # best-of with the repeats interleaved, so ambient machine drift hits
    # both paths alike instead of biasing whichever ran second
    seq_dt = bat_dt = float("inf")
    for _ in range(args.repeats):
        seq_dt = min(seq_dt, timed(seq, _replay_sequential))
        bat_dt = min(bat_dt, timed(bat, _replay_batched))

    n = len(seq_results)
    bstats = bat.scheduler.stats
    out = {
        "arch": spec.arch_id, "kind": idx.kind,
        "substrate": idx.substrate,
        "compression": idx.compression,
        "workload": "zipf",
        "n_strings": idx.stats.n_strings,
        "build_seconds": round(build_s, 2),
        "sessions": args.sessions, "block": args.block,
        "queries": args.queries, "keystrokes": n,
        "bit_identical": seq_results == bat_results,
        "seq_us_per_keystroke": round(seq_dt / max(n, 1) * 1e6, 1),
        "batch_us_per_keystroke": round(bat_dt / max(n, 1) * 1e6, 1),
        "speedup": round(seq_dt / max(bat_dt, 1e-9), 2),
        "seq_p50_ms": round(seq.stats.p50_keystroke_ms(), 3),
        "seq_p99_ms": round(seq.stats.p99_keystroke_ms(), 3),
        "batch_p50_ms": round(bat.stats.p50_keystroke_ms(), 3),
        "batch_p99_ms": round(bat.stats.p99_keystroke_ms(), 3),
        "flushes": bstats.n_flushes,
        "mean_occupancy": round(bstats.mean_occupancy, 2),
        "deadline_flushes": bstats.deadline_flushes,
        "fallbacks": bstats.fallbacks,
    }
    print(json.dumps(out))
    return out


def _same_up_to_ties(pre, post, k: int) -> bool:
    """Two answers to one probe batch agree: the same scores row for row,
    and for each score the same strings, but in the lowest score of a row
    of k, where k may cut a tie between equal scores either way.  The
    overlay-merged path orders equal scores by string, a rebuilt index's
    beam by its search order, so only the order inside a tie may differ."""
    for a, b in zip(pre, post):
        if [s for s, _ in a] != [s for s, _ in b]:
            return False
        for score in {s for s, _ in a}:
            if (len(a) < k or score != a[-1][0]) and \
                    sorted(x for s, x in a if s == score) != \
                    sorted(x for s, x in b if s == score):
                return False
    return len(pre) == len(post)


def serve_churn(spec, args):
    """Zipf keystroke stream with the dictionary churning underneath it.

    Every ``--churn-every`` keystrokes a mutation batch lands on the live
    index (one trending insert, one delete, one re-score); once the
    overlay backlog reaches ``--compact-at`` the service compacts —
    rebuilding the index and swapping it in under the open scheduler
    lanes, which migrate at their next flush.  Reports keystroke
    throughput alongside mutation/compaction cost, and verifies zero lost
    keystrokes plus probe-query agreement between the final
    overlay-merged answers and the post-compaction rebuilt index, up to
    the order of equal scores (:func:`_same_up_to_ties`; the JAX
    package's check asks for the same order, which the two paths do not
    give where scores tie).
    """
    ds, idx, build_s = _make_index(spec, args)
    events = make_keystroke_events(ds, args.sessions, args.queries, seed=1)
    svc = CompletionService(idx, batching=True, block=args.block,
                            max_wait_ms=args.max_wait_ms,
                            max_queue=args.max_queue)
    rng = np.random.default_rng(2)
    base_strings = list(idx.strings)
    deleted: set[bytes] = set()
    mutations = {"insert": 0, "delete": 0, "rescore": 0}
    churn = {"n_hot": 0, "compactions": 0, "mut_s": 0.0, "compact_s": 0.0}

    def mutate(i, tickets):
        if not i or i % args.churn_every:
            return
        m0 = time.perf_counter()
        idx.insert(b"zz~trending-%d" % churn["n_hot"],
                   int(rng.integers(1, 1000)))
        churn["n_hot"] += 1
        mutations["insert"] += 1
        victim = base_strings[int(rng.integers(len(base_strings)))]
        if victim not in deleted:
            idx.delete(victim)
            deleted.add(victim)
            mutations["delete"] += 1
        target = base_strings[int(rng.integers(len(base_strings)))]
        if target not in deleted:
            idx.update_score(target, int(rng.integers(1, 1000)))
            mutations["rescore"] += 1
        churn["mut_s"] += time.perf_counter() - m0
        if idx.mutation_backlog >= args.compact_at:
            c0 = time.perf_counter()
            svc.compact()
            churn["compact_s"] += time.perf_counter() - c0
            churn["compactions"] += 1

    t0 = time.perf_counter()
    tickets = _submit_events(svc, events, args.sessions, before=mutate)
    dt = time.perf_counter() - t0
    lost = sum(t.results is None for t in tickets)
    # verification: the overlay-merged answers must survive the fold —
    # compact() rebuilds from scratch internally, so pre/post agreement
    # on a probe batch is a merged-path-vs-rebuild differential for free
    probe = sorted({bytes(t.prefix)[:3] for t in tickets})[:24]
    pre = idx.complete(probe, k=10)
    c0 = time.perf_counter()
    svc.compact()
    churn["compact_s"] += time.perf_counter() - c0
    churn["compactions"] += 1
    post = idx.complete(probe, k=10)
    bstats = svc.scheduler.stats
    n = len(tickets)
    out = {
        "arch": spec.arch_id, "kind": idx.kind,
        "substrate": idx.substrate,
        "compression": idx.compression,
        "workload": "churn",
        "n_strings": idx.stats.n_strings,
        "build_seconds": round(build_s, 2),
        "sessions": args.sessions, "block": args.block,
        "keystrokes": n,
        "us_per_keystroke": round(dt / max(n, 1) * 1e6, 1),
        "p50_ms": round(svc.stats.p50_keystroke_ms(), 3),
        "p99_ms": round(svc.stats.p99_keystroke_ms(), 3),
        "mutations": mutations,
        "mutation_ms_mean": round(
            churn["mut_s"] / max(sum(mutations.values()), 1) * 1e3, 3),
        "compactions": churn["compactions"],
        "compact_ms_mean": round(
            churn["compact_s"] / max(churn["compactions"], 1) * 1e3, 1),
        "migrations": bstats.migrations,
        "final_epoch": idx.epoch,
        "lost_keystrokes": lost,
        "verified": _same_up_to_ties(pre, post, 10),
        "flushes": bstats.n_flushes,
        "mean_occupancy": round(bstats.mean_occupancy, 2),
    }
    print(json.dumps(out))
    return out


WORKLOADS = {"batch": serve_autocomplete, "keystroke": serve_keystroke,
             "zipf": serve_zipf, "churn": serve_churn}


def serve_lm(spec, args):
    """The LM arch's smoke config with random weights (a generator seeded
    0) behind ``LMServer``: ``--queries`` requests of 8-15 random tokens,
    16 new tokens each, over ``--batch`` decode lanes."""
    cfg = spec.make_smoke_config()
    dev = torch.device(args.device or "cuda")
    params = init_lm(torch.Generator(device=dev).manual_seed(0), cfg,
                     device=dev)
    server = LMServer(params, cfg, n_slots=args.batch, max_len=96)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for i in range(args.queries):
        server.scheduler.submit(Request(
            rid=i, prompt=rng.integers(0, cfg.vocab, 8 + i % 8),
            max_new_tokens=16))
    done = server.run()
    dt = time.perf_counter() - t0
    toks = sum(len(r.tokens) for r in done)
    ttfts = [r.first_token_at - r.created for r in done]
    out = {
        "arch": spec.arch_id, "requests": len(done),
        "tokens": toks, "tok_per_s": round(toks / dt, 1),
        "mean_ttft_ms": round(float(np.mean(ttfts)) * 1e3, 1),
    }
    print(json.dumps(out))
    return out


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--queries", type=int, default=512)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--n-strings", type=int, default=100_000)
    ap.add_argument("--index-kind", default="et",
                    choices=["tt", "et", "ht", "plain"])
    ap.add_argument("--cache-k", type=int, default=0)
    ap.add_argument("--compression", default="none",
                    choices=["none", "packed"],
                    help="on-device index layout; packed = format-v4 "
                         "compressed tables (narrow dtypes, elided "
                         "planes, collapsed unary chains). Ignored with "
                         "--load-index (the container records it)")
    ap.add_argument("--substrate", default=None,
                    choices=["torch", "cuda", "auto"],
                    help="execution substrate; auto = cuda on a CUDA "
                         "device, torch on the CPU. Default: auto when "
                         "building, the saved choice when --load-index")
    ap.add_argument("--memory-budget", type=int, default=None,
                    help="the JAX package's VMEM budget: accepted and "
                         "carried into the index's config, no effect on "
                         "the card (every table sits in device memory)")
    ap.add_argument("--device", default=None,
                    help="device the index or the LM lives on (default: "
                         "cuda; pass cpu on a host without one)")
    ap.add_argument("--workload", default="batch", choices=list(WORKLOADS),
                    help="batch = one-shot query batches; keystroke = one "
                         "session typing char-by-char; zipf = many "
                         "concurrent sessions under Zipf-skewed traffic, "
                         "sequential vs continuous-batching comparison; "
                         "churn = zipf traffic with live insert/delete/"
                         "re-score batches and periodic compaction "
                         "hot-swaps under the open sessions")
    ap.add_argument("--churn-every", type=int, default=64,
                    help="keystrokes between mutation batches for "
                         "--workload churn")
    ap.add_argument("--compact-at", type=int, default=48,
                    help="overlay backlog (pending inserts+tombstones) "
                         "that triggers a compaction hot-swap for "
                         "--workload churn")
    ap.add_argument("--sessions", type=int, default=8,
                    help="concurrent typing sessions for --workload zipf")
    ap.add_argument("--block", type=int, default=8,
                    help="scheduler micro-batch lanes (the slab shape)")
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="scheduler latency budget before a partial-block "
                         "deadline flush")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="scheduler admission-queue bound (default "
                         "4*block); deeper queues trade keystroke latency "
                         "for fuller micro-batches")
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed replays per path for --workload zipf "
                         "(interleaved best-of)")
    ap.add_argument("--save-index", default=None,
                    help="persist the built index to this .npz path")
    ap.add_argument("--load-index", default=None,
                    help="restore an index instead of rebuilding")
    ap.add_argument("--smoke", action="store_true", default=True)
    return ap


def main(argv=None):
    """Run one workload (an LM arch: ``serve_lm``); returns its JSON
    line's dict.  A recsys or GNN arch has no serve mode: ``SystemExit``,
    as ``repro``'s launcher gives."""
    args = parser().parse_args(argv)
    spec = get_arch(args.arch)
    if spec.family == "lm":
        return serve_lm(spec, args)
    if spec.family != "autocomplete":
        raise SystemExit(f"no serve mode for family {spec.family}")
    return WORKLOADS[args.workload](spec, args)


if __name__ == "__main__":
    main()
