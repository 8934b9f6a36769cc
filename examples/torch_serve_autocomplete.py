"""End-to-end serving driver on the PyTorch/CUDA port: build a USPS-scale
synonym completion index, replay a batched query workload through the
CompletionService, report latency and throughput per structure.

The counterpart of ``serve_autocomplete.py`` (the same output lines),
through ``repro_torch``'s API.  Runs on the card; pass ``--device cpu`` to
run the kernels' plain versions on the CPU (at a small ``--n``).

  PYTHONPATH=src python examples/torch_serve_autocomplete.py [--n 100000]
"""

import argparse
import time

from repro_torch.api import IndexSpec, build_index
from repro_torch.core import make_rules
from repro_torch.data.strings import make_usps, make_workload
from repro_torch.serving import CompletionService


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--queries", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="the indexes' device (default: cuda)")
    args = ap.parse_args(argv)

    print(f"building USPS-like dataset: {args.n} strings ...")
    ds = make_usps(n=args.n, seed=0)
    queries = make_workload(ds, args.queries, seed=1, max_len=16)
    batches = [queries[i: i + args.batch]
               for i in range(0, len(queries), args.batch)
               if len(queries[i: i + args.batch]) == args.batch]

    for kind, kw in [("tt", {}), ("et", {}), ("ht", {"alpha": 0.5}),
                     ("et+cache", {"cache_k": 16})]:
        spec = IndexSpec(kind=kind.split("+")[0], **kw)
        t0 = time.perf_counter()
        idx = build_index(ds.strings, ds.scores, make_rules(ds.rules), spec,
                          device=args.device)
        build_s = time.perf_counter() - t0
        svc = CompletionService(idx)
        svc.complete(batches[0], k=args.k)            # warm-up
        t0 = time.perf_counter()
        n = 0
        for b in batches:
            svc.complete(b, k=args.k)
            n += len(b)
        dt = time.perf_counter() - t0
        print(f"{kind:9s} build {build_s:6.1f}s  "
              f"{idx.stats.bytes_per_string:7.1f} B/string  "
              f"{dt / n * 1e6:8.1f} us/completion  "
              f"{n / dt:8.0f} q/s")

    # incremental typing through a stateful serving session: each keystroke
    # advances the saved locus frontier instead of rescanning the prefix
    idx = build_index(ds.strings, ds.scores, make_rules(ds.rules),
                      IndexSpec(kind="et", cache_k=16), device=args.device)
    svc = CompletionService(idx)
    sess = svc.open_session(k=3)
    sess.type(queries[0])                               # warm-up
    svc.stats.reset_keystrokes()
    for q in queries[:64]:
        sess.reset()
        sess.type(q)
    print(f"keystroke sessions: {svc.stats.n_keystrokes} keystrokes  "
          f"{svc.stats.mean_keystroke_ms * 1e3:8.1f} us/keystroke  "
          f"p99 {svc.stats.p99_keystroke_ms():6.2f} ms")

    # show a few suggestions
    for q in queries[:5]:
        out = idx.complete([q], k=3)[0]
        print(f"  {q!r} -> {[s for _, s in out]}")


if __name__ == "__main__":
    main()
