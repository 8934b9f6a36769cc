#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py            # from the repository root

Phases, each of which fails the run (non-zero exit) when it fails:

1. print the card (``nvidia-smi``), the torch and CUDA versions, and build
   the hand-written kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all at once; ``-Xptxas -v`` printed per source)
   once phase 2's worker processes have at most two jobs left;
2. build the indexes, every host build in eight spawned worker processes
   (results through files, their large arrays mapped on read; each index
   onto the card as it lands).  USPS ET at 1,000,000 strings (the paper's
   size, seed 0) is built once; its cached (``cache_k=16``) and packed
   (``compression="packed"``) variants are derived from the same host trie
   by the build's own later steps (the top-K cache, then the compressed
   layout), so the 1M host build is paid once;
3. hold each kernel against its plain PyTorch version on the card,
   element for element, at the main path's shapes (B=64, L bucket 32,
   k=10) with the default widths, the first retry round's and the widest:
   the dense and the packed locus DP and beam on DBLP TT, DBLP HT (24,810
   strings) and USPS ET 1M; the locus DP at E = 0, 1 and 2 (both
   accessors, DBLP TT, DBLP HT, USPS plain 100k and USPS ET 1M, at F =
   32, 64, 128 and 256, and with its rows forced into the device-memory
   workspace) and the beam on those loci at each retry round's widths (W
   = 48 to 3,072; 16 queries past W = 192) on USPS ET and DBLP HT; both on
   a batch of queries of 1 and of 32 characters; the beam at every
   round's width (W = 48 to 3,072; 16 queries past W = 192) on two
   tie-heavy USPS ET 100k corpora (every score equal; scores drawn from
   three values), the packed and the dense beam also equal;
   ``trie_walk``, both entries ((node, depth) and the loci of the
   rule-free phase 1), on USPS plain
   100k's CSR, DBLP's dictionary CSR, a random byte-string corpus (root
   row 255, deeper rows wider than 32) and an empty edge table, at L = 8,
   32 and 64 and B = 1, 63, 64, 65 and 1,024, the loci also against the
   ``"torch"`` substrate's walk;
   ``locus_topk_merge`` on the dense and the packed K=16 cache of USPS ET
   1M (1.4M stored nodes, read through the rank tree) and of the two
   tie-heavy corpora, at F = 1 to 64 (every keys-a-lane template of the
   warp path) and 65 and 128 (the block path), k = 1, 10, 16, F*K and
   F*K + 88, and on every packed cache tier (DBLP TT's u16 sids, a USPS
   plain 100k corpus with scores spread over 2^30 for int32 scores);
   ``topk_select`` at the rule-free cached route's shape (C=K=16, k=10
   and 16) and at C = 1 to 2,048 (every template and the block path) on
   rows of ties, of one score and of unsorted int32 scores, k = 1, 10
   and C; ``candidate_topk`` at 1 query x 1,000,000
   candidates x D=64, k=100, in float32 and bfloat16, at three ragged
   shapes, at D=33 on a misaligned slice (the scalar-load path), on all
   scores equal (ids exactly 0..k-1), on scores ascending by id (every row
   enters the buffer), at the largest k its launch plan takes and on
   20,000 rows of D=1000 (the query partly read from memory) (scores
   within 1e-5 relative, ids equal but for near-ties); ``embedding_bag`` on
   a 1,000,000 x 64 table and a misaligned 1,000,000 x 33 one, 512 bags of
   0-32 entries, through the dense and the ragged entry, sum and mean,
   with and without 5 % -1 entries, uncut and cut at ``max_bag=16``,
   float32 (1e-5) and bfloat16 (3e-2), on 64 bags of 0-100 entries (a
   bag read 32 entries at a time), and the ragged entry on int64 indices
   and offsets without weights;
4. drive the main path through ``CompletionService.complete`` with the
   launcher's batch workload (512 queries of ``make_workload(seed=1)``,
   batch 64, k=10, one warm-up batch) on: USPS ET 1M dense (beam), USPS
   plain 100k dense (beam), USPS ET 1M packed (beam), USPS ET 1M packed
   with ``cache_k=16``, USPS ET 1M dense with ``cache_k=16`` and USPS
   plain 100k with ``cache_k=16``; then bounded-edit completion: the same
   USPS ET 1M indexes (dense and packed, beam and ``cache_k=16``)
   reconfigured to ``edit_budget=1`` without a rebuild, and the dense one
   with the beam at ``edit_budget=2``; then the off-path ``ops`` entry
   points (``candidate_topk`` at the retrieval shape, ``embedding_bag``
   on the ragged batch of 512 bags); then USPS ET 1M's compile cache
   (hits, misses and evictions over the phase, equal to a replay of the
   keys it was asked for) and the ``ops`` wrappers under ``repro``'s
   names (``trie_walk``, ``locus_walk``, ``beam_topk``, ``topk_select``,
   ``cached_topk_merge``, ``cached_topk_merge_packed``) on the workload's
   first batch of USPS ET 1M (dense, packed, with and without the cache)
   and USPS plain 100k: each launching its kernel, bit for bit equal to
   the ``"torch"`` substrate's plain version on the same tensors and to
   phase 4's path, ``streamed=True`` equal to False, the packed streamed
   beam and k > C raising, an empty dictionary, k = C and k past F*K
   answered as ``repro`` answers them, and each timed over 20 calls.
   Every kernel of a path must launch
   in it, no plain version may run, the answers must equal the
   ``"torch"`` substrate's on
   the same index (edit paths: on their first 128, at E = 2 64, queries;
   the USPS plain paths' phase 1 must be the loci entry's launches alone),
   and each packed index's answers must equal the dense index's of the
   same cache depth and edit budget (node ids are shared, so the layouts
   agree bit for bit);
4b. live serving, ahead of phase 5's keystroke traces: (a) the keystroke
   scheduler on USPS ET 1M with ``cache_k=16`` (dense and packed), without
   a cache, and on USPS plain 100k with ``cache_k=16``: ``serve_zipf``'s
   workload (``make_keystroke_events``, 8 sessions, seed 1, cut from 64
   queries to 16 for time; block 8, ``max_wait_ms=2.0``) replayed a
   keystroke at a time through ``open_session`` and through
   ``CompletionService(batching=True)`` after a warm-up of the first 64
   events, every keystroke's answer equal both ways, every flush's
   dispatch under CUDA's sync debug mode "error" (µs a keystroke each
   way, batched p50/p99, flushes, occupancy, deadline flushes,
   fallbacks), and one full flush traced by the profiler (its CUDA
   kernels and the device's busy share; an empty trace or one without
   the phase-2 kernel fails the run); (b) ``serve_churn``'s loop on USPS
   ET 100k with ``cache_k=16`` (64 queries): a mutation batch every 64
   events, ``compact()`` at a backlog of 48 under the live lanes
   (mutation ms, compaction seconds, migrations, no keystroke lost, every
   keystroke equal to ``complete`` on its prefix in the state it was
   answered in, probe answers equal across each fold), then the 512-query
   batch workload on the mutated index equal on ``"cuda"`` and
   ``"torch"``; (c) on a
   copy of USPS ET 1M packed ``cache_k=16``, 16 inserts that synonym
   rules reach, 16 deletes and 16 re-scores of strings in the workload's
   top-10s, then the 512-query batch workload against the unmutated run
   (p50/p99; answers equal on both substrates on the first 128 queries,
   no deleted string shown);
4c. the sharded index and the serving launcher: (a) USPS ET 1M over 16
   shards with ``cache_k=16``, dense (the repo's sharded deployment of
   USPS, ``src/repro/configs/autocomplete.py``), its shards built in
   eight worker processes on the host in phase 2, then wrapped with
   ``ShardedCompletionIndex.from_shards``: the 512-query batch workload
   through ``CompletionService.complete`` (each batch one ``locus_dp``
   and one ``locus_topk_merge`` a shard and one ``topk_select`` at [64,
   160], no plain version), its first 128 answers equal to the torch
   substrate's over the same stacked tables, its scores equal to phase 4's
   unsharded USPS ET 1M ``cache_k=16`` row for row (strings may differ
   only in a run of equal scores that k cuts), and so at k = 20 on 64
   queries (the beam on every shard); µs/completion, p50/p99, bytes on the
   card with the stacking's padding, the build's seconds, inexact shard
   answers; (b) the mesh path at world size 1 over NCCL (a (1, 1)
   DeviceMesh) over the unsharded USPS ET 1M ``cache_k=16`` index as its
   one shard, its answers equal to the local mode's; (c) DBLP TT over 3
   shards saved and loaded back onto the card, answers equal; (d) the
   launcher's ``main`` in process: batch, keystroke, zipf and churn runs
   that load the container of its default index (100,000 strings), built
   and saved by a worker process in phase 2 (keystroke, zipf and churn at
   16 queries each for time; zipf one timed repeat, churn a mutation
   batch every 32 events): each JSON line printed, zipf
   bit-identical with no fallback, churn verified with no keystroke
   lost, the batch hit rate equal to ``complete``'s on the loaded
   container;
5. typing sessions, save and load, multi-term completion: the first 16
   queries of the batch workload typed one byte at a time through
   ``CompletionService.open_session(k=10)`` (one warm-up query, a
   ``reset`` between queries) on USPS ET 1M with ``cache_k=16`` (dense and
   packed: ``locus_topk_merge`` at B=1), without a cache (the beam at
   B=1), at ``edit_budget=1``, and on USPS plain 100k with ``cache_k=16``
   (``topk_select`` at B=1): every keystroke equal to ``complete`` on its
   prefix and to the ``"torch"`` substrate's session (of 8 queries on the
   path without a cache),
   the phase-2 kernel launched, no plain version run, ms per keystroke
   (p50, p99), keystrokes per second and the hit rate; for one keystroke
   of each, no host sync in init and advance (CUDA's sync debug mode), the
   advance's CUDA kernels and the keystroke's device busy share and
   phase-2 time (profiler), and so for one keystroke on DBLP TT (the
   link store's rule steps); USPS ET 1M packed with ``cache_k=16`` and
   USPS plain 100k saved (by a thread beside phase 3, host work alone) and
   loaded back onto the card (seconds, bytes),
   their answers on the batch workload equal to the originals' with the
   same kernels launching; ``kind="multiterm"`` on the JAX package's
   example (its expected answers, dense and packed) and on DBLP cut to
   1,000 strings, dense and packed (built by phase 2's worker processes;
   batch against the torch substrate,
   sessions against ``complete`` and, dense, 2 of them against the torch
   substrate's session, packed against dense; ``locus_dp`` launching);
5b. LM serving (no completion kernel launches in it): (a) h2o-danube-1.8b
   at full width (24 layers, 1.83 B parameters, random weights from a
   seeded generator on the card) behind ``LMServer(n_slots=64,
   max_len=96)`` over 128 of ``serve_lm``'s requests (8-15 tokens, 16 new
   tokens each): every request done with 16 tokens below the vocab, and,
   teacher-forced by one no-cache ``forward`` over each request's prompt
   and emitted tokens, every chosen token's logit within ``LM_TF_TOL`` of
   its position's largest (tok/s, TTFT mean and p99, ms a decode step at
   64 lanes, ms a prefill); (b) one request of 4,200 tokens at max_len
   4,352 (the 4,096-position ring wraps in prefill) and 16 decode steps,
   checked the same way (prefill ms, peak device memory); (c) 2 of its
   layers on the card and on the CPU from one numpy tree, prefill and 4
   decode steps' logits within ``LM_CARD_CPU_TOL``; (d) the launcher's LM
   mode for the five LM archs at their smoke configs (``--queries 16
   --batch 8``), then granite-moe-1b-a400m at full width behind
   ``LMServer`` on 8 requests (tokens below the vocab, logits finite);
5c. the recsys and GNN models at full width, random weights from a
   seeded generator on the card: (a) DLRM-RM2, DIN, SASRec and MIND on
   ``serve_p99`` (B=512, the arch's serving forward) and
   ``retrieval_cand`` (B=1, the user function, then ``retrieval_topk``
   over 1,000,000 candidates, k=100: ``candidate_topk`` a row, MIND's max
   over its interests in plain PyTorch; SASRec's on a full-length
   history, since a shorter one gives a zero user), (b) DLRM on ``serve_bulk``
   (B=262,144), each checked for shape and finite values (retrieval:
   distinct ids, scores descending), with ms, rows a second and peak
   memory; rows 12-13 launch there (DIN's pooled history is
   ``embedding_bag_dense``), counted, no plain version run; (c)
   ``candidate_topk`` at DLRM's, DIN's (D=18) and SASRec's (D=50)
   retrieval shapes (DIN's and SASRec's user rows, checked nonzero, and a
   random query) and DIN's pooled history ``[512, 100]`` through
   ``embedding_bag_dense`` against their plain versions; (d) gin-tu (5
   layers, d_hidden 64) on ``full_graph_sm``, ``molecule`` (128 graphs)
   and ``ogb_products`` (2,449,029 nodes, 61,859,140 edges, d_feat 100;
   drawn by a phase-2 worker), ms and peak memory; (e) the five archs at
   their smoke configs from one numpy tree on the card and on the CPU
   within ``CARD_CPU_TOL``; (f) ``examples/torch_autocomplete_rerank.py``
   on the card printing the CPU's lines, and the launcher's ``--arch
   sasrec`` / ``gin-tu`` exiting with ``repro``'s message;
5d. training (``training_phase``, run after phase 4b and ahead of phase
   4c, where the card holds least and no trace follows phase 5's):
   (a) h2o-danube-1.8b at full width (float32 weights and AdamW state,
   bfloat16 activations, remat), 3 steps of ``make_train_step`` on one
   ``TokenStream`` batch of 8 x 1,024 (train_4k cut to one card): losses
   finite, the first within 2 of ln(vocab), the third no higher than the
   first plus 1e-2; ms a step, tokens/s, peak memory; a fourth step
   traced (busy share, the kernels with the most device time); (b) DIN at
   its published config on ``train_batch`` (65,536 ``ClickStream``
   histories of 100), 3 steps and a traced fourth, rows/s; (c) the ten
   archs' smoke configs through ``launch/train.py``; (d) a restart from
   the checkpoint the launcher wrote; (e) ``examples/torch_train_lm.py``
   at 40 steps (its loss must fall) — row 13's forward and backward
   kernels launched in (a)-(e), counted, no plain version run; then the
   launcher's first losses card against CPU, danube's loss and gradients
   at 2 layers card against CPU, the bag's two kernels against their
   plain versions at ``train_batch`` (d_items and d_weights within 1e-5
   of their scale), DIN's attention MLP and item table given gradients
   through the bag, and the backward's row of the kernels line (b2b and
   graph ms, plain, ``F.embedding_bag`` forward and backward, bound);
6. time each kernel against its plain version, its bound and (where one
   exists) a PyTorch library call at the main path's shapes (the locus DP
   also at E = 1 and 2, and the locus DP and the beam at every width the
   main path launched them, with their launches counted per width in
   phase 4; ``candidate_topk`` also in bfloat16,
   ``embedding_bag`` also through its dense entry), by CUDA events over
   20 back-to-back calls; for ``topk_select``, ``locus_topk_merge``,
   ``candidate_topk`` and ``embedding_bag`` and their library calls also
   with the host out (the 20 calls captured once in a CUDA graph, the
   replay timed) and the host microseconds per call (1,000 calls, no
   synchronise), ``locus_topk_merge`` so also on the dense cache with the
   packed run's loci (the gap is the rank lookups' cost); ``trie_walk``
   so too, with its loci entry and the rule-free ``walk_batch`` it
   serves; rows 12-13 also at phase 5c's model widths (D=18, D=50, and
   DIN's bags); print one JSON line of kernels (their launches summed over
   phases 4, 4b, 4c, 5 and 5c), the card, and, last, the device line;
   ``topk_select`` also at the cross-shard merge's [64, 160].  The profiler's
   traces of phase 4's paths run at the end of phase 4, ahead of phase
   5's: ``candidate_topk``'s two kernels apart, the rule-free
   ``walk_batch`` (which must be one kernel a call) and one batch of each
   USPS plain path (the device's busy share of the batch window, device
   time by kernel), each window's wrapper launches counted.

``--small`` runs every phase on small corpora (a quick compile-and-check).
Without a CUDA device the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the card's published peaks (H100 SXM data sheet): HBM bandwidth and the
# float32 rate outside the tensor cores, against which the kernels' int32
# compares are counted
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

B, L_BUCKET, K, CACHE_K = 64, 32, 10, 16
EDIT_FRONTIERS = (64, 128, 256)   # the widened retry's frontiers
# the off-path kernels' shapes: the JAX package's retrieval_cand cell (1
# query x 1,000,000 candidates) and serve_p99 (512 bags) at DLRM RM2's
# embed_dim and table rows (src/repro/configs/base.py, dlrm_rm2.py)
CAND_N, CAND_D, CAND_K = 1_000_000, 64, 100
BAG_ROWS, BAG_D, BAGS, BAG_MAX = 1_000_000, 64, 512, 32
RETRY = dict(frontier=64, gens=192, max_steps=2048)     # first retry round
WIDEST = dict(frontier=256, gens=3072, max_steps=32768)  # third retry round
TIE_SCORES = ("equal", "three")   # every score 7; scores from {5, 9, 13}
PAPER_B_PER_STRING = (160, 200)   # the paper's space claim
# typing sessions: queries typed per path, and of those held keystroke by
# keystroke against complete and the torch substrate's session (cut from
# 32 to 16 for time when phase 4c came); on the path without a cache, the
# torch session's plain beam (~0.17 s a keystroke on an H100 host) holds
# fewer
SESSION_QUERIES = (16, 16)
SESSION_QUERIES_TORCH_BEAM = 8
# live serving: serve_zipf's and serve_churn's defaults
# (src/repro/launch/serve.py) — 8 sessions of 64 Zipf queries, block 8,
# a 2 ms latency budget, a mutation batch every 64 events, compaction at a
# backlog of 48 — with the scheduler's replays cut to 16 queries for time
# (the churn keeps 64: its compaction needs the backlog), the first 64
# events a warm-up; 16 inserts, deletes and re-scores on USPS ET 1M, the
# torch substrate holding the first 128 queries of the mutated batch
# (its plain packed beam at k = 42)
SERVE_SESSIONS, SERVE_BLOCK, SERVE_WAIT_MS = 8, 8, 2.0
SERVE_QUERIES, CHURN_QUERIES = 16, 64
SERVE_WARMUP_EVENTS = 64
CHURN_EVERY, COMPACT_AT = 64, 48
N_MUTATE = 16
N_MUTATED_TORCH = 128
# the sharded index at the repo's own sharded deployment of USPS
# (src/repro/configs/autocomplete.py: 16 shards, cache_k=16), its shards
# built in a worker process a core on the host; its beam pass (k = 20 >
# cache_k) on the workload's first 64 queries, and the torch substrate
# holding the first 128 of the batch workload
SHARDS, SHARD_WORKERS = 16, 8
SHARD_K_BEAM, SHARD_BEAM_QUERIES, SHARD_TORCH_QUERIES = 20, 64, 128
DBLP_SHARDS = 3
# the launcher's workloads in process (--n-strings at its default
# 100,000): keystroke, zipf and churn cut from 512 queries to 16 for time,
# zipf to one timed repeat, churn's mutation batches every 32 events (its
# backlog then stays under --compact-at: one compaction, after the
# stream; phase 4b compacts under live lanes)
LAUNCH_QUERIES, LAUNCH_CHURN_EVERY = 16, 32
# the multi-term build's corpus, cut from DBLP's 24,810 strings: its
# synthesized rules grow fast with the corpus
N_DBLP_MULTITERM = 1_000
# LM serving (phase 5b): h2o-danube-1.8b at full width (its config,
# src/repro/configs/h2o_danube_1_8b.py; random weights from a seeded
# generator) behind LMServer: 64 lanes of 96 positions, 128 of serve_lm's
# requests (8-15 random tokens, 16 new tokens each); one request of 4,200
# tokens at max_len 4,352 (a ring of the 4,096-position window that wraps
# in prefill); the card against the CPU at 2 layers over 4 decode steps;
# the launcher's LM mode at --queries 16 --batch 8; granite-moe at full
# width on 8 requests.  A chosen token passes the teacher-forced check
# when its logit is within LM_TF_TOL of its position's largest (logits
# spread with a standard deviation of ~1; decode's float32 stream and
# forward's bfloat16 one differ by up to 0.007 at 4 layers on the CPU)
LM_ARCH, LM_MOE_ARCH = "h2o-danube-1.8b", "granite-moe-1b-a400m"
LM_SLOTS, LM_MAX_LEN, LM_REQUESTS, LM_NEW_TOKENS = 64, 96, 128, 16
LM_LONG_PROMPT, LM_LONG_MAX_LEN = 4_200, 4_352
LM_TF_TOL = 0.1
LM_CARD_CPU_STEPS, LM_CARD_CPU_TOL = 4, 2e-2
LM_LAUNCH_QUERIES, LM_LAUNCH_BATCH = 16, 8
LM_MOE_REQUESTS = 8
# the recsys and GNN models (phase 5c): the four recsys archs at their
# full configs (src/repro/configs/{dlrm_rm2,din,sasrec,mind}.py; random
# weights from a seeded generator on the card) on their serve_p99 and
# retrieval_cand cells (configs/base.py RECSYS_SHAPES), DLRM also on
# serve_bulk; retrieval keeps repro's k = 100 (configs/cells.py); --small
# cuts the vocab to REC_SMALL_VOCAB and the batch to 4,096; the card
# against the CPU at the smoke configs within CARD_CPU_TOL
REC_ARCHS = ("dlrm-rm2", "din", "sasrec", "mind")
RETRIEVAL_K = 100
REC_SMALL_VOCAB = 20_000
CARD_CPU_TOL = 1e-4
# training (phase 5d): h2o-danube-1.8b at full width (float32 weights and
# AdamW state, bfloat16 activations, remat) for TRAIN_STEPS steps of
# make_train_step on one TokenStream batch of TRAIN_BATCH x TRAIN_SEQ
# (train_4k's 256 x 4,096 cut to one card; the same batch each step, so
# the loss check reads the steps and not the batches' noise); its first
# loss within TRAIN_FIRST_LOSS_SPAN of ln(vocab) (weights of std 0.02
# give logits of std ~1); 2 layers of it card against CPU on
# TRAIN_CARD_CPU_TOKENS within LM_CARD_CPU_TOL of each gradient leaf's
# scale; DIN at its published config on train_batch (65,536 ClickStream
# histories of 100; one batch, TRAIN_STEPS steps), the bag's backward
# against its plain version there within BAG_GRAD_TOL of its scale; the
# ten archs' smoke configs through the launcher for TRAIN_LAUNCH_STEPS
# steps, card against CPU on the first loss within CARD_CPU_TOL; a
# restart from a checkpoint the launcher wrote; the training example at
# TRAIN_EXAMPLE_STEPS steps.  A loss may end no higher than its first
# plus TRAIN_LOSS_RISE (AdamW's warmup keeps the first steps small)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 1_024, 3
TRAIN_FIRST_LOSS_SPAN, TRAIN_LOSS_RISE = 2.0, 1e-2
TRAIN_CARD_CPU_TOKENS = (2, 64)
BAG_GRAD_TOL = 1e-5
TRAIN_LAUNCH_STEPS, TRAIN_EXAMPLE_STEPS = 3, 40
#: the phase-2 kernels, as the profiler names them, by launch counter
PHASE2_KERNELS = {"beam_topk": ("beam_topk_kernel",),
                  "beam_topk_packed": ("beam_topk_kernel",),
                  "locus_topk_merge": ("merge_warp", "merge_block"),
                  "topk_select": ("topk_select_warp", "topk_select_block")}
# the JAX package's multi-term example (tests/test_modes.py): the last
# token completes after up to multiterm_gap skipped tokens
MT_STRINGS = [b"the new york times", b"new york", b"san francisco giants",
              b"the giants", b"new jersey", b"times square"]
MT_SCORES = [60, 50, 40, 30, 20, 10]
MT_EXPECT = {
    b"the t": [(60, "the new york times")],
    b"the times": [(60, "the new york times")],
    b"the york t": [(60, "the new york times")],
    b"new y": [(50, "new york")],
    b"san g": [(40, "san francisco giants")],
    b"the g": [(30, "the giants")],
    b"t": [(60, "the new york times"), (30, "the giants"),
           (10, "times square")],
}


def dump_parts(parts, path: str) -> None:
    """Pickle ``parts`` to ``path``, every numpy array of 1 MiB or more
    written beside it as a raw ``.npy`` file (read back mapped)."""
    import pickle

    import numpy as np

    arrays = []

    def persistent_id(obj):
        if isinstance(obj, np.ndarray) and obj.nbytes >= 1 << 20:
            name = f"{path}.{len(arrays)}.npy"
            np.save(name, obj)
            arrays.append(name)
            return name
        return None

    with open(path, "wb") as f:
        pickler = pickle.Pickler(f, protocol=5)
        pickler.persistent_id = persistent_id
        pickler.dump(parts)


def load_parts(path: str):
    """What :func:`dump_parts` wrote, its large arrays memory-mapped copy
    on write: a read costs no copy, the copy to the card reads the pages.
    Through a plain pickle the 1M index's ~20 GB came back at ~0.33 GB/s."""
    import pickle

    import numpy as np

    with open(path, "rb") as f:
        unpickler = pickle.Unpickler(f)
        unpickler.persistent_load = lambda name: np.load(name, mmap_mode="c")
        return unpickler.load()


def host_job(job):
    """One host build step in a worker process (``device="cpu"``), its
    result written to ``path`` (:func:`dump_parts`) as the parts
    ``CompletionIndex.from_parts`` takes (a pipe back to the parent moves
    ~0.14 GB/s).  ``("build", (strings, scores, rule_pairs, spec_kw))``
    builds an index; ``("derive", (src, cache, compression))`` reads the
    parts at ``src`` and runs the build's last steps on a copy of its
    trie: the per-node top-K cache when ``cache``, then the packed layout
    when ``compression == "packed"``; ``("save", (strings, scores,
    rule_pairs, spec_kw, container))`` builds an index and saves its
    container at ``container`` (the parts written are that path);
    ``("graph", (n_nodes, n_edges, d_feat, n_classes))`` draws
    ``make_random_graph``'s (src, dst, feats) without its CSR.
    Returns the step's start and end."""
    what, args, path = job
    import torch

    import repro_torch as rt
    from repro_torch.api.build import derived_stats
    from repro_torch.core import trie_build as tb
    from repro_torch.core.trie_build import make_rules

    torch.set_num_threads(1)
    t = time.time()
    if what == "graph":       # make_random_graph's (src, dst, feats)
        from repro_torch.data.graph import make_random_graph

        g = make_random_graph(*args, build_csr=False)
        parts = (g.src, g.dst, g.feats)
    elif what in ("build", "save"):
        strings, scores, rule_pairs, spec_kw = args[:4]
        if not len(strings):        # an empty shard, as the index builds it
            strings, scores = [""], [1]
        idx = rt.build_index(strings, scores, make_rules(rule_pairs),
                             rt.IndexSpec(**spec_kw), device="cpu")
        parts = (idx.trie, idx.rule_trie, idx.rules, idx.strings,
                 idx.scores, idx.cfg, idx.spec, idx.stats)
        if what == "save":
            idx.save(args[4])
            parts = args[4]
    else:
        src, cache, compression = args
        trie, rule_trie, rules, strings, scores, cfg, spec, stats = \
            load_parts(src)
        trie = dataclasses.replace(trie)
        if cache:
            tb.build_topk_cache(trie, CACHE_K)
        widths = tb.pack_compressed(trie) if compression == "packed" else {}
        cache_k = CACHE_K if trie.topk_score is not None else 0
        cfg = dataclasses.replace(
            cfg, use_cache=cache_k > 0, cache_k=cache_k,
            compression=compression,
            table_widths=tuple(sorted(widths.items())))
        parts = (trie, rule_trie, rules, strings, scores, cfg,
                 spec.replace(cache_k=cache_k, compression=compression),
                 derived_stats(stats, trie, rule_trie))
    end = time.time()
    dump_parts(parts, path)
    return t, end


def host_builds(jobs: dict, workers: int, tmp: str, out: dict) -> None:
    """Run ``jobs`` ({name: (what, args, source job or None)}) in
    ``workers`` spawned processes, filling ``out``: a job starts once its
    source has landed (a derive step reads its source's file), the rest
    in the order given.  Each result is read back as it lands into
    ``out["parts"]`` (``out["landed"]`` notified), its (start, end) from
    t0 into ``out["spans"]``; ``out["quiet"]`` is set once at most two
    jobs remain; then the wall seconds and a line on how the builds
    overlapped, or ``out["error"]``."""
    from concurrent.futures import FIRST_COMPLETED, ProcessPoolExecutor, wait

    t0 = time.time()
    path = {name: str(Path(tmp) / f"job_{i}.pkl")
            for i, name in enumerate(jobs)}
    parts, spans, read = out["parts"], out["spans"], 0.0
    try:
        with ProcessPoolExecutor(
                workers,
                mp_context=multiprocessing.get_context("spawn")) as ex:
            running = {}

            def submit_ready():
                for name, (what, args, src) in jobs.items():
                    if name in spans or name in running.values() \
                            or (src is not None and src not in spans):
                        continue
                    if what == "derive":
                        args = (path[src],) + tuple(args)
                    running[ex.submit(host_job,
                                      (what, args, path[name]))] = name

            submit_ready()
            while running:
                done, _ = wait(running, return_when=FIRST_COMPLETED)
                for fut in done:
                    a, b = fut.result()
                    spans[running.pop(fut)] = (a - t0, b - t0)
                submit_ready()
                if len(running) <= 2:
                    out["quiet"].set()
                for name in [n for n in spans if n not in parts]:
                    t = time.time()
                    got = load_parts(path[name])
                    read += time.time() - t
                    with out["landed"]:
                        parts[name] = got
                        out["landed"].notify_all()
    except Exception as err:     # the waiting parent fails on it too
        out["error"] = err
        raise
    finally:
        out["quiet"].set()
        with out["landed"]:
            out["landed"].notify_all()
    if "error" in out:
        return
    edges = sorted([(a, 1) for a, _ in spans.values()]
                   + [(b, -1) for _, b in spans.values()])
    now = most = 0
    for _, step in edges:
        now += step
        most = max(most, now)
    out["wall"] = time.time() - t0
    out["timeline"] = (
        f"{sum(b - a for a, b in spans.values()):.1f} s of builds in "
        f"{len(spans)} steps, the last ending "
        f"{max(b for _, b in spans.values()):.1f} s in, at most {most} at "
        f"once; read back in {read:.1f} s")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def round_widths(cfg, r: int) -> dict:
    """The engine widths of retry round r (0: the first pass), as
    ``CompletionIndex.complete_batch_padded`` widens them."""
    return dict(frontier=cfg.frontier * 2 ** r, gens=cfg.gens * 4 ** r,
                max_steps=cfg.max_steps * 4 ** r)


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


def check_close(name: str, what: str, got, want, tol: float,
                of_scale: bool = False) -> float:
    """Float outputs: |got - want| <= tol * (1 + |want|) elementwise, the
    kernel ``name``'s largest error kept for the kernels line.  With
    ``of_scale`` (the card against the CPU, whose caller logs the worst):
    max |got - want| <= tol * max |want|, kept nowhere.  Returns the
    error, relative to the scale with ``of_scale``."""
    import torch

    got, want = got.float(), want.float().to(got.device)
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if of_scale:
        err /= max(float(want.abs().max()), 1e-30)
        if not err <= tol:
            raise AssertionError(f"{name} {what}: card and CPU differ by "
                                 f"{err:.2e} of their scale (tolerance "
                                 f"{tol})")
        return err
    MAX_ABS_ERR[name] = max(MAX_ABS_ERR.get(name, 0.0), err)
    if not torch.allclose(got, want, rtol=tol, atol=tol):
        raise AssertionError(f"{name} {what}: kernel and plain version "
                             f"differ by {err} (tolerance {tol})")
    log(f"  {name} {what}: max |err| {err:.3g} within {tol}")
    return err


def check_topk(what: str, got, want, tol: float = 1e-5) -> None:
    """candidate_topk: scores within ``tol`` relative; ids equal except
    where the plain version's neighbouring scores lie within ``tol`` (a
    near-tie the two summation orders may break either way)."""
    import torch

    (gs, gi), (ws, wi) = got, want
    check_close("candidate_topk", what + " scores", gs, ws, tol)
    near = torch.zeros_like(wi, dtype=torch.bool)
    close = (ws[1:] - ws[:-1]).abs() <= tol * ws[1:].abs().clamp(min=1)
    near[1:] |= close
    near[:-1] |= close
    bad = (gi != wi) & ~near
    if bad.any():
        raise AssertionError(f"candidate_topk {what}: ids differ away from "
                             f"near-ties at {bad.nonzero()[:5].tolist()}")
    log(f"  candidate_topk {what} ids: equal ({int((gi != wi).sum())} "
        "swapped within near-ties)")


def graph_ms(fn, reps: int):
    """Device time of ``fn()`` with the host out: ``reps`` calls captured
    once in a CUDA graph, one replay timed by CUDA events.  (ms, None), or
    (None, the reason) where the capture fails."""
    import torch

    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):    # warm up off the default stream
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
    except Exception as err:   # reported in place of a number
        torch.cuda.synchronize()
        return None, f"{type(err).__name__}: {str(err)[:200]}"
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, None


def host_us(fn, calls: int) -> float:
    """Host microseconds per call of ``fn()`` over ``calls`` calls with no
    synchronise between them (once the launch queue fills, the host waits
    on the card, so a call longer on the card than on the host reads as
    its device time)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / calls * 1e6


def walk_queries(strings, n: int, L: int, seed: int, dev):
    """n queries of up to L bytes on the card for the prefix walk:
    prefixes of the strings, strings typed on past their end (L bytes),
    a random last byte, one byte, the empty query; every seventh row's
    qlen runs two past its characters (-1 inside qlen)."""
    import numpy as np
    import torch

    from repro_torch.core.alphabet import pad_queries

    rng = np.random.default_rng(seed)
    pool = [s.encode() if isinstance(s, str) else s
            for s in strings] or [b"abc"]
    qs = []
    for i in range(n):
        s = pool[int(rng.integers(0, len(pool)))]
        kind = i % 5
        if kind == 0:
            qs.append(s[:int(rng.integers(1, len(s) + 1))])
        elif kind == 1:
            qs.append(b" ".join([s] * (L // max(len(s), 1) + 2))[:L])
        elif kind == 2:
            qs.append(s[:int(rng.integers(0, len(s)))]
                      + bytes([int(rng.integers(1, 256))]))
        elif kind == 3:
            qs.append(s[:1])
        else:
            qs.append(b"" if i % 10 == 4 else s)
    q, ql = pad_queries(qs, L)
    ql[6::7] = np.minimum(ql[6::7] + 2, L)
    return torch.from_numpy(q).to(dev), torch.from_numpy(ql).to(dev)


def kernel_name(name: str) -> str:
    """A device event's name without its namespace, template arguments
    and parameter list."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    for sep in "<(":
        name = name.split(sep)[0]
    return name.split("::")[-1].strip()


#: the profiler annotations around a traced batch or keystroke, and
#: around a keystroke's advance alone
BATCH_WINDOW = "chip_smoke batch"
ADVANCE_WINDOW = "chip_smoke advance"


def device_events(prof, window: str | None = None) -> list:
    """A profile's device events: kernels and copies, not the device-side
    span of an annotation; with ``window``, those that start inside that
    annotation's span on the host."""
    from torch.autograd import DeviceType

    evs = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA
           and not getattr(ev, "is_user_annotation", False)
           and ev.name not in (BATCH_WINDOW, ADVANCE_WINDOW)]
    if window is None:
        return evs
    span = next(((ev.time_range.start, ev.time_range.end)
                 for ev in prof.events() if ev.name == window
                 and ev.device_type == DeviceType.CPU), None)
    if span is None:
        return []
    return [ev for ev in evs if span[0] <= ev.time_range.start <= span[1]]


def device_kernels(prof, window: str | None = None) -> dict:
    """Device events of a profile (of one annotation's span, with
    ``window``) by kernel name: (count, total us)."""
    out = {}
    for ev in device_events(prof, window):
        n, t = out.get(kernel_name(ev.name), (0, 0.0))
        out[kernel_name(ev.name)] = (
            n + 1, t + ev.time_range.end - ev.time_range.start)
    return out


def profile_calls(fn, calls: int, names: set, label: str, launched,
                  keep=lambda name: True) -> dict:
    """Device kernels (those ``keep`` passes) of ``calls`` calls of ``fn``
    under the profiler, by name: (count, total us).  Each of ``names``
    must run once a call and nothing else run.  ``launched()`` reads the
    wrapper's launch counter, which must rise by ``calls`` over the trace,
    else the check fails at once.  A trace whose counter shows every
    launch but which holds fewer events than that, of no other name, lost
    records (CUPTI has dropped one of ten, ROADMAP.md §3) and is retaken,
    twice at most; any other count fails at once."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    want = {k: calls for k in names}
    for attempt in range(3):
        before = launched()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        n_launched = launched() - before
        got = {k: v for k, v in device_kernels(prof).items() if keep(k)}
        counts = {k: n for k, (n, _) in got.items()}
        if n_launched != calls:
            raise AssertionError(f"profile {label}: the wrapper launched "
                                 f"{n_launched} times in {calls} calls")
        if counts == want:
            return got
        if not (set(counts) <= names
                and all(n <= calls for n in counts.values())) or attempt == 2:
            break
        log(f"profile {label}: the trace lost records ({counts}, "
            f"{calls} calls, {n_launched} launches counted); retaken")
    raise AssertionError(f"profile {label}: {sorted(names)} once a call, "
                         f"{calls} calls, {n_launched} launches counted, "
                         f"expected: {got}")


def batch_trace(prof, label: str, must=()) -> str:
    """The device's busy share of the ``BATCH_WINDOW`` span of a profile
    (the union of its device events' spans over the window's length) and
    device time by kernel name. Raises where the window holds no device
    event, or none of a kernel named in ``must``."""
    from torch.autograd import DeviceType

    window = [ev for ev in prof.events() if ev.name == BATCH_WINDOW
              and ev.device_type == DeviceType.CPU]
    spans = sorted((ev.time_range.start, ev.time_range.end)
                   for ev in device_events(prof))
    in_window = device_kernels(prof, BATCH_WINDOW)
    if not window or not spans or not in_window:
        raise AssertionError(f"profile {label}: no device events in the "
                             "trace")
    missing = [k for k in must if k not in in_window]
    if missing:
        raise AssertionError(f"profile {label}: no {missing} in the trace: "
                             f"{sorted(in_window)}")
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    busy, reached = 0.0, w0
    for s, e in spans:
        s, e = max(s, reached), min(e, w1)
        if e > s:
            busy += e - s
            reached = e
    return (f"window {w1 - w0:.1f} us, device busy {busy:.1f} us "
            f"({100 * busy / (w1 - w0):.1f} %), by kernel: "
            + ", ".join(f"{k} {n}x {t:.2f} us" for k, (n, t) in
                        in_window.items()))


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_bytes(idx) -> int:
    """Bytes of every tensor the index holds on the card."""
    return sum(t.numel() * t.element_size() for t in idx.tensors
               if t is not None)



# -- phase 5b: LM serving --------------------------------------------------------


def teacher_gaps(params, cfg, prompts, emitted):
    """For each request, one no-cache ``forward`` over its prompt and its
    emitted tokens (a batch, right-padded: causal attention keeps padding
    out of every earlier position): at every emitted position the logit
    of the token the server chose below that position's largest logit.
    0 where the server chose the argmax; a near-tie between the two
    dtype paths (decode's float32 stream, forward's bfloat16) shows as a
    small gap."""
    import torch

    from repro_torch.models import transformer as tf

    dev = params.embed.device
    seqs = [list(p) + list(t[:-1]) for p, t in zip(prompts, emitted)]
    toks = torch.zeros((len(seqs), max(map(len, seqs))), dtype=torch.long)
    for i, s in enumerate(seqs):
        toks[i, :len(s)] = torch.as_tensor(s)
    with torch.no_grad():
        x, _ = tf.forward(params, toks.to(dev), cfg)
        gaps = []
        for i, (p, t) in enumerate(zip(prompts, emitted)):
            pos = torch.arange(len(p) - 1, len(p) - 1 + len(t), device=dev)
            logits = (x[i, pos].float()
                      @ params.unembed.float())[:, :cfg.vocab]
            chosen = logits[torch.arange(len(t), device=dev),
                            torch.as_tensor(t, device=dev)]
            gaps.append(logits.max(-1).values - chosen)
    return torch.cat(gaps).cpu()


def serve_requests(params, cfg, prompts, n_slots, max_len, new_tokens):
    """``prompts`` through ``LMServer``: (done requests by rid, prefill
    ms of each request (to its first token on the host), wall s)."""
    import torch

    from repro_torch.serving import LMServer, Request

    server = LMServer(params, cfg, n_slots=n_slots, max_len=max_len)
    prefill_ms = []
    inner = server._prefill

    def timed_prefill(tokens, slot):
        t = time.perf_counter()
        out = inner(tokens, slot)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t) * 1e3)
        return out

    server._prefill = timed_prefill
    for i, p in enumerate(prompts):
        server.scheduler.submit(Request(rid=i, prompt=p,
                                        max_new_tokens=new_tokens))
    t = time.perf_counter()
    done = server.run()
    wall = time.perf_counter() - t
    return server, sorted(done, key=lambda r: r.rid), prefill_ms, wall


def lm_phase(dev, small: bool, counts, serve_main) -> None:
    """Phase 5b: LM serving on the card (module docstring); raises on any
    failed check."""
    import numpy as np
    import torch

    from repro_torch.configs import LM_ARCHS, get_arch
    from repro_torch.models import transformer as tf

    before = counts()
    t_phase = time.perf_counter()
    spec = get_arch(LM_ARCH)
    cfg = spec.make_config()
    n_req = LM_REQUESTS // 8 if small else LM_REQUESTS
    if small:     # a quick compile-and-check: the full width, 2 layers
        cfg = dataclasses.replace(cfg, n_layers=2)

    # (a) the full-width model behind LMServer, 128 requests over 64 lanes
    t = time.perf_counter()
    params = tf.init_lm(torch.Generator(device=dev).manual_seed(0), cfg,
                        device=dev)
    torch.cuda.synchronize()
    n_params = params.n_params()
    log(f"LM {spec.arch_id}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} query heads over {cfg.n_kv} KV heads, window "
        f"{cfg.window}: {n_params} parameters ({cfg.param_dtype}; "
        f"param_count() {cfg.param_count()}; padded vocab "
        f"{cfg.padded_vocab}), initialised on the card in "
        f"{time.perf_counter() - t:.3f} s")
    rng = np.random.default_rng(0)    # serve_lm's prompts: 8-15 tokens
    prompts = [rng.integers(0, cfg.vocab, 8 + i % 8) for i in range(n_req)]
    server, done, prefill_ms, wall = serve_requests(
        params, cfg, prompts, LM_SLOTS, LM_MAX_LEN, LM_NEW_TOKENS)
    emitted = [r.tokens for r in done]
    if len(done) != n_req or any(
            len(t) != LM_NEW_TOKENS or max(t) >= cfg.vocab or min(t) < 0
            for t in emitted):
        raise AssertionError(f"LM serving: {len(done)} of {n_req} requests "
                             f"done, token counts "
                             f"{sorted({len(t) for t in emitted})}")
    ttft = np.array([r.first_token_at - r.created for r in done]) * 1e3
    # one decode step at 64 lanes, on the server's cache, by CUDA events
    cur = torch.as_tensor(server.cur, device=dev)
    with torch.no_grad():
        step_ms = cuda_ms(lambda: tf.decode_step(params, server.cache, cur,
                                                 cfg), 5)
    gaps = teacher_gaps(params, cfg, prompts, emitted)
    if float(gaps.max()) > LM_TF_TOL:
        raise AssertionError(f"LM serving: a chosen token's logit "
                             f"{float(gaps.max()):.4f} below its position's "
                             f"largest (tolerance {LM_TF_TOL})")
    log(f"LM serving ({n_req} requests of 8-15 tokens, {LM_NEW_TOKENS} new "
        f"tokens each, {LM_SLOTS} lanes, max_len {LM_MAX_LEN}): "
        f"{n_req * LM_NEW_TOKENS / wall:.1f} tok/s over {wall:.3f} s; TTFT "
        f"mean {ttft.mean():.1f} ms, p99 {np.percentile(ttft, 99):.1f} ms; "
        f"{step_ms:.3f} ms a decode step at {LM_SLOTS} lanes (CUDA events, "
        f"5 steps); prefill {np.mean(prefill_ms):.3f} ms mean, "
        f"{np.percentile(prefill_ms, 99):.3f} p99 ({len(prefill_ms)} "
        f"prefills of one request); teacher-forced: every chosen token "
        f"within {LM_TF_TOL} of its position's largest logit (largest gap "
        f"{float(gaps.max()):.5f}; {int((gaps > 0).sum())} of {gaps.numel()}"
        f" positions not the argmax); (a) took "
        f"{time.perf_counter() - t_phase:.1f} s")
    del server
    t_phase = time.perf_counter()

    # (b) one request longer than the window: the ring wraps in prefill
    long_len = LM_LONG_PROMPT // 8 if small else LM_LONG_PROMPT
    max_len = long_len + LM_LONG_MAX_LEN - LM_LONG_PROMPT
    span = min(max_len, cfg.window)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    prompt = [np.random.default_rng(1).integers(0, cfg.vocab, long_len)]
    server, done, prefill_ms, _ = serve_requests(
        params, cfg, prompt, 1, max_len, LM_NEW_TOKENS)
    peak = torch.cuda.max_memory_allocated()
    gaps = teacher_gaps(params, cfg, prompt, [done[0].tokens])
    if len(done[0].tokens) != LM_NEW_TOKENS or float(gaps.max()) > LM_TF_TOL:
        raise AssertionError(f"LM long prompt: {len(done[0].tokens)} tokens,"
                             f" largest gap {float(gaps.max()):.4f}")
    log(f"LM long prompt ({long_len} tokens, max_len {max_len}: a ring of "
        f"{span} positions, wrapped by {long_len % span} in prefill; "
        f"{LM_NEW_TOKENS} decode steps): prefill {prefill_ms[0]:.3f} ms, "
        f"peak device memory {peak} B, {peak - resident} B above what was "
        f"resident before it (the weights and the earlier phases' "
        f"indexes); teacher-forced over "
        f"{long_len + LM_NEW_TOKENS} tokens: largest gap "
        f"{float(gaps.max()):.5f} (tolerance {LM_TF_TOL}); (b) took "
        f"{time.perf_counter() - t_phase:.1f} s")
    del server
    t_phase = time.perf_counter()

    # (c) the card against the CPU: 2 layers at full width, one numpy tree
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    part = tf.TransformerLM(cfg2, {
        "embed": params.embed, "final_ln": params.final_ln,
        "unembed": params.unembed,
        "layers": [b.tree() for b in params.blocks[:2]]})
    tree = tf.params_to_numpy(part)
    del params, part
    torch.cuda.empty_cache()
    on = {d: tf.params_from_numpy(tree, cfg2, device=d)
          for d in (dev, torch.device("cpu"))}
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 12)))
    worst = 0.0
    with torch.no_grad():
        res = {d: tf.prefill(m, toks.to(d), cfg2, 32,
                             cache_dtype=torch.float32)
               for d, m in on.items()}
        for step in range(LM_CARD_CPU_STEPS + 1):
            (lg, cg), (lc, cc) = res[dev], res[torch.device("cpu")]
            scale = max(1.0, float(lc.abs().max()))
            err = float((lg.cpu() - lc).abs().max()) / scale
            worst = max(worst, err)
            if err > LM_CARD_CPU_TOL:
                raise AssertionError(f"LM card vs CPU, step {step}: logits "
                                     f"differ by {err:.2e} of their scale")
            if step == LM_CARD_CPU_STEPS:
                break
            nxt = lc.argmax(-1)
            res = {d: tf.decode_step(m, res[d][1], nxt.to(d), cfg2)
                   for d, m in on.items()}
    log(f"LM card vs CPU ({cfg2.n_layers} layers at full width, one numpy "
        f"tree on both): prefill of 2 x 12 tokens and "
        f"{LM_CARD_CPU_STEPS} decode steps, logits within {worst:.2e} of "
        f"their scale (tolerance {LM_CARD_CPU_TOL}); torch matmul "
        f"precision {torch.get_float32_matmul_precision()!r}; (c) took "
        f"{time.perf_counter() - t_phase:.1f} s")
    del on, tree
    t_phase = time.perf_counter()

    # (d) the launcher's LM mode for every LM arch (smoke configs), then
    # granite-moe at full width behind LMServer
    for arch in LM_ARCHS:
        out = serve_main(["--arch", arch, "--queries", str(LM_LAUNCH_QUERIES),
                          "--batch", str(LM_LAUNCH_BATCH)])
        if (out["requests"], out["tokens"]) != (
                LM_LAUNCH_QUERIES, LM_LAUNCH_QUERIES * LM_NEW_TOKENS):
            raise AssertionError(f"launcher {arch}: {out}")
    spec_g = get_arch(LM_MOE_ARCH)
    cfg_g = spec_g.make_config()
    if small:
        cfg_g = dataclasses.replace(cfg_g, n_layers=2)
    t = time.perf_counter()
    params = tf.init_lm(torch.Generator(device=dev).manual_seed(0), cfg_g,
                        device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg_g.vocab, 8 + i % 8)
               for i in range(LM_MOE_REQUESTS)]
    _, done, _, wall = serve_requests(params, cfg_g, prompts,
                                      LM_MOE_REQUESTS, LM_MAX_LEN,
                                      LM_NEW_TOKENS)
    emitted = [r.tokens for r in done]
    finite = bool(torch.isfinite(teacher_gaps(params, cfg_g, prompts,
                                              emitted)).all())
    if len(done) != LM_MOE_REQUESTS or not finite or any(
            len(t) != LM_NEW_TOKENS or max(t) >= cfg_g.vocab for t in emitted):
        raise AssertionError(f"LM {spec_g.arch_id}: {len(done)} requests, "
                             f"finite logits {finite}")
    log(f"LM {spec_g.arch_id} at full width ({cfg_g.n_layers} layers, "
        f"{cfg_g.moe_experts} experts top-{cfg_g.moe_top_k}, "
        f"{params.n_params()} parameters, initialised in {init_s:.3f} s): "
        f"{LM_MOE_REQUESTS} requests, {LM_MOE_REQUESTS * LM_NEW_TOKENS} "
        f"tokens, all < vocab {cfg_g.vocab}, logits finite; "
        f"{LM_MOE_REQUESTS * LM_NEW_TOKENS / wall:.1f} tok/s; (d) took "
        f"{time.perf_counter() - t_phase:.1f} s")
    del params
    torch.cuda.empty_cache()
    if counts() != before:
        raise AssertionError("the LM phase launched a completion kernel")


# -- phase 5c: the recsys and GNN models ------------------------------------------


def rec_batch(arch: str, cfg, batch: int, dev, step: int = 0) -> dict:
    """A ``ClickStream`` batch (seed 0, at ``step``) of the arch's serving
    inputs on ``dev``: DLRM's dense and sparse features, the sequence
    archs' history (-1 padded) and target."""
    import torch

    from repro_torch.data.recsys import ClickStream, RecsysDataConfig

    stream = ClickStream(RecsysDataConfig(
        n_items=cfg.vocab, seq_len=getattr(cfg, "seq_len", 50), batch=batch),
        start_step=step)
    b = stream.next_dlrm() if arch == "dlrm-rm2" else stream.next_seq()
    keys = ("dense", "sparse") if arch == "dlrm-rm2" else ("hist", "target")
    return {k: torch.from_numpy(b[k]).to(dev) for k in keys}


def check_retrieval(what: str, scores, ids, n_cands: int, k: int) -> None:
    """Retrieval answers: k per row, finite, score-descending, distinct
    ids below C."""
    ok = (scores.shape[-1] == ids.shape[-1] == k
          and bool(scores.isfinite().all())
          and bool((scores[:, :-1] >= scores[:, 1:]).all())
          and bool(((ids >= 0) & (ids < n_cands)).all())
          and all(int(r.unique().numel()) == k for r in ids))
    if not ok:
        raise AssertionError(f"{what}: malformed retrieval answers")


def models_phase(dev, small: bool, reset_counts, counts, serve_main,
                 products) -> dict:
    """Phase 5c: the recsys and GNN models' serving half on the card
    (module docstring); raises on any failed check.  ``products`` is
    ogb_products' graph (src, dst, feats) from a phase-2 worker.  Returns
    the models' launches of rows 12-13 and phase 6's inputs at the model
    widths."""
    import contextlib
    import io
    import runpy

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data.graph import make_molecule_batch, make_random_graph
    from repro_torch.kernels import candidate_topk, embedding_bag
    from repro_torch.models import gnn, recsys

    t_phase = time.perf_counter()
    out = {"launches": {}}
    cpu = torch.device("cpu")

    def peak_line(resident):
        return (f"peak {torch.cuda.max_memory_allocated() - resident} B "
                "above the resident")

    # (a), (b): each recsys arch at full width through its serving forward
    # and its retrieval cell, the launches of rows 12-13 counted
    keep = {}
    reset_counts()
    for arch in REC_ARCHS:
        spec = get_arch(arch)
        cfg = spec.make_config()
        if small:
            cfg = dataclasses.replace(cfg, vocab=REC_SMALL_VOCAB)
        fns = recsys.ARCHS[type(cfg)]
        init, fwd, user_fn = fns.init, fns.forward, fns.user
        t = time.perf_counter()
        params = init(torch.Generator(device=dev).manual_seed(0), cfg,
                      device=dev)
        torch.cuda.synchronize()
        log(f"recsys {arch}: {params.n_params()} parameters (vocab "
            f"{cfg.vocab}), initialised on the card in "
            f"{time.perf_counter() - t:.3f} s")
        cells = ("serve_p99", "retrieval_cand") + (
            ("serve_bulk",) if arch == "dlrm-rm2" else ())
        for cell in cells:
            B = spec.shapes[cell].params["batch"]
            if small:
                B = min(B, 4096)
            if arch == "sasrec" and cell == "retrieval_cand":
                # repro's SASRec user is the last position, zero for every
                # history shorter than seq_len (ClickStream pads at the
                # end): the cell takes the stream's first full history
                pool = rec_batch(arch, cfg, 512, dev)
                full = (pool["hist"][:, -1] >= 0).nonzero()[:B, 0]
                if full.numel() < B:
                    raise AssertionError("sasrec retrieval_cand: no full-"
                                         "length history in 512 rows")
                batch = {k: v[full] for k, v in pool.items()}
            else:
                batch = rec_batch(arch, cfg, B, dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            if cell == "retrieval_cand":
                n_c = min(spec.shapes[cell].params["n_candidates"], cfg.vocab)
                cands = recsys.candidates(params, n_c)

                def call():
                    return recsys.retrieval_topk(user_fn(params, batch, cfg),
                                                 cands, RETRIEVAL_K)
            else:
                def call():
                    return fwd(params, batch, cfg)
            got = call()
            torch.cuda.synchronize()
            keep.setdefault(arch, {"params": params})[cell] = batch
            if cell == "retrieval_cand":
                check_retrieval(f"{arch} {cell}", *got, n_c, RETRIEVAL_K)
                shape = f"B={B} C={n_c} k={RETRIEVAL_K}"
                keep[arch]["cands"] = cands
            else:
                want = (B,) if arch in ("dlrm-rm2", "din") else \
                    (B, cfg.n_interests, cfg.d_embed) if arch == "mind" \
                    else (B, cfg.d_embed)
                if tuple(got.shape) != want or not bool(got.isfinite().all()):
                    raise AssertionError(f"{arch} {cell}: output "
                                         f"{tuple(got.shape)}, expected "
                                         f"{want}, finite")
                shape = f"B={B}"
            reps = 3 if cell == "serve_bulk" else 10
            ms = cuda_ms(call, reps)
            log(f"recsys {arch} {cell} ({shape}): {ms:.4f} ms a call "
                f"(CUDA events, {reps} calls), {B / ms * 1e3:.0f} rows/s, "
                + peak_line(resident))
        if arch == "dlrm-rm2":    # the tables' 6.66 GB, before the GNN
            del params, batch, cands, got
            keep.pop(arch)
            torch.cuda.empty_cache()
    c = counts()
    for name in ("candidate_topk", "embedding_bag"):
        if c[name] <= 0:
            raise AssertionError(f"recsys models: {name} never launched")
        out["launches"][name] = c[name]
    if c["plain"]:
        raise AssertionError("recsys models: a plain version ran")
    others = {k: v for k, v in c.items()
              if k not in ("candidate_topk", "embedding_bag", "plain",
                           "widths") and v}
    if others:
        raise AssertionError(f"recsys models launched {others}")
    log(f"recsys models' launches: {out['launches']} ((a)-(b) took "
        f"{time.perf_counter() - t_phase:.1f} s)")
    t_part = time.perf_counter()

    # (c) the kernels against their plain versions on the models' tensors:
    # candidate_topk at DLRM's (the DIN and SASRec widths kept for phase
    # 6), DIN's and SASRec's retrieval shapes, on the user row and on a
    # random query; DIN's pooled history through embedding_bag_dense
    gen = torch.Generator(device=dev).manual_seed(7)
    dlrm_cfg = get_arch("dlrm-rm2").make_config()
    n_c = REC_SMALL_VOCAB if small else dlrm_cfg.vocab
    dlrm_cands = torch.randn(n_c, dlrm_cfg.d_embed, generator=gen,
                             device=dev) * dlrm_cfg.d_embed ** -0.5
    user = {"dlrm-rm2": None}
    for arch in ("din", "sasrec"):
        params = keep[arch]["params"]
        user[arch] = recsys.ARCHS[type(params.cfg)].user(
            params, keep[arch]["retrieval_cand"], params.cfg)[0]
        if not bool(user[arch].abs().max() > 0):
            raise AssertionError(f"{arch} retrieval_cand: the user row is "
                                 "zero, all candidates tie")
    log("retrieval_cand user rows: max |x| "
        + ", ".join(f"{a} {float(u.abs().max()):.3g}"
                    for a, u in user.items() if u is not None))
    for arch, cands in (("dlrm-rm2", dlrm_cands),
                        ("din", keep["din"]["cands"]),
                        ("sasrec", keep["sasrec"]["cands"])):
        d = cands.shape[1]
        queries = [("a random query", torch.randn(d, generator=gen,
                                                  device=dev))]
        if user[arch] is not None:
            queries.append(("the user row", user[arch].contiguous()))
        for label, q in queries:
            check_topk(f"{arch} retrieval C={cands.shape[0]} D={d} "
                       f"k={RETRIEVAL_K}, {label}",
                       candidate_topk.candidate_topk(q, cands, RETRIEVAL_K),
                       candidate_topk.candidate_topk_plain(q, cands,
                                                           RETRIEVAL_K))
    del dlrm_cands
    din_params = keep["din"]["params"]
    bag, weights, _ = recsys.din_history_weights(
        din_params, keep["din"]["serve_p99"], din_params.cfg)
    check_close("embedding_bag", f"DIN's pooled history {list(bag.shape)} "
                f"over items {list(din_params.items.shape)}",
                embedding_bag.embedding_bag_dense(din_params.items, bag,
                                                  weights),
                embedding_bag.embedding_bag_dense_plain(din_params.items,
                                                        bag, weights), 1e-5)
    out["din"] = (din_params.items.detach(), bag, weights)
    out["cands"] = {arch: (keep[arch]["cands"], user[arch].contiguous())
                    for arch in ("din", "sasrec")}
    del keep
    log(f"(c) took {time.perf_counter() - t_part:.1f} s")
    t_part = time.perf_counter()

    # (d) gin-tu at full width on three of its shape cells
    spec = get_arch("gin-tu")
    for cell in ("full_graph_sm", "molecule", "ogb_products"):
        p = dict(spec.shapes[cell].params)
        cfg = dataclasses.replace(spec.make_config(), d_feat=p["d_feat"],
                                  n_classes=p["n_classes"])
        params = gnn.init_gin(torch.Generator(device=dev).manual_seed(0), cfg,
                              device=dev)
        t = time.perf_counter()
        if cell == "molecule":
            mb = make_molecule_batch(p["batch"], p["n_nodes"], p["n_edges"],
                                     p["d_feat"], p["n_classes"])
            args = [torch.from_numpy(mb[k]).to(dev)
                    for k in ("feats", "src", "dst")]
            rows, want = p["batch"], (p["batch"], p["n_classes"])
        else:
            if cell == "ogb_products":
                src, dst, feats = products
                n, e = int(feats.shape[0]), int(src.shape[0])
            else:
                g = make_random_graph(p["n_nodes"], p["n_edges"], p["d_feat"],
                                      p["n_classes"], build_csr=False)
                src, dst, feats = g.src, g.dst, g.feats
                n, e = p["n_nodes"], p["n_edges"]
            args = [torch.from_numpy(np.asarray(a)).to(dev)
                    for a in (feats, src, dst)]
            rows, want = n, (n, p["n_classes"])
        torch.cuda.synchronize()
        onto = time.perf_counter() - t
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        got = params(*args)
        torch.cuda.synchronize()
        if tuple(got.shape) != want or not bool(got.isfinite().all()):
            raise AssertionError(f"gin-tu {cell}: output {tuple(got.shape)}, "
                                 f"expected {want}, finite")
        line = peak_line(resident)
        del got
        reps = 2 if cell == "ogb_products" else 10
        ms = cuda_ms(lambda: params(*args), reps)
        log(f"gin-tu {cell} ({cfg.n_layers} layers, d_hidden "
            f"{cfg.d_hidden}, d_feat {cfg.d_feat}; "
            + (f"{p['batch']} graphs of {p['n_nodes']} nodes and "
               f"{p['n_edges']} edges" if cell == "molecule" else
               f"{rows} nodes, {e} edges")
            + f"; onto the card {onto:.3f} s): {ms:.4f} ms a forward (CUDA "
            f"events, {reps} calls), {rows / ms * 1e3:.0f} "
            f"{'graphs' if cell == 'molecule' else 'nodes'}/s, {line}")
        del args, params
        torch.cuda.empty_cache()
    log(f"(d) took {time.perf_counter() - t_part:.1f} s")
    t_part = time.perf_counter()

    # (e) the card against the CPU: the five archs at their smoke configs,
    # one numpy tree through params_from_numpy on each device
    worst = {}
    for arch in REC_ARCHS:
        cfg = get_arch(arch).make_smoke_config()
        fns = recsys.ARCHS[type(cfg)]
        init, fwd, user_fn = fns.init, fns.forward, fns.user
        tree = recsys.params_to_numpy(init(torch.Generator().manual_seed(1),
                                           cfg, device=cpu))
        res = {}
        for d in (dev, cpu):
            m = recsys.params_from_numpy(tree, cfg, device=d)
            b = rec_batch(arch, cfg, 64, d, step=3)
            u = user_fn(m, b, cfg)
            res[d] = (fwd(m, b, cfg), u, *recsys.retrieval_topk(
                u, recsys.candidates(m, cfg.vocab), 10))
        (fg, ug, sg, ig), (fc, uc, sc, ic) = res[dev], res[cpu]
        worst[arch] = max(check_close(arch, w, g, c, CARD_CPU_TOL, True)
                          for w, g, c in (("forward", fg, fc),
                                          ("user", ug, uc),
                                          ("retrieval scores", sg, sc)))
        near = torch.zeros_like(ic, dtype=torch.bool)
        tie = (sc[:, 1:] - sc[:, :-1]).abs() <= CARD_CPU_TOL * max(
            float(sc.abs().max()), 1e-30)
        near[:, 1:] |= tie
        near[:, :-1] |= tie
        if bool(((ig.cpu() != ic) & ~near).any()):
            raise AssertionError(f"{arch}: card and CPU retrieve other ids "
                                 "away from near-ties")
    cfg = get_arch("gin-tu").make_smoke_config()
    tree = gnn.params_to_numpy(gnn.init_gin(torch.Generator().manual_seed(1),
                                            cfg, device=cpu))
    g = make_random_graph(500, 3000, cfg.d_feat, cfg.n_classes, seed=2,
                          build_csr=False)
    g.src[::17] = -1
    mb = make_molecule_batch(16, 30, 64, cfg.d_feat, cfg.n_classes, seed=2)
    res = {}
    for d in (dev, cpu):
        m = gnn.params_from_numpy(tree, cfg, device=d)
        res[d] = [m(*(torch.from_numpy(a).to(d) for a in args))
                  for args in ((g.feats, g.src, g.dst),
                               (mb["feats"], mb["src"], mb["dst"]))]
    worst["gin-tu"] = max(
        check_close("gin-tu", w, gc, cc, CARD_CPU_TOL, True)
        for w, gc, cc in zip(("full graph", "molecules"), res[dev], res[cpu]))
    log("card vs CPU at the smoke configs (one numpy tree on both; forward, "
        "user embedding, retrieval scores; GIN full graph with -1 edges and "
        "molecules): relative errors "
        + ", ".join(f"{a} {e:.2e}" for a, e in worst.items())
        + f" (tolerance {CARD_CPU_TOL}); (e) took "
        f"{time.perf_counter() - t_part:.1f} s")
    t_part = time.perf_counter()

    # (f) the reranking example on the card (its lines equal the CPU's),
    # and the launcher's recsys and GNN archs
    lines = {}
    for argv in ([], ["--device", "cpu"]):
        buf = io.StringIO()
        saved_argv = sys.argv
        sys.argv = ["torch_autocomplete_rerank.py"] + argv
        with contextlib.redirect_stdout(buf):
            runpy.run_path(str(ROOT / "examples" /
                               "torch_autocomplete_rerank.py"),
                           run_name="__main__")
        sys.argv = saved_argv
        lines[bool(argv)] = buf.getvalue().splitlines()
    if lines[False] != lines[True] or len(lines[False]) != 12:
        raise AssertionError(f"the reranking example on the card printed "
                             f"{lines[False]}, on the CPU {lines[True]}")
    for arch, family in (("sasrec", "recsys"), ("gin-tu", "gnn")):
        try:
            serve_main(["--arch", arch])
        except SystemExit as err:
            msg = str(err)
        else:
            raise AssertionError(f"the launcher served {arch}")
        if msg != f"no serve mode for family {family}":
            raise AssertionError(f"the launcher's --arch {arch}: {msg!r}")
        log(f"launcher --arch {arch}: exits with {msg!r}, as repro's")
    log(f"reranking example on the card: {len(lines[False])} lines, equal "
        f"to the CPU's (first: {lines[False][0].strip()!r}); (f) took "
        f"{time.perf_counter() - t_part:.1f} s")
    log(f"phase 5c took {time.perf_counter() - t_phase:.1f} s")
    return out


# -- phase 5d: training ----------------------------------------------------------


def launch_train(train_main, arch: str, device: str, ckpt: str, steps: int):
    """The training launcher's ``main`` at ``arch``'s smoke config, its
    output captured: (its JSON dict, its printed lines)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = train_main(["--arch", arch, "--steps", str(steps), "--batch",
                          "4", "--seq", "32", "--ckpt-dir", ckpt,
                          "--ckpt-every", str(steps), "--log-every", "1",
                          "--device", device])
    return res, buf.getvalue().splitlines()


def timed_steps(step, params, opt, batches) -> tuple[list, list]:
    """``step`` over ``batches``: (losses, ms a step on the host clock, each
    step ended by a synchronise)."""
    import torch

    losses, ms = [], []
    for b in batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, _, m = step(params, opt, b)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    return losses, ms


def check_losses(what: str, losses, near: float | None = None,
                 same_batch: bool = True) -> None:
    """Every loss finite; on one batch repeated, the last no higher than
    the first plus ``TRAIN_LOSS_RISE``; the first within
    ``TRAIN_FIRST_LOSS_SPAN`` of ``near``."""
    import math

    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{what}: a loss is not finite: {losses}")
    if same_batch and losses[-1] > losses[0] + TRAIN_LOSS_RISE:
        raise AssertionError(f"{what}: the loss rose from {losses[0]} to "
                             f"{losses[-1]}")
    if near is not None and abs(losses[0] - near) > TRAIN_FIRST_LOSS_SPAN:
        raise AssertionError(f"{what}: the first loss {losses[0]} is not "
                             f"within {TRAIN_FIRST_LOSS_SPAN} of {near}")


def step_profile(fn, label: str, must=(), top: int = 8) -> str:
    """One call of ``fn`` traced by the profiler: the device's busy share
    of its window, its device time and the ``top`` kernels by device
    time.  Raises where the trace is empty or lacks a kernel of
    ``must``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(BATCH_WINDOW):
            fn()
            torch.cuda.synchronize()
    head = batch_trace(prof, label, must).partition(", by kernel: ")[0]
    kernels = device_kernels(prof, BATCH_WINDOW)
    total = sum(t for _, t in kernels.values())
    most = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:top]
    return (f"{head}, device time {total:.1f} us in {len(kernels)} kernel "
            "names; the most: " + ", ".join(
                f"{k} {n}x {t:.1f} us ({100 * t / total:.1f} %)"
                for k, (n, t) in most))


def training_phase(dev, small: bool, reset_counts, counts,
                   train_main) -> dict:
    """Phase 5d: training on the card (module docstring); raises on any
    failed check.  Returns the launches of row 13's kernels in the
    training runs and the bag backward's row of the kernels line."""
    import contextlib
    import io
    import math
    import os
    import runpy
    import shutil

    import numpy as np
    import torch

    from repro_torch.configs import ASSIGNED, get_arch
    from repro_torch.configs.cells import make_train_step
    from repro_torch.data.lm import LMDataConfig, TokenStream
    from repro_torch.data.recsys import ClickStream, RecsysDataConfig
    from repro_torch.kernels import embedding_bag
    from repro_torch.models import recsys
    from repro_torch.models import transformer as tf
    from repro_torch.optim import grad_tree, init_optimizer
    from repro_torch.optim.optimizers import leaves

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    torch.cuda.empty_cache()
    log(f"training: {torch.cuda.memory_allocated()} B resident before it "
        "(the indexes)")

    # the training runs, their launches counted: (a) danube at full width
    reset_counts()
    spec = get_arch(LM_ARCH)
    cfg = spec.make_config()
    seq = TRAIN_SEQ
    if small:
        cfg, seq = dataclasses.replace(cfg, n_layers=2), TRAIN_SEQ // 4
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t = time.perf_counter()
    params = tf.init_lm(torch.Generator(device=dev).manual_seed(0), cfg,
                        device=dev)
    opt = init_optimizer(spec.optimizer, params)
    step = make_train_step(tf.loss_fn, cfg, spec.optimizer)
    raw = TokenStream(LMDataConfig(vocab=cfg.vocab, seq_len=seq,
                                   global_batch=TRAIN_BATCH)).next_batch()
    batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    losses, ms = timed_steps(step, params, opt, [batch] * TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated()
    check_losses(f"train {LM_ARCH}", losses, math.log(cfg.vocab))
    tokens = TRAIN_BATCH * seq
    out = {"lm": {"ms": ms, "losses": losses, "peak": peak - resident}}
    log(f"train {LM_ARCH} at full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {params.n_params()} parameters; float32 weights "
        f"and AdamW state, {cfg.activation_dtype} activations, remat "
        f"{cfg.remat}; made in {init_s:.3f} s): {TRAIN_STEPS} steps on one "
        f"TokenStream batch of {TRAIN_BATCH} x {seq}: losses "
        f"{[round(x, 6) for x in losses]} (ln vocab {math.log(cfg.vocab):.4f}"
        f"); ms a step {[round(x, 3) for x in ms]} (host clock, "
        f"synchronised; the first compiles nothing but warms the "
        f"allocator); {tokens / ms[-1] * 1e3:.1f} tokens/s at the last; "
        f"peak {peak - resident} B above the resident")
    log(f"train {LM_ARCH}, a fourth step traced: " + step_profile(
        lambda: step(params, opt, batch), f"train {LM_ARCH}"))
    del params, opt, step, batch
    torch.cuda.empty_cache()

    # (b) DIN at its published config on train_batch
    spec = get_arch("din")
    cfg = spec.make_config()
    B = spec.shapes["train_batch"].params["batch"]
    if small:
        cfg, B = dataclasses.replace(cfg, vocab=REC_SMALL_VOCAB), 4096
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    din = recsys.init_din(torch.Generator(device=dev).manual_seed(0), cfg,
                          device=dev)
    opt = init_optimizer(spec.optimizer, din)
    step = make_train_step(recsys.din_loss, cfg, spec.optimizer)
    t = time.perf_counter()
    raw = ClickStream(RecsysDataConfig(n_items=cfg.vocab, batch=B,
                                       seq_len=cfg.seq_len)).next_seq()
    draw_s = time.perf_counter() - t
    batch = {k: torch.from_numpy(raw[k]).to(dev)
             for k in ("hist", "target", "label")}
    losses, ms = timed_steps(step, din, opt, [batch] * TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated()
    check_losses("train din", losses)
    out["din"] = {"ms": ms, "losses": losses, "peak": peak - resident}
    log(f"train din at its published config (items {cfg.vocab} x "
        f"{cfg.d_embed}, T={cfg.seq_len}) on train_batch (B={B}; the "
        f"ClickStream batch drawn in {draw_s:.3f} s): losses "
        f"{[round(x, 6) for x in losses]}; ms a step "
        f"{[round(x, 3) for x in ms]}; {B / ms[-1] * 1e3:.0f} rows/s at the "
        f"last; peak {peak - resident} B above the resident")
    log("train din, a fourth step traced: " + step_profile(
        lambda: step(din, opt, batch), "train din",
        must=("embedding_bag_kernel", "embedding_bag_backward_kernel")))
    del opt, step

    # (c) the ten archs' smoke configs through the launcher on the card,
    # (d) a restart from the launcher's checkpoint, (e) the example
    first = {}
    for arch in ASSIGNED:
        res, _ = launch_train(train_main, arch, "cuda",
                              os.path.join(tmp, "card"), TRAIN_LAUNCH_STEPS)
        check_losses(f"launcher {arch}", [res["first_loss"],
                                          res["last_loss"]],
                     same_batch=False)   # a new batch each step
        first[arch] = res["first_loss"]
    ckpt = os.path.join(tmp, "restart")
    launch_train(train_main, "din", "cuda", ckpt, TRAIN_LAUNCH_STEPS)
    res, lines = launch_train(train_main, "din", "cuda", ckpt,
                              TRAIN_LAUNCH_STEPS + 2)
    resumed = [x.split()[1] for x in lines if x.startswith("step ")]
    if resumed != [str(TRAIN_LAUNCH_STEPS), str(TRAIN_LAUNCH_STEPS + 1)] \
            or f"step_{TRAIN_LAUNCH_STEPS + 2:08d}" not in os.listdir(
                os.path.join(ckpt, "din")):
        raise AssertionError(f"launcher restart: steps run {resumed}")
    log(f"launcher restart: din resumed from the checkpoint of step "
        f"{TRAIN_LAUNCH_STEPS} and ran steps {resumed}")
    buf = io.StringIO()
    saved_argv = sys.argv
    sys.argv = ["torch_train_lm.py", "--steps", str(TRAIN_EXAMPLE_STEPS),
                "--ckpt", os.path.join(tmp, "example")]
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        runpy.run_path(str(ROOT / "examples" / "torch_train_lm.py"),
                       run_name="__main__")
    sys.argv = saved_argv
    example = buf.getvalue().splitlines()
    log(f"examples/torch_train_lm.py --steps {TRAIN_EXAMPLE_STEPS} on the "
        f"card ({time.perf_counter() - t:.1f} s): {example[0]!r}, "
        f"{example[-1]!r}")
    c = counts()
    for name in ("embedding_bag", "embedding_bag_backward"):
        if c[name] <= 0:
            raise AssertionError(f"training: {name} never launched")
    if c["plain"]:
        raise AssertionError("training: a plain version ran")
    others = {k: v for k, v in c.items()
              if k not in ("embedding_bag", "embedding_bag_backward",
                           "plain", "widths") and v}
    if others:
        raise AssertionError(f"training launched {others}")
    out["launches"] = {k: c[k] for k in ("embedding_bag",
                                         "embedding_bag_backward")}
    log(f"training runs' launches: {out['launches']} ((a)-(e) took "
        f"{time.perf_counter() - t_phase:.1f} s)")
    t_part = time.perf_counter()

    # the card against the CPU: the launcher's first losses, then one
    # step's loss and gradients of danube at 2 layers of full width
    worst = {}
    for arch in ASSIGNED:
        res, _ = launch_train(train_main, arch, "cpu",
                              os.path.join(tmp, "cpu"), 1)
        err = abs(first[arch] - res["first_loss"]) / max(
            abs(res["first_loss"]), 1e-30)
        if err > CARD_CPU_TOL:
            raise AssertionError(f"launcher {arch}: first loss on the card "
                                 f"{first[arch]}, on the CPU "
                                 f"{res['first_loss']}")
        worst[arch] = err
    log("launcher card vs CPU, first loss (one host-drawn tree on both): "
        "relative errors " + ", ".join(f"{a} {e:.2e}"
                                       for a, e in worst.items())
        + f" (tolerance {CARD_CPU_TOL})")
    cfg2 = dataclasses.replace(get_arch(LM_ARCH).make_config(), n_layers=2)
    tree = tf.params_to_numpy(tf.init_lm(torch.Generator().manual_seed(1),
                                         cfg2, device=cpu))
    b, s_ = TRAIN_CARD_CPU_TOKENS
    raw = TokenStream(LMDataConfig(vocab=cfg2.vocab, seq_len=s_,
                                   global_batch=b)).next_batch()
    res = {}
    for d in (dev, cpu):
        m = tf.params_from_numpy(tree, cfg2, device=d).requires_grad_(True)
        loss, _ = tf.loss_fn(m, {k: torch.from_numpy(v).to(d)
                                 for k, v in raw.items()}, cfg2)
        loss.backward()
        res[d] = (loss.detach().cpu(),
                  [(torch.stack(g) if isinstance(g, tuple) else g).cpu()
                   for g in leaves(grad_tree(m))])
        del m
    del tree
    errs = [check_close(LM_ARCH, "2-layer loss", res[dev][0], res[cpu][0],
                        LM_CARD_CPU_TOL, of_scale=True)]
    for i, (g_card, g_cpu) in enumerate(zip(res[dev][1], res[cpu][1])):
        errs.append(check_close(LM_ARCH, f"2-layer gradient leaf {i}",
                                g_card, g_cpu, LM_CARD_CPU_TOL, True))
    log(f"train {LM_ARCH} card vs CPU ({cfg2.n_layers} layers at full "
        f"width, one host-drawn tree, {b} x {s_} tokens): loss "
        f"{float(res[cpu][0]):.6f}, loss and {len(errs) - 1} gradient "
        f"leaves within {max(errs):.2e} of their scale (tolerance "
        f"{LM_CARD_CPU_TOL}); torch matmul precision "
        f"{torch.get_float32_matmul_precision()!r}")
    del res

    # the bag's two kernels against their plain versions on DIN's
    # train_batch, and DIN's gradients through the pooled history
    items = din.items.detach()
    with torch.no_grad():
        bag, w, _ = recsys.din_history_weights(din, batch, cfg)
    g = torch.randn((bag.shape[0], items.shape[1]),
                    generator=torch.Generator(device=dev).manual_seed(5),
                    device=dev)
    check_close("embedding_bag", f"DIN train_batch {list(bag.shape)} "
                "forward", embedding_bag.embedding_bag_dense(items, bag, w),
                embedding_bag.embedding_bag_dense_plain(items, bag, w), 1e-5)
    d_items, d_w = embedding_bag._run_backward(items, bag, w, g, "sum", True,
                                               True)
    p_items, p_w = embedding_bag.embedding_bag_dense_backward_plain(
        items, bag, w, g, "sum")
    err_items = check_close("embedding_bag_backward", "d_items", d_items,
                            p_items, BAG_GRAD_TOL, of_scale=True)
    err_w = check_close("embedding_bag_backward", "d_weights", d_w, p_w,
                        BAG_GRAD_TOL, of_scale=True)
    MAX_ABS_ERR["embedding_bag_backward"] = max(
        float((d_items - p_items).abs().max()), float((d_w - p_w).abs().max()))
    valid = bag >= 0
    rows = bag.clamp(min=0).long()
    f32 = torch.zeros_like(items).index_add_(
        0, rows.reshape(-1), (torch.where(valid, w, 0.0)[..., None]
                              * g[:, None, :]).reshape(-1, items.shape[1]))
    f32_err = float((f32 - p_items).abs().max()) / float(
        p_items.abs().max())
    hot = int(torch.bincount(bag[valid].long()).max())
    log(f"embedding_bag_backward on DIN's train_batch: d_items within "
        f"{err_items:.2e}, d_weights within {err_w:.2e} of their scale "
        f"(tolerance {BAG_GRAD_TOL}); the hottest row takes {hot} entries, "
        f"and a float32 index_add_ of the same products lies {f32_err:.2e} "
        "of the scale from the float64 sums")
    din.zero_grad(set_to_none=True)
    loss, _ = recsys.din_loss(din, batch, cfg)
    loss.backward()
    attn = max(float(p.grad.abs().max()) for p in din.attn.parameters())
    if not attn > 0 or not float(din.items.grad.abs().max()) > 0 \
            or not float(d_items.abs().max()) > 0:
        raise AssertionError("DIN on the card: no gradient through the "
                             "pooled history")
    log(f"DIN's loss on the card: attention MLP gradients up to {attn:.3e} "
        "(they reach the loss only through the bag's d_weights), item "
        f"table up to {float(din.items.grad.abs().max()):.3e}")

    # the backward's row of the kernels line at DIN's train_batch
    n_valid = int(valid.sum())
    n_rows = int(torch.unique(bag[valid]).numel())
    V, D = items.shape
    bag_lib, items_l = rows, items.clone().requires_grad_(True)
    w_l = w.clone().requires_grad_(True)

    def kern():
        return embedding_bag._run_backward(items, bag, w, g, "sum", True,
                                           True)

    # the library's backward alone: its forward runs once, outside the
    # timed calls
    lib_out = torch.nn.functional.embedding_bag(
        bag_lib, items_l, mode="sum", per_sample_weights=w_l)

    def library():
        return torch.autograd.grad(lib_out, (items_l, w_l), g,
                                   retain_graph=True)

    # the distinct rows read once, the indices, weights and g read once,
    # d_weights and d_items written once; a multiply-add per value for the
    # dot and one for the scaled add
    nbytes = (n_rows * D * 4 + bag.numel() * 8 + g.numel() * 4
              + d_w.numel() * 4 + V * D * 4)
    n_ops = 4 * n_valid * D
    bound_ms, bound_by = bound(nbytes, n_ops)
    ms = cuda_ms(kern, 20)
    g_ms, why = graph_ms(kern, 20)
    plain_ms = cuda_ms(
        lambda: embedding_bag.embedding_bag_dense_backward_plain(
            items, bag, w, g, "sum"), 3)
    library_ms = cuda_ms(library, 20)
    fwd_ms = cuda_ms(lambda: embedding_bag.embedding_bag_dense(items, bag, w),
                     20)
    out["row"] = {
        "name": "embedding_bag_backward", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/embedding_bag.cu",
        "replaces": "src/repro/kernels/embedding_bag.py:41",
        "max_abs_err": MAX_ABS_ERR["embedding_bag_backward"], "ms": ms,
        "graph_ms": g_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms,
        "shape": f"DIN train_batch {list(bag.shape)} over items [{V}, {D}]"}
    log(f"time embedding_bag_backward at DIN's train_batch {list(bag.shape)}"
        f" over items [{V}, {D}] ({n_valid} valid entries, {n_rows} "
        f"distinct rows): {ms:.4f} ms back to back, "
        + (f"{g_ms:.4f} ms in a CUDA graph" if why is None
           else f"not measured in a CUDA graph ({why})")
        + f", {plain_ms:.4f} ms plain, library (F.embedding_bag's "
        f"backward) {library_ms:.4f} ms, bound {bound_ms:.6f} ms "
        f"({bound_by}, {nbytes} B, {n_ops} ops); the forward kernel there "
        f"{fwd_ms:.4f} ms")
    del din, batch, items, items_l, w_l, lib_out, d_items, p_items, f32
    torch.cuda.empty_cache()
    shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 5d took {time.perf_counter() - t_phase:.1f} s (comparisons "
        f"and timing {time.perf_counter() - t_part:.1f} s)")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="small corpora: a quick compile-and-check run")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from dataclasses import replace

    from torch.profiler import ProfilerActivity, profile, record_function

    import repro_torch as rt
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.core.alphabet import pad_queries
    from repro_torch.core.engine import beam, cached, locus
    from repro_torch.core.distributed import shard_strings
    from repro_torch.core.engine.substrate import get_substrate
    from repro_torch.core.trie_build import make_rules
    from repro_torch.data.strings import (make_dblp, make_keystroke_events,
                                          make_usps, make_workload)
    from repro_torch.kernels import (_build, beam_topk, candidate_topk,
                                     embedding_bag, locus_dp, locus_merge,
                                     ops, topk_select, trie_walk)
    from repro_torch.launch.serve import (_replay_batched,
                                          _replay_sequential, _submit_events)
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import main as train_main

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = nvidia_smi()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, python {sys.version.split()[0]}")

    # -- phases 1-2: the host builds in worker processes, the kernels -------
    n_dblp, n_usps_plain, n_usps_et = ((2_000, 5_000, 20_000) if args.small
                                       else (24_810, 100_000, 1_000_000))
    dblp = make_dblp(n_dblp, seed=0)
    dblp_mt = make_dblp(300 if args.small else N_DBLP_MULTITERM, seed=0)
    usps_small = make_usps(n_usps_plain, seed=0)
    t = time.perf_counter()
    usps = make_usps(n_usps_et, seed=0)
    log(f"make_usps({n_usps_et}): {time.perf_counter() - t:.3f} s")
    # every host build (and the top-K caches and packed layouts derived
    # from them) runs in SHARD_WORKERS spawned processes, started while
    # the parent is small, each result through a pickled file and onto the
    # card as it lands; the longest chain (USPS ET 1M, its cache, its
    # packed cache) first, the kernels built once the other jobs are done.
    # In the parent the builds took ~360 s one after another; beside
    # worker processes they slowed as much as the workers saved; the
    # packed cache made from the dense trie beside the dense cache, not
    # after it, took 98 s instead of 64 + 24 (two caches at once)
    ties = {}
    for tie in TIE_SCORES:
        n = len(usps_small.strings)
        ties[tie] = dataclasses.replace(usps_small, scores=(
            np.full(n, 7) if tie == "equal" else
            np.random.default_rng(5).choice([5, 9, 13], n)))
    wide_ds = dataclasses.replace(usps_small, scores=np.random.default_rng(
        6).integers(0, 2**30, len(usps_small.strings)))

    launch_tmp = tempfile.TemporaryDirectory()
    launch_container = str(Path(launch_tmp.name) / "usps.npz")

    def job(ds, kind, **spec_kw):
        rules = ds.rules if kind != "plain" else []
        return ("build", (ds.strings, ds.scores, rules,
                          dict(kind=kind, **spec_kw)), None)

    ogb = dict(GNN_SHAPES["ogb_products"].params)
    if args.small:
        ogb.update(n_nodes=ogb["n_nodes"] // 100,
                   n_edges=ogb["n_edges"] // 100)
    jobs = {"USPS et": job(usps, "et"),
            "USPS ET cache_k=16": ("derive", (True, "none"), "USPS et"),
            "DBLP ht": job(dblp, "ht")}
    for i, (strings, scores) in enumerate(shard_strings(
            usps.strings, usps.scores, SHARDS)):
        jobs[f"shard {i}"] = ("build", (strings, scores, usps.rules,
                                        dict(kind="et", cache_k=CACHE_K)),
                              None)
    jobs.update({
        "DBLP tt": job(dblp, "tt"),
        "USPS plain": job(usps_small, "plain"),
        **{f"USPS scores {tie} et": job(ds, "et")
           for tie, ds in ties.items()},
        "USPS scores wide plain": job(wide_ds, "plain"),
        "USPS ET 100k cache_k=16": job(usps_small, "et", cache_k=CACHE_K),
        # the launcher's index (phase 4c (d): --arch autocomplete-usps at
        # its defaults), built and its container saved here
        "USPS ET 100k container": ("save", (
            usps_small.strings, usps_small.scores, usps_small.rules,
            dict(kind="et"), launch_container), None),
        # phase 5's multi-term indexes (their synthesized rules included)
        **{f"DBLP multiterm {comp}": ("build", (
            dblp_mt.strings, dblp_mt.scores, dblp_mt.rules,
            dict(kind="multiterm", compression=comp)), None)
           for comp in ("none", "packed")},
        "USPS ET packed": ("derive", (False, "packed"), "USPS et"),
        "USPS ET packed cache_k=16": ("derive", (False, "packed"),
                                      "USPS ET cache_k=16"),
        "DBLP TT packed": ("derive", (False, "packed"), "DBLP tt"),
        "DBLP HT packed": ("derive", (False, "packed"), "DBLP ht"),
        "DBLP TT packed cache_k=16": ("derive", (True, "packed"), "DBLP tt"),
        "USPS plain cache_k=16": ("derive", (True, "none"), "USPS plain"),
        "USPS plain packed": ("derive", (False, "packed"), "USPS plain"),
        "USPS plain scores wide packed cache_k=16": (
            "derive", (True, "packed"), "USPS scores wide plain")})
    # phase 5c's ogb_products graph (~25-40 s of host draws), queued behind
    # every build: it runs once the workers idle beside the 1M chain (first
    # in the queue, it slowed the chain by its core)
    jobs["ogb_products graph"] = ("graph", (
        ogb["n_nodes"], ogb["n_edges"], ogb["d_feat"], ogb["n_classes"]),
        None)
    for tie in TIE_SCORES:
        src = f"USPS scores {tie} et"
        jobs.update({
            f"USPS ET scores {tie} packed": ("derive", (False, "packed"),
                                             src),
            f"USPS ET scores {tie} cache_k=16": ("derive", (True, "none"),
                                                 src),
            f"USPS ET scores {tie} packed cache_k=16": (
                "derive", (False, "packed"),
                f"USPS ET scores {tie} cache_k=16")})
    host_tmp = tempfile.TemporaryDirectory()
    host = {"parts": {}, "spans": {}, "landed": threading.Condition(),
            "quiet": threading.Event()}
    pool = threading.Thread(target=host_builds, args=(
        jobs, SHARD_WORKERS, host_tmp.name, host))
    pool.start()

    # the kernels (an nvcc a source, all at once) once the workers'
    # other jobs are done: started beside them, the nvccs slowed the
    # workers' start and so the longest chain
    host["quiet"].wait()
    t0 = time.perf_counter()
    _build.build_all()
    for name in _build.SOURCES:
        _build.library(name)
    log(f"kernel build: {time.perf_counter() - t0:.3f} s wall "
        f"(nvcc {_build.build_seconds} s)")
    for name, text in _build.ptxas_log.items():
        for line in text.splitlines():
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    log(f"phase 2 at {time.perf_counter() - t_start:.1f} s")
    parts, spans = host["parts"], host["spans"]

    def landed(name):
        """Job ``name``'s parts, once they have landed."""
        with host["landed"]:
            host["landed"].wait_for(
                lambda: name in parts or "error" in host
                or not pool.is_alive())
        if name not in parts:
            raise AssertionError(f"the host builds failed before {name}: "
                                 f"{host.get('error')!r}")
        return parts.pop(name)

    def index(name):
        """The index of job ``name`` on the card (``from_parts``)."""
        trie, rule_trie, rules, strings, scores, cfg, spec, stats = \
            landed(name)
        t = time.perf_counter()
        idx = rt.CompletionIndex.from_parts(
            trie, rule_trie, rules, strings, scores, cfg, device=dev,
            spec=spec, stats=stats)
        torch.cuda.synchronize()
        n = len(idx.strings)
        what, _, src = jobs[name]
        a, b = spans[name]
        head = (f"build {name} ({n} strings): {b - a:.3f} s in a worker, "
                f"{a:.1f}-{b:.1f} s in; onto the card "
                f"{time.perf_counter() - t:.3f} s")
        if what == "build":
            log(f"{head}, {idx.stats.n_nodes} nodes, "
                f"{idx.stats.bytes_per_string:.1f} B/string, rule_matches="
                f"{idx.cfg.rule_matches}, teleports={idx.cfg.teleports}")
            return idx
        packed = idx.compression == "packed"
        hb = (trie.packed_nbytes() + rule_trie.nbytes()) if packed else 0
        log(f"{head} (from {src}), device tensors {device_bytes(idx)} B = "
            f"{device_bytes(idx) / n:.1f} B/string"
            + (f", packed layout + rule trie {hb / n:.1f} B/string "
               f"(tiers {dict(idx.cfg.table_widths)}, "
               f"{int(idx.tensors.c_ids.shape[0])} stored nodes)"
               if packed else ""))
        return idx

    dblp_tt, dblp_ht = index("DBLP tt"), index("DBLP ht")
    usps_plain = index("USPS plain")
    dblp_tt_p = index("DBLP TT packed")
    dblp_ht_p = index("DBLP HT packed")
    usps_plain_c = index("USPS plain cache_k=16")
    usps_plain_p = index("USPS plain packed")
    # the tie-heavy corpora: USPS ET at the plain cut's size, every score
    # equal or drawn from three values (numpy, seed 5)
    tie_indexes = {tie: (index(f"USPS scores {tie} et"),
                         index(f"USPS ET scores {tie} packed"))
                   for tie in TIE_SCORES}
    # the cached merge's corpora beside USPS ET 1M: the tie-heavy ones with
    # a cache (dense and packed), DBLP TT packed with a cache (its sids fit
    # the u16 tier) and USPS plain 100k with scores spread over 2^30 (its
    # cache scores take the int32 tier)
    merge_indexes = {
        f"scores {tie}": (index(f"USPS ET scores {tie} cache_k=16"),
                          index(f"USPS ET scores {tie} packed cache_k=16"))
        for tie in TIE_SCORES}
    landed("USPS scores wide plain")
    tier_indexes = {
        "DBLP TT": index("DBLP TT packed cache_k=16"),
        "USPS scores wide": index("USPS plain scores wide packed cache_k=16")}
    shard_parts = [landed(f"shard {i}") for i in range(SHARDS)]
    shard_spans = [spans[f"shard {i}"] for i in range(SHARDS)]
    churn_idx = index("USPS ET 100k cache_k=16")
    launch_path = landed("USPS ET 100k container")
    mt_indexes = {name: index(name) for name in ("DBLP multiterm none",
                                                 "DBLP multiterm packed")}
    products = landed("ogb_products graph")    # mapped, read in phase 5c
    # the longest chain last
    usps_et = index("USPS et")
    usps_et_p = index("USPS ET packed")
    usps_et_c = index("USPS ET cache_k=16")
    usps_et_pc = index("USPS ET packed cache_k=16")
    pool.join()
    host_tmp.cleanup()
    builds = {name: round(b - a, 3) for name, (a, b) in spans.items()}
    builds["workers' wall"] = host["wall"]
    log(f"host builds in {SHARD_WORKERS} worker processes: "
        f"{host['wall']:.3f} s wall ({host['timeline']})")

    def batch(ds, seed, n=B):
        qs, ql = pad_queries(make_workload(ds, n, seed=seed), L_BUCKET)
        return (torch.from_numpy(qs).to(dev), torch.from_numpy(ql).to(dev))

    # -- phase 3: each kernel against its plain version -------------------------
    log(f"phase 3 at {time.perf_counter() - t_start:.1f} s")
    # phase 5's two containers are written by a thread beside phase 3: a
    # save is host work alone (numpy arrays, zlib, the file; zlib and the
    # file write run without the GIL), phase 3 keeps one core launching
    # kernels.  Joined before phase 4, whose times it would disturb
    save_tmp = tempfile.TemporaryDirectory()
    saved = {}

    def save_all():
        try:
            for name, idx in (("USPS ET packed cache_k=16", usps_et_pc),
                              ("USPS plain", usps_plain)):
                path = str(Path(save_tmp.name) / f"{len(saved)}.npz")
                t = time.perf_counter()
                idx.save(path)
                saved[name] = (path, time.perf_counter() - t,
                               Path(path).stat().st_size)
        except BaseException as e:   # re-raised by the main thread below
            saved["error"] = e

    saver = threading.Thread(target=save_all)
    saver.start()
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
    log(f"  phase 3 at {time.perf_counter() - t_start:.1f} s: the prefix walk")
    # the prefix walk, both entries: on USPS plain 100k's CSR, DBLP's
    # dictionary CSR (the DBLP TT index's), a corpus of random byte strings
    # whose root row is 255 wide and whose second rows are wider than 32
    # (read 32 edges a round), and an empty edge table; at L = 8, 32 and 64
    # and B = 1, 63, 64, 65 and 1,024; the loci entry also against the
    # torch substrate's walk on the same index
    tp = usps_plain.tensors
    walk_rng = np.random.default_rng(8)
    wide_strings = [bytes([i]) + walk_rng.integers(
        1, 256, walk_rng.integers(0, 8)).astype(np.uint8).tobytes()
        for i in range(1, 256)]
    wide_strings += [bytes([int(walk_rng.choice([97, 200]))])
                     + walk_rng.integers(1, 256, walk_rng.integers(1, 40))
                     .astype(np.uint8).tobytes() for _ in range(3000)]
    wide_idx = rt.build_index(wide_strings, list(range(len(wide_strings))),
                              [], kind="plain", device=dev)
    fc = wide_idx.tensors.first_child.cpu()
    widths = fc[1:] - fc[:-1]
    if int(widths[0]) != 255 or int(widths[1:].max()) <= 32:
        raise AssertionError("the wide-row corpus should have a root row of "
                             "255 and a deeper row wider than 32; has "
                             f"{int(widths[0])} and {int(widths[1:].max())}")
    walk_tries = (
        ("USPS plain", usps_plain, usps_small.strings, True),
        ("DBLP TT dictionary", dblp_tt, dblp.strings, False),
        (f"wide rows (root 255, widest below {int(widths[1:].max())})",
         wide_idx, wide_strings, True),
        ("empty", rt.build_index([], [], [], kind="plain", device=dev), [],
         True))
    torch_sub = get_substrate("torch")
    for name, idx, strings, rule_free in walk_tries:
        tw = idx.tensors
        tables = (tw.first_child, tw.edge_char, tw.edge_child)
        for L in (8, L_BUCKET, 64):
            for n_q in (1, 63, B, 65, 1024):
                q, ql = walk_queries(strings, n_q, L, n_q + L, dev)
                what = (f"{name} L={L} B={n_q} lengths "
                        f"{int(ql.min())}-{int(ql.max())}")
                check_equal("trie_walk", what,
                            trie_walk.trie_walk(*tables, q, ql),
                            trie_walk.trie_walk_plain(*tables, q, ql))
                got = trie_walk.trie_walk_loci(*tables, q, ql,
                                               idx.cfg.frontier)
                check_equal("trie_walk", what + " loci", got,
                            trie_walk.trie_walk_loci_plain(
                                *tables, q, ql, idx.cfg.frontier))
                if rule_free and n_q == 65:
                    check_equal("trie_walk", what + " loci against the "
                                "torch substrate", got,
                                torch_sub.walk_batch(tw, idx.cfg, q, ql))
    del wide_idx
    for (name, label), (idx, cfg, loci) in loci_sets.items():
        kern = "beam_topk_packed" if "packed" in name else "beam_topk"
        got = beam_topk.beam_topk_batch(idx.tensors, cfg, loci, K)
        want = beam_topk.beam_topk_plain(idx.tensors, cfg, loci, K)
        check_equal(kern, f"{name} {label} W={cfg.gens} exact="
                    f"{int(got[2].sum())}/{B}", got, want)
    log(f"  phase 3 at {time.perf_counter() - t_start:.1f} s: the widest retry round")
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
    log(f"  phase 3 at {time.perf_counter() - t_start:.1f} s: the edit transitions")
    # the edit transitions: E = 1 and 2, both accessors, four corpora, the
    # default frontier and the widened retry's
    edit_loci = {}
    for name, idx, ds in (("DBLP TT", dblp_tt, dblp),
                          ("DBLP HT", dblp_ht, dblp),
                          ("USPS plain", usps_plain, usps_small),
                          ("USPS ET", usps_et, usps),
                          ("DBLP TT packed", dblp_tt_p, dblp),
                          ("DBLP HT packed", dblp_ht_p, dblp),
                          ("USPS plain packed", usps_plain_p, usps_small),
                          ("USPS ET packed", usps_et_p, usps)):
        kern = "locus_dp_packed" if "packed" in name else "locus_dp"
        q, ql = batch(ds, seed=1)
        for e in (0, 1, 2):
            for f in (idx.cfg.frontier,) + EDIT_FRONTIERS:
                cfg = replace(idx.cfg, edit_budget=e, frontier=f)
                ls = locus_dp.launch_shape(cfg, L_BUCKET)
                got = locus_dp.locus_dp_walk(idx.tensors, cfg, q, ql)
                want = locus_dp.locus_dp_plain(idx.tensors, cfg, q, ql)
                check_equal(kern, f"{name} E={e} F={f} BW="
                            f"{cfg.branch_width} cand={ls.cand} shared="
                            f"{ls.shared} workspace={ls.ws_stride} "
                            f"overflowing={int((got[1] > 0).sum())}/{B}",
                            got, want)
                edit_loci[name, e, f] = got
    for (name, e, f), got in edit_loci.items():
        other = edit_loci.get((name + " packed", e, f), got)
        if not all(torch.equal(a, b) for a, b in zip(got, other)):
            raise AssertionError(f"{name} E={e} F={f}: packed and dense "
                                 "loci differ")
    log("  dense and packed loci and overflow equal at E = 0, 1 and 2")
    log(f"  phase 3 at {time.perf_counter() - t_start:.1f} s: the beam at every width")
    # the beam on those loci at each retry round's widths (F = 32-256 with
    # W = 48-3,072), E = 0-2, both accessors, on USPS ET and DBLP HT
    for name, idx in (("USPS ET", usps_et), ("DBLP HT", dblp_ht),
                      ("USPS ET packed", usps_et_p),
                      ("DBLP HT packed", dblp_ht_p)):
        kern = "beam_topk_packed" if "packed" in name else "beam_topk"
        for e in (0, 1, 2):
            for r in range(4):
                cfg = replace(idx.cfg, edit_budget=e,
                              **round_widths(idx.cfg, r))
                loci = edit_loci[name, e, cfg.frontier][0]
                n_q = B if r < 2 else B // 4
                got = beam_topk.beam_topk_batch(idx.tensors, cfg,
                                                loci[:n_q], K)
                want = beam_topk.beam_topk_plain(idx.tensors, cfg,
                                                 loci[:n_q], K)
                check_equal(kern, f"{name} E={e} W={cfg.gens} "
                            f"max_steps={cfg.max_steps} on {n_q} queries "
                            f"exact={int(got[2].sum())}/{n_q}", got, want)
    log(f"  phase 3 at {time.perf_counter() - t_start:.1f} s: the forced workspace")
    # the device-memory workspace, forced: candidate rows, then the
    # frontier too
    saved_max = _build.MAX_SHARED_BYTES
    for name, idx, ds, e in (("USPS ET", usps_et, usps, 1),
                             ("DBLP HT packed", dblp_ht_p, dblp, 2)):
        kern = "locus_dp_packed" if "packed" in name else "locus_dp"
        q, ql = batch(ds, seed=1)
        cfg = replace(idx.cfg, edit_budget=e, frontier=64)
        if locus_dp.launch_shape(cfg, L_BUCKET).ws_stride:
            raise AssertionError(f"{name}: F=64 should fit shared memory")
        small = 4 * locus_dp.fixed_ints(cfg, L_BUCKET)
        for cap in (small + 4 * (L_BUCKET + 1) * 64, small):
            _build.MAX_SHARED_BYTES = cap
            forced = locus_dp.launch_shape(cfg, L_BUCKET)
            got = locus_dp.locus_dp_walk(idx.tensors, cfg, q, ql)
            _build.MAX_SHARED_BYTES = saved_max
            check_equal(kern, f"{name} E={e} F=64 forced workspace "
                        f"(frontier {forced.buf_in_ws}, candidates "
                        f"{forced.cand_in_ws}, {forced.ws_stride} ints a "
                        "block)", got,
                        locus_dp.locus_dp_plain(idx.tensors, cfg, q, ql))

    log(f"  phase 3 at {time.perf_counter() - t_start:.1f} s: short and long queries")
    # queries of one character, of a full L_BUCKET characters, and mixed
    # (a dictionary string typed on past its end, to fill the bucket)
    work = make_workload(usps, B, seed=3)
    edge = ([x[:1] for x in work[:16]]
            + [" ".join([x] * 3)[:L_BUCKET] for x in usps.strings[:16]]
            + work[16:B])
    qs_e, ql_e = pad_queries(edge, L_BUCKET)
    q_e, ql_e = (torch.from_numpy(qs_e).to(dev),
                 torch.from_numpy(ql_e).to(dev))
    if not {1, L_BUCKET} <= set(ql_e.tolist()):
        raise AssertionError("the edge batch should hold lengths 1 and "
                             f"{L_BUCKET}")
    for name, idx in (("USPS ET", usps_et), ("USPS ET packed", usps_et_p),
                      ("DBLP HT", dblp_ht)):
        sfx = "_packed" if "packed" in name else ""
        for e in (0, 1, 2):
            cfg = replace(idx.cfg, edit_budget=e)
            got = locus_dp.locus_dp_walk(idx.tensors, cfg, q_e, ql_e)
            check_equal("locus_dp" + sfx, f"{name} E={e} lengths 1, "
                        f"{L_BUCKET} and mixed", got,
                        locus_dp.locus_dp_plain(idx.tensors, cfg, q_e, ql_e))
            got_b = beam_topk.beam_topk_batch(idx.tensors, cfg, got[0], K)
            check_equal("beam_topk" + sfx, f"{name} E={e} lengths 1, "
                        f"{L_BUCKET} and mixed", got_b,
                        beam_topk.beam_topk_plain(idx.tensors, cfg, got[0],
                                                  K))
    log(f"  phase 3 at {time.perf_counter() - t_start:.1f} s: tie-heavy corpora")
    # tie-heavy corpora, where the pool order decides which generator is
    # popped: the beam at every round's widths, both accessors
    for tie in TIE_SCORES:
        idx_d, idx_p = tie_indexes[tie]
        q, ql = batch(usps_small, seed=4)
        answers_tie = []
        for idx in (idx_d, idx_p):
            kern = ("beam_topk_packed" if idx is idx_p else "beam_topk")
            for r in range(4):
                cfg = replace(idx.cfg, **round_widths(idx.cfg, r))
                loci = locus_dp.locus_dp_walk(idx.tensors, cfg, q, ql)[0]
                n_q = B if r < 2 else B // 4
                got = beam_topk.beam_topk_batch(idx.tensors, cfg,
                                                loci[:n_q], K)
                check_equal(kern, f"USPS ET {len(usps_small.strings)} "
                            f"scores {tie} "
                            f"{'packed' if idx is idx_p else 'dense'} "
                            f"W={cfg.gens} on {n_q} queries", got,
                            beam_topk.beam_topk_plain(idx.tensors, cfg,
                                                      loci[:n_q], K))
                answers_tie.append(got)
        for a, b in zip(answers_tie[:4], answers_tie[4:]):
            if not all(torch.equal(x, y) for x, y in zip(a, b)):
                raise AssertionError(f"scores {tie}: packed and dense beams "
                                     "differ")
    log("  tie-heavy corpora: packed and dense beams equal at every width")

    log(f"  phase 3 at {time.perf_counter() - t_start:.1f} s: the cached merge")
    # the cached merge at every width of the warp path (F*K = 16 to 1,024
    # at K=16: 1 to 32 keys a lane) and on the block path (F = 65, 128),
    # k = 1, k < K, K, F*K and past it, on both layouts of USPS ET 1M
    # (1.4M stored nodes: the rank tree's five levels) and of the
    # tie-heavy corpora; then each packed cache tier
    merge_sets = [("USPS ET", usps_et_c, usps_et_pc,
                   loci_sets["USPS ET", "retry"][2])]
    q, ql = batch(usps_small, seed=1)
    for tie in TIE_SCORES:
        idx = tie_indexes[tie][0]
        cfg = replace(idx.cfg, **RETRY)
        merge_sets.append((f"scores {tie}", *merge_indexes[f"scores {tie}"],
                           locus_dp.locus_dp_walk(idx.tensors, cfg, q,
                                                  ql)[0]))
    for name, dense_c, packed_c, loci64 in merge_sets:
        # every template on USPS ET; the widest of each path on the others
        for F in ((1, 2, 4, 8, 16, 32, 64, 65, 128) if name == "USPS ET"
                  else (32, 64, 65)):
            lo = torch.cat([loci64, loci64], 1)[:, :F].contiguous()
            keys, threads, _ = locus_merge.launch_plan(F, CACHE_K, B)
            for k in sorted({1, K, CACHE_K, F * CACHE_K, F * CACHE_K + 88}):
                for layout, idx in (("dense", dense_c), ("packed", packed_c)):
                    got = locus_merge.locus_topk_merge(idx.tensors, lo, k)
                    want = locus_merge.locus_merge_plain(idx.tensors, lo, k)
                    check_equal("locus_topk_merge", f"{name} {layout} F={F} "
                                f"({keys} keys a lane, {threads} threads) "
                                f"k={k}", got, want)
    for name, idx, ds in (("USPS ET packed", usps_et_pc, usps),
                          ("DBLP TT", tier_indexes["DBLP TT"], dblp),
                          ("USPS scores wide",
                           tier_indexes["USPS scores wide"], usps_small)):
        tiers = {n: w for n, w in idx.cfg.table_widths if n.startswith("pc_")}
        q, ql = batch(ds, seed=1)
        lo = locus_dp.locus_dp_walk(idx.tensors, idx.cfg, q, ql)[0]
        F = int(lo.shape[1])
        for k in (K, F * CACHE_K + 88):
            got = locus_merge.locus_topk_merge(idx.tensors, lo, k)
            check_equal("locus_topk_merge", f"{name} cache tiers {tiers} "
                        f"k={k}", got,
                        locus_merge.locus_merge_plain(idx.tensors, lo, k))
    log(f"  phase 3 at {time.perf_counter() - t_start:.1f} s: topk_select")
    # topk_select at the rule-free cached route's shape, then at every
    # width of the warp path (1 to 32 keys a lane) and on the block path
    # (C = 1,025 and 2,048), on rows of ties, of one score, and of
    # unsorted scores over the whole int32 range
    q, ql = batch(usps_small, seed=1)
    loci_plain = trie_walk.trie_walk_loci(tp.first_child, tp.edge_char,
                                          tp.edge_child, q, ql, 1)[0]
    sel_s, sel_p = cached.gather_cached(usps_plain_c.tensors, loci_plain)
    for k in (K, CACHE_K):
        got = topk_select.topk_select(sel_s, sel_p, k)
        check_equal("topk_select", f"USPS plain cache C={CACHE_K} k={k}", got,
                    topk_select.topk_select_plain(sel_s, sel_p, k))
    gen = torch.Generator().manual_seed(0)
    for C in (1, 16, 17, 33, 100, 250, 512, 1024, 1025, 2048):
        keys, threads = topk_select.launch_plan(C, B)
        rows = {"ties": torch.randint(0, 4, (B, C), generator=gen),
                "one score": torch.full((B, C), 7),
                "unsorted": torch.randint(-2**31, 2**31 - 1, (B, C),
                                          generator=gen)}
        pay = torch.randint(-1, 10**6, (B, C), generator=gen,
                            dtype=torch.int32).to(dev)
        for kind, sc in rows.items():
            sc = sc.to(torch.int32).to(dev)
            for k in sorted({1, min(K, C), C}):
                got = topk_select.topk_select(sc, pay, k)
                check_equal("topk_select", f"[{B}, {C}] {kind} ({keys} keys "
                            f"a lane, {threads} threads) k={k}", got,
                            topk_select.topk_select_plain(sc, pay, k))

    log(f"  phase 3 at {time.perf_counter() - t_start:.1f} s: the off-path kernels")
    # the off-path kernels, on inputs made on the card from a seed
    gen = torch.Generator(device=dev).manual_seed(0)
    n_cand = 20_000 if args.small else CAND_N
    cand_q = torch.randn(CAND_D, generator=gen, device=dev)
    cands = torch.randn(n_cand, CAND_D, generator=gen, device=dev)
    cand_q_bf16, cands_bf16 = cand_q.bfloat16(), cands.bfloat16()

    def topk_parity(what, query, cand, k, block_c=1024):
        got = candidate_topk.candidate_topk(query, cand, k, block_c)
        check_topk(what, got, candidate_topk.candidate_topk_plain(query, cand,
                                                                  k))
        return got

    for q_t, c_t in ((cand_q, cands), (cand_q_bf16, cands_bf16)):
        topk_parity(f"C={n_cand} D={CAND_D} k={CAND_K} {str(c_t.dtype)[6:]}",
                    q_t, c_t, CAND_K)
    for c_n, k, bc in ((300, 200, 256), (5, 9, 1024), (4097, 1, 64)):
        topk_parity(f"C={c_n} k={k} block_c={bc}", cand_q, cands[:c_n], k, bc)
    # the scalar path: D=33 rows from an odd row offset (not 16-byte aligned)
    c33 = torch.randn(n_cand + 1, 33, generator=gen, device=dev)
    for dt in (torch.float32, torch.bfloat16):
        rows33 = c33.to(dt)[1:]
        if rows33.data_ptr() % 16 == 0:
            raise AssertionError("the D=33 slice should be misaligned")
        topk_parity(f"C={n_cand} D=33 {str(dt)[6:]} misaligned (scalar "
                    "loads)", cand_q[:33].to(dt), rows33, CAND_K)
    del c33, rows33
    # wide rows: past four query vectors a lane reads the rest from memory
    wide = torch.randn(20_000, 1000, generator=gen, device=dev)
    topk_parity("C=20000 D=1000 (query partly from memory)",
                torch.randn(1000, generator=gen, device=dev), wide, CAND_K)
    del wide
    same = cands[:1].expand(n_cand, CAND_D).contiguous()
    got = topk_parity(f"C={n_cand} all scores equal", cand_q, same, CAND_K)
    if not torch.equal(got[1], torch.arange(CAND_K, dtype=torch.int32,
                                            device=dev)):
        raise AssertionError(f"candidate_topk all scores equal: ids "
                             f"{got[1][:8].tolist()}..., expected 0..k-1")
    asc = torch.zeros(n_cand, CAND_D, device=dev)
    asc[:, 0] = torch.arange(n_cand, device=dev, dtype=torch.float32)
    unit = torch.zeros(CAND_D, device=dev)
    unit[0] = 1.0
    got = topk_parity(f"C={n_cand} scores ascending by id (every row beats "
                      "the threshold)", unit, asc, CAND_K)
    if not torch.equal(got[1], torch.arange(n_cand - 1, n_cand - 1 - CAND_K,
                                            -1, dtype=torch.int32,
                                            device=dev)):
        raise AssertionError("candidate_topk ascending scores: wrong ids")
    del same, asc
    k_top = candidate_topk.max_k(CAND_D)
    topk_parity(f"C={n_cand} largest k={k_top}", cand_q, cands, k_top)

    n_rows = 20_000 if args.small else BAG_ROWS
    bag_table = torch.randn(n_rows, BAG_D, generator=gen, device=dev)
    table33 = torch.randn(n_rows + 1, 33, generator=gen, device=dev)
    bag_lens = torch.randint(0, BAG_MAX + 1, (BAGS,), generator=gen,
                             device=dev)
    bag_off = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                         bag_lens.cumsum(0)]).to(torch.int32)
    n_idx = int(bag_off[-1])
    bag_idx = torch.randint(0, n_rows, (n_idx,), generator=gen, device=dev,
                            dtype=torch.int32)
    bag_w = torch.randn(n_idx, generator=gen, device=dev)
    holes = torch.where(torch.rand(n_idx, generator=gen, device=dev) < 0.05,
                        -1, bag_idx).to(torch.int32)
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 3e-2)):
        # D=64, and D=33 from an odd row offset (the scalar path)
        for tab in (bag_table.to(dt), table33.to(dt)[1:]):
            for indices, label in ((bag_idx, ""), (holes, ", 5% -1")):
                for cut in (None, BAG_MAX // 2):
                    d_idx, d_w = ops.densify_bags(indices, bag_off, bag_w, cut,
                                                  dt, dev)
                    for mode in ("sum", "mean"):
                        what = (f"{n_rows}x{tab.shape[1]} {str(dt)[6:]} {BAGS}"
                                f" bags {mode}{label} max_bag={cut}")
                        want = embedding_bag.embedding_bag_dense_plain(
                            tab, d_idx, d_w, mode)
                        check_close("embedding_bag", "dense " + what,
                                    embedding_bag.embedding_bag_dense(
                                        tab, d_idx, d_w, mode), want, tol)
                        check_close("embedding_bag", "ragged " + what,
                                    embedding_bag.embedding_bag_ragged(
                                        tab, indices, bag_off, bag_w, mode,
                                        cut), want, tol)
    # long bags: a warp reads its bag 32 entries at a time
    long_lens = torch.randint(0, 101, (64,), generator=gen, device=dev)
    long_off = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                          long_lens.cumsum(0)]).to(torch.int32)
    long_idx = torch.randint(-1, n_rows, (int(long_off[-1]),), generator=gen,
                             device=dev, dtype=torch.int32)
    long_w = torch.randn(long_idx.shape[0], generator=gen, device=dev)
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 3e-2)):
        tab = bag_table.to(dt)
        d_idx, d_w = ops.densify_bags(long_idx, long_off, long_w, None, dt,
                                      dev)
        for mode in ("sum", "mean"):
            want = embedding_bag.embedding_bag_dense_plain(tab, d_idx, d_w,
                                                           mode)
            what = f"64 bags of 0-100 entries {str(dt)[6:]} {mode}"
            check_close("embedding_bag", "dense " + what,
                        embedding_bag.embedding_bag_dense(tab, d_idx, d_w,
                                                          mode), want, tol)
            check_close("embedding_bag", "ragged " + what,
                        embedding_bag.embedding_bag_ragged(
                            tab, long_idx, long_off, long_w, mode), want, tol)
    d_idx, d_w = ops.densify_bags(holes, bag_off, None, None, torch.float32,
                                  dev)
    check_close("embedding_bag", "ragged int64 indices and offsets, no "
                "weights", embedding_bag.embedding_bag_ragged(
                    bag_table, holes.long(), bag_off.long()),
                embedding_bag.embedding_bag_dense_plain(bag_table, d_idx, d_w),
                1e-5)
    del table33

    t = time.perf_counter()
    saver.join()
    if "error" in saved:
        raise AssertionError("phase 5's saves failed") from saved["error"]
    log(f"phase 5's saves done beside phase 3 ({time.perf_counter() - t:.1f}"
        " s waited for them at its end)")

    # -- phase 4: the main path ---------------------------------------------------
    log(f"phase 4 at {time.perf_counter() - t_start:.1f} s")
    counters = {
        "trie_walk": (trie_walk, "launches"),
        "trie_walk_loci": (trie_walk, "loci_launches"),
        "locus_dp": (locus_dp, "launches"),
        "locus_dp_packed": (locus_dp, "packed_launches"),
        "beam_topk": (beam_topk, "launches"),
        "beam_topk_packed": (beam_topk, "packed_launches"),
        "topk_select": (topk_select, "launches"),
        "locus_topk_merge": (locus_merge, "launches"),
        "candidate_topk": (candidate_topk, "launches"),
        "embedding_bag": (embedding_bag, "launches"),
        "embedding_bag_backward": (embedding_bag, "backward_launches"),
    }
    plain_counters = ((trie_walk, "plain_calls"), (locus, "calls"),
                      (beam, "calls"), (cached, "calls"),
                      (cached, "select_calls"),
                      (candidate_topk, "plain_calls"),
                      (embedding_bag, "plain_calls"),
                      (embedding_bag, "backward_plain_calls"))

    def reset_counts():
        for mod, attr in list(counters.values()) + list(plain_counters):
            setattr(mod, attr, 0)
        locus_dp.width_launches.clear()
        beam_topk.width_launches.clear()

    def counts():
        c = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
        c["plain"] = sum(getattr(mod, attr) for mod, attr in plain_counters)
        # launches by width: (row name, edit budget, F or W) -> count
        c["widths"] = {
            (base + ("_packed" if layout == "packed" else ""), e, w): n
            for base, mod in (("locus_dp", locus_dp), ("beam_topk", beam_topk))
            for (layout, e, w), n in mod.width_launches.items()}
        return c

    answers = {}

    def main_path(name, idx, ds, must_launch, n_check=None):
        """Drive ``idx`` through the service on the 512-query workload;
        hold the answers against the torch substrate's on the first
        ``n_check`` queries (all by default)."""
        queries = make_workload(ds, 512, seed=1)
        batches = [queries[i:i + B] for i in range(0, len(queries), B)]
        service = rt.CompletionService(idx)
        service.complete(batches[0], k=K)           # warm-up
        service.reset_stats()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        retried = list(idx.retried)
        reset_counts()
        lat = []
        results = []
        for b in batches:
            t = time.perf_counter()
            results += service.complete(b, k=K)
            lat.append((time.perf_counter() - t) * 1e3)
        c = counts()
        retried = [a - b for a, b in zip(idx.retried, retried)]
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
            f"queries re-run by retry rounds 1-3 {retried}, launches "
            f"{ {k: v for k, v in c.items() if k != 'widths'} }, by width "
            + ", ".join(f"{k[0]} E={k[1]} {'F' if 'locus' in k[0] else 'W'}"
                        f"={k[2]}: {v}" for k, v in sorted(c["widths"].items())))
        for k_name in must_launch:
            if c[k_name] <= 0:
                raise AssertionError(f"{name}: {k_name} never launched")
        if c["plain"]:
            raise AssertionError(f"{name}: a plain version ran on the main "
                                 "path")
        held = queries[:n_check]
        if held:
            idx.reconfigure(substrate="torch")
            want = [r for i in range(0, len(held), B)
                    for r in idx.complete(held[i:i + B], k=K)]
            idx.reconfigure(substrate="cuda")
            if results[:len(held)] != want:
                bad = [i for i, (a, b) in enumerate(zip(results, want))
                       if a != b]
                raise AssertionError(f"{name}: cuda and torch substrates "
                                     f"differ on queries {bad[:5]}")
            log(f"  {name}: cuda answers equal the torch substrate's "
                f"({len(held)} queries)")
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
    # the launches of phase 4's batches of B, by width: phase 6 times
    # each width at that shape on USPS ET 1M's first batch (phase 5's B=1
    # keystrokes and its other indexes' batches count in `launched` alone;
    # their device times are the profiler's, in phase 5's lines)
    width_launched = {}
    batch_launched = {}

    def record(c, *names, by_width=True):
        for k_name in names:
            launched[k_name] = launched.get(k_name, 0) + c[k_name]
            if by_width:
                batch_launched[k_name] = (batch_launched.get(k_name, 0)
                                          + c[k_name])
        for key, n in c.get("widths", {}).items():
            if by_width and key[0] in names:
                width_launched[key] = width_launched.get(key, 0) + n

    # every key the USPS ET 1M index's compile cache is asked for in
    # phase 4, in order (the cache line below replays them)
    et_cache, et_keys = usps_et._compile_cache, []
    if len(et_cache) or et_cache.misses:
        raise AssertionError("USPS ET 1M's compile cache was used before "
                             "phase 4")
    et_get = et_cache.get

    def recording_get(key, factory):
        et_keys.append(key)
        return et_get(key, factory)

    et_cache.get = recording_get
    record(main_path("USPS ET", usps_et, usps, ("locus_dp", "beam_topk")),
           "locus_dp", "beam_topk")

    def rule_free(c, name):
        # the rule-free phase 1 runs as the loci entry's one launch
        if c["trie_walk"] != c["trie_walk_loci"]:
            raise AssertionError(f"{name}: {c['trie_walk']} walk launches, "
                                 f"{c['trie_walk_loci']} of the loci entry")
        return c

    record(rule_free(main_path("USPS plain", usps_plain, usps_small,
                               ("trie_walk_loci", "beam_topk")),
                     "USPS plain"), "trie_walk")
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
    record(rule_free(main_path("USPS plain cache_k=16", usps_plain_c,
                               usps_small, ("trie_walk_loci", "topk_select")),
                     "USPS plain cache_k=16"), "trie_walk", "topk_select")

    # bounded-edit completion: the built indexes reconfigured, no rebuild
    for name, idx, must in (
            ("USPS ET E=1", usps_et, ("locus_dp", "beam_topk")),
            ("USPS ET packed E=1", usps_et_p,
             ("locus_dp_packed", "beam_topk_packed")),
            ("USPS ET cache_k=16 E=1", usps_et_c,
             ("locus_dp", "locus_topk_merge")),
            ("USPS ET packed cache_k=16 E=1", usps_et_pc,
             ("locus_dp_packed", "locus_topk_merge"))):
        tensors = idx.tensors
        idx.reconfigure(edit_budget=1)
        if idx.tensors is not tensors:
            raise AssertionError(f"{name}: reconfigure rebuilt the index")
        record(main_path(name, idx, usps, must, n_check=128), *must)
        idx.reconfigure(edit_budget=0)
    same_answers("USPS ET packed E=1", "USPS ET E=1")
    same_answers("USPS ET packed cache_k=16 E=1", "USPS ET cache_k=16 E=1")
    usps_et.reconfigure(edit_budget=2)
    record(main_path("USPS ET E=2", usps_et, usps, ("locus_dp", "beam_topk"),
                     n_check=64), "locus_dp", "beam_topk")
    usps_et.reconfigure(edit_budget=0)

    # the off-path ops entry points: one retrieval query over the
    # candidates, one serving batch of bags
    reset_counts()
    top_s, top_i = ops.candidate_topk(cand_q, cands, CAND_K)
    bag_out = ops.embedding_bag(bag_table, bag_idx, bag_off, bag_w,
                                mode="sum")
    torch.cuda.synchronize()
    c = counts()
    log(f"ops path: candidate_topk C={n_cand} k={CAND_K}, embedding_bag "
        f"{BAGS} bags: launches {c}")
    for k_name in ("candidate_topk", "embedding_bag"):
        if c[k_name] <= 0:
            raise AssertionError(f"ops path: {k_name} never launched")
    if c["plain"]:
        raise AssertionError("ops path: a plain version ran")
    if not (torch.isfinite(top_s).all() and (top_i >= 0).all()
            and top_i.unique().numel() == CAND_K
            and (top_s[:-1] >= top_s[1:]).all()
            and torch.isfinite(bag_out).all()
            and bag_out.shape == (BAGS, BAG_D)):
        raise AssertionError("ops path: malformed outputs")
    record(c, "candidate_topk", "embedding_bag")

    # the compile cache of USPS ET 1M over phase 4: its counts against an
    # LRU of the same size replayed over the keys phase 4 asked for
    del et_cache.get
    replay = rt.api.CompileCache(maxsize=et_cache.maxsize)
    for key in et_keys:
        replay.get(key, lambda: None)
    got_cc = (et_cache.hits, et_cache.misses, et_cache.evictions)
    distinct = len(set(et_keys))
    log(f"compile cache USPS ET 1M over phase 4: hits {got_cc[0]}, misses "
        f"{got_cc[1]}, evictions {got_cc[2]} ({len(et_keys)} lookups of "
        f"{distinct} distinct keys, kinds "
        f"{sorted({k[0] for k in et_keys})}; maxsize {et_cache.maxsize}, "
        f"{len(et_cache)} entries)")
    if got_cc != (replay.hits, replay.misses, replay.evictions) \
            or (got_cc[2] == 0 and got_cc[1] != distinct):
        raise AssertionError(
            f"compile cache: {got_cc} against the replay's "
            f"{(replay.hits, replay.misses, replay.evictions)} and "
            f"{distinct} distinct keys")

    # the ops wrappers (repro.kernels.ops's names) on the main path's
    # shapes: B=64, L=32, k=10, F=32 on USPS ET 1M dense and packed (with
    # and without the cache) and USPS plain 100k; each held bit for bit
    # against the torch substrate's plain version on the same tensors on
    # the card and against phase 4's substrate path (the index's cached
    # entry point) on the same batch, streamed=True against False, and the
    # degenerate shapes repro short-circuits
    torch_sub = get_substrate("torch")

    def equal(what, got, want):
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                bad = (g != w).nonzero()[:5].tolist()
                raise AssertionError(f"ops {what}: differ at {bad}")

    def ops_batch(ds):
        qs, ql = pad_queries(make_workload(ds, 512, seed=1)[:B], L_BUCKET)
        return torch.from_numpy(qs).to(dev), torch.from_numpy(ql).to(dev)

    def phase4(idx, q, ql):
        """What phase 4's path returns for the batch: the index's cached
        entry point at this shape."""
        return idx._fn(B, L_BUCKET, K, idx.cfg)(q, ql)

    q_et, ql_et = ops_batch(usps)
    q_pl, ql_pl = ops_batch(usps_small)
    reset_counts()
    ops_out = {}
    for name, idx in (("dense", usps_et), ("packed", usps_et_p)):
        t, cfg = idx.tensors, idx.cfg
        loci = ops.locus_walk(t, cfg, q_et, ql_et)
        ops_out[name] = (loci, ops.locus_walk(t, cfg, q_et, ql_et,
                                              streamed=True),
                         ops.beam_topk(t, cfg, loci[0], K))
        if name == "dense":
            ops_out["dense streamed beam"] = ops.beam_topk(
                t, cfg, loci[0], K, streamed=True)
    loci_c = ops.locus_walk(usps_et_c.tensors, usps_et_c.cfg, q_et, ql_et)
    merge = ops.cached_topk_merge(loci_c[0], usps_et_c.tensors.topk_score,
                                  usps_et_c.tensors.topk_sid, K)
    loci_pc = ops.locus_walk(usps_et_pc.tensors, usps_et_pc.cfg, q_et,
                             ql_et)
    merge_p = ops.cached_topk_merge_packed(usps_et_pc.tensors, loci_pc[0], K)
    tp = usps_plain.tensors
    walk = ops.trie_walk(tp.first_child, tp.edge_char, tp.edge_child, q_pl,
                         ql_pl)
    walk_s = ops.trie_walk(tp.first_child, tp.edge_char, tp.edge_child,
                           q_pl, ql_pl, streamed=True,
                           walk_tile=usps_plain.cfg.walk_tile)
    walk_loci = torch.full((B, usps_plain.cfg.frontier), -1,
                           dtype=torch.int32, device=dev)
    walk_loci[:, 0] = torch.where(walk[1] == ql_pl, walk[0], -1)
    plain_beam = ops.beam_topk(tp, usps_plain.cfg, walk_loci, K)
    tpc = usps_plain_c.tensors
    sc, si = cached.gather_cached(tpc, walk_loci[:, :1])
    select = ops.topk_select(sc, si, K)
    torch.cuda.synchronize()
    c = counts()
    log(f"ops wrappers: launches "
        f"{ {k: v for k, v in c.items() if k != 'widths'} }")
    ops_kernels = ("trie_walk", "locus_dp", "locus_dp_packed", "beam_topk",
                   "beam_topk_packed", "topk_select", "locus_topk_merge")
    for k_name in ops_kernels:
        if c[k_name] <= 0:
            raise AssertionError(f"ops wrappers: {k_name} never launched")
    if c["plain"]:
        raise AssertionError("ops wrappers: a plain version ran")
    # a side check of the public wrappers, not the main path: its
    # launches stay out of the kernels line's counts
    # bit for bit: streamed against not, the torch substrate, phase 4
    for name, idx in (("dense", usps_et), ("packed", usps_et_p)):
        t, cfg = idx.tensors, idx.cfg
        loci, loci_s, (s, i, e) = ops_out[name]
        equal(f"locus_walk {name} streamed", loci_s, loci)
        equal(f"locus_walk {name}", loci,
              torch_sub.walk_batch(t, cfg, q_et, ql_et))
        equal(f"beam_topk {name}", (s, i, e),
              torch_sub.beam_topk_batch(t, cfg, loci[0], K))
        ps, pi, pe = phase4(idx, q_et, ql_et)
        equal(f"beam_topk {name} against phase 4", (s, i, e & (loci[1] == 0)),
              (ps, pi, pe))
    equal("beam_topk dense streamed", ops_out["dense streamed beam"],
          ops_out["dense"][2])
    try:
        ops.beam_topk(usps_et_p.tensors, usps_et_p.cfg, ops_out["packed"][0][0],
                      K, streamed=True)
        raise AssertionError("ops.beam_topk: the packed streamed beam did "
                             "not raise")
    except ValueError:
        pass
    equal("cached_topk_merge", merge,
          cached.cached_topk(usps_et_c.tensors, loci_c[0], K))
    equal("cached_topk_merge against phase 4", merge,
          phase4(usps_et_c, q_et, ql_et)[:2])
    equal("cached_topk_merge_packed", merge_p,
          cached.cached_topk(usps_et_pc.tensors, loci_pc[0], K))
    equal("cached_topk_merge_packed against phase 4", merge_p,
          phase4(usps_et_pc, q_et, ql_et)[:2])
    equal("trie_walk streamed", walk_s, walk)
    equal("trie_walk", walk, trie_walk.trie_walk_plain(
        tp.first_child, tp.edge_char, tp.edge_child, q_pl, ql_pl))
    equal("trie_walk against phase 4's walk", (walk_loci,),
          (get_substrate("cuda").walk_batch(tp, usps_plain.cfg, q_pl,
                                            ql_pl)[0],))
    equal("trie_walk + beam_topk against phase 4", plain_beam,
          phase4(usps_plain, q_pl, ql_pl))
    equal("topk_select", select, cached.select_topk(sc, si, K))
    equal("topk_select against phase 4", select,
          phase4(usps_plain_c, q_pl, ql_pl)[:2])
    # the degenerate shapes: an empty dictionary's beam (decided before
    # any launch), k = C and k > C (raises, as lax.top_k), k past F*K
    # (the merge kernel sorts the union, then pads with -1)
    reset_counts()
    empty = rt.build_index([], [], [], kind="et", device=dev)
    es, ei, ee = ops.beam_topk(empty.tensors, empty.cfg,
                               torch.full((B, 32), -1, dtype=torch.int32,
                                          device=dev), K)
    if c_empty := counts()["beam_topk"]:
        raise AssertionError(f"ops.beam_topk: {c_empty} launches on an "
                             "empty dictionary")
    if not ((es == -1).all() and (ei == -1).all() and ee.all()):
        raise AssertionError("ops.beam_topk: an empty dictionary answered")
    s10, p10 = select
    equal("topk_select k = C", ops.topk_select(s10, p10, K),
          cached.select_topk(s10, p10, K))
    try:
        ops.topk_select(s10, p10, K + 1)
        raise AssertionError("ops.topk_select: k > C did not raise")
    except ValueError:
        pass
    wide_k = 2 * CACHE_K + 8
    equal("cached_topk_merge k > F*K",
          ops.cached_topk_merge(loci_c[0][:, :2].contiguous(),
                                usps_et_c.tensors.topk_score,
                                usps_et_c.tensors.topk_sid, wide_k),
          cached.cached_topk(usps_et_c.tensors,
                             loci_c[0][:, :2].contiguous(), wide_k))
    equal("cached_topk_merge_packed k > F*K",
          ops.cached_topk_merge_packed(usps_et_pc.tensors,
                                       loci_pc[0][:, :2].contiguous(),
                                       wide_k),
          cached.cached_topk(usps_et_pc.tensors,
                             loci_pc[0][:, :2].contiguous(), wide_k))
    log("ops wrappers: every output equal to the torch substrate's and to "
        "phase 4's on the same batch, streamed=True equal to False, the "
        "packed streamed beam and k > C raising, the empty dictionary, "
        "k = C and k > F*K as repro answers them")
    ops_ms = {}
    for name, fn in (
            ("trie_walk", lambda: ops.trie_walk(
                tp.first_child, tp.edge_char, tp.edge_child, q_pl, ql_pl)),
            ("locus_walk dense", lambda: ops.locus_walk(
                usps_et.tensors, usps_et.cfg, q_et, ql_et)),
            ("locus_walk packed", lambda: ops.locus_walk(
                usps_et_p.tensors, usps_et_p.cfg, q_et, ql_et)),
            ("beam_topk dense", lambda: ops.beam_topk(
                usps_et.tensors, usps_et.cfg, ops_out["dense"][0][0], K)),
            ("beam_topk packed", lambda: ops.beam_topk(
                usps_et_p.tensors, usps_et_p.cfg, ops_out["packed"][0][0],
                K)),
            ("topk_select", lambda: ops.topk_select(sc, si, K)),
            ("cached_topk_merge", lambda: ops.cached_topk_merge(
                loci_c[0], usps_et_c.tensors.topk_score,
                usps_et_c.tensors.topk_sid, K)),
            ("cached_topk_merge_packed", lambda: ops.cached_topk_merge_packed(
                usps_et_pc.tensors, loci_pc[0], K))):
        ops_ms[name] = cuda_ms(fn, 20)
        log(f"ops.{name} (B={B}, L={L_BUCKET}, k={K}, F=32): "
            f"{ops_ms[name]:.4f} ms a call (CUDA events over 20 calls)")
    del empty

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
    want_typo = [want_fig1[0], want_fig1[1], want_fig1[0], []]
    for kind in ("tt", "et", "ht"):
        for opt in ({}, {"compression": "packed", "cache_k": 4}):
            got = rt.build_index(*fig1, kind=kind, device=dev, edit_budget=1,
                                 **opt).complete(["andrw pa", "wiliam sm",
                                                  "andy pz", "xyz"], k=3)
            if got != want_typo:
                raise AssertionError(f"Figure 1 typos, {kind} {opt}: {got}")
    log("Figure 1 typos at edit_budget=1: tt/et/ht answers as expected")

    # the profiler's traces of the paths above, taken ahead of phase 5's
    # many keystroke traces: taken after them, traces in the same process
    # have come back empty or partial on an H100 (cause not known), and an
    # empty or partial trace fails the run
    q_plain, ql_plain = batch(usps_small, seed=1)
    cuda_sub = get_substrate("cuda")
    # candidate_topk's two kernels apart, by the profiler
    for q_t, c_t in ((cand_q, cands), (cand_q_bf16, cands_bf16)):
        got = profile_calls(
            lambda: candidate_topk.candidate_topk(q_t, c_t, CAND_K), 10,
            {"candidate_score_select", "candidate_merge"}, "candidate_topk",
            lambda: candidate_topk.launches,
            keep=lambda name: name.startswith("candidate_"))
        log(f"profile candidate_topk {str(c_t.dtype)[6:]} (us a call, 10 "
            "calls): " + ", ".join(f"{k} {t / 10:.2f}"
                                   for k, (_, t) in got.items()))
    # the rule-free walk_batch's device work, by the profiler: one
    # trie_walk_kernel launch a call and nothing else
    by_kernel = profile_calls(
        lambda: cuda_sub.walk_batch(tp, usps_plain.cfg, q_plain, ql_plain),
        10, {"trie_walk_kernel"}, "rule-free walk_batch",
        lambda: trie_walk.launches)
    log("profile rule-free walk_batch (10 calls): " + ", ".join(
        f"{k} {n}x {t:.2f} us" for k, (n, t) in by_kernel.items()))
    # one batch of each USPS plain path under the profiler: the device's
    # busy share of the batch window, and device time by kernel name
    plain_batch = make_workload(usps_small, 512, seed=1)[:B]
    for name, idx, must in (
            ("USPS plain", usps_plain, ("trie_walk_kernel",
                                        "beam_topk_kernel")),
            ("USPS plain cache_k=16", usps_plain_c,
             ("trie_walk_kernel", "topk_select_warp"))):
        service = rt.CompletionService(idx)
        service.complete(plain_batch, k=K)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(BATCH_WINDOW):
                service.complete(plain_batch, k=K)
        log(f"profile {name}, one batch of {B}: "
            f"{batch_trace(prof, name, must)}")

    # -- phase 4b: live serving (the keystroke scheduler, mutations) -----------
    log(f"phase 4b at {time.perf_counter() - t_start:.1f} s")

    def record_all(c):
        # every kernel the path launched (an inexact keystroke's answer
        # comes from complete, whose walk and retry launch too)
        record(c, *[k_name for k_name in counters if c[k_name] > 0],
               by_width=False)

    def no_sync_dispatch(sched):
        """Hold every flush's dispatch (advance, phase 2, the packed
        non-blocking copy) under CUDA's sync debug mode "error": a host
        sync in it raises."""
        dispatch = sched._dispatch

        def guarded(kind):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return dispatch(kind)
            finally:
                torch.cuda.set_sync_debug_mode("default")

        sched._dispatch = guarded

    def flush_trace(name, sched, sessions, must):
        """One full flush (a keystroke of every lane) and its settle
        under the profiler: the CUDA kernels in the window, the device's
        busy share; raises where the trace is empty or lacks the phase-2
        kernel."""
        for s in sessions:
            s.submit(b"a")
        sched.drain()
        n0 = sched.stats.n_flushes
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(BATCH_WINDOW):
                tickets = [s.submit(b"n") for s in sessions]
                sched.drain()
        if sched.stats.n_flushes - n0 != 1 or not all(t.done
                                                      for t in tickets):
            raise AssertionError(f"profile flush {name}: "
                                 f"{sched.stats.n_flushes - n0} flushes")
        kernels = device_kernels(prof, BATCH_WINDOW)
        trace = batch_trace(prof, f"flush {name}", ())
        phase2 = {k: v for k, v in kernels.items()
                  if k in PHASE2_KERNELS[must]}
        if not phase2:
            raise AssertionError(f"profile flush {name}: no "
                                 f"{PHASE2_KERNELS[must]} in the trace: "
                                 f"{sorted(kernels)}")
        log(f"  profile one flush of {sched.block} lanes, {name}: "
            f"{sum(n for n, _ in kernels.values())} CUDA kernels; {trace}")

    # (a) the scheduler against sequential sessions on four paths:
    # serve_zipf's workload and defaults
    n_serve_queries = 16 if args.small else SERVE_QUERIES
    for name, idx, ds, must in (
            ("USPS ET cache_k=16", usps_et_c, usps, "locus_topk_merge"),
            ("USPS ET packed cache_k=16", usps_et_pc, usps,
             "locus_topk_merge"),
            ("USPS ET", usps_et, usps, "beam_topk"),
            ("USPS plain cache_k=16", usps_plain_c, usps_small,
             "topk_select")):
        events = make_keystroke_events(ds, SERVE_SESSIONS, n_serve_queries,
                                       seed=1)
        seq = rt.CompletionService(idx)
        bat = rt.CompletionService(idx, batching=True, block=SERVE_BLOCK,
                                   max_wait_ms=SERVE_WAIT_MS)
        warm = events[:SERVE_WARMUP_EVENTS]
        _replay_sequential(seq, warm, SERVE_SESSIONS, k=K)
        _submit_events(bat, warm, SERVE_SESSIONS, k=K)
        sched = bat.scheduler
        no_sync_dispatch(sched)
        seq.reset_stats()
        bat.reset_stats()
        sched.stats = rt.BatchStats()
        torch.cuda.synchronize()
        reset_counts()
        t = time.perf_counter()
        want = _replay_sequential(seq, events, SERVE_SESSIONS, k=K)
        seq_s = time.perf_counter() - t
        c_seq = counts()
        reset_counts()
        t = time.perf_counter()
        got = _replay_batched(bat, events, SERVE_SESSIONS, k=K)
        bat_s = time.perf_counter() - t
        c_bat = counts()
        st, n = sched.stats, len(want)
        if got != want:
            bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
            raise AssertionError(f"scheduler {name}: batched and sequential "
                                 f"answers differ at keystrokes {bad[:5]}")
        for what, c in (("sequential", c_seq), ("batched", c_bat)):
            if c[must] <= 0 or c["plain"]:
                raise AssertionError(f"scheduler {name} {what}: launches {c}")
        if st.n_keystrokes != n or bat.stats.n_keystrokes != n:
            raise AssertionError(f"scheduler {name}: {st.n_keystrokes} "
                                 f"keystrokes flushed, {n} typed")
        record_all(c_seq)
        record_all(c_bat)
        log(f"scheduler {name}: {n} keystrokes of {SERVE_SESSIONS} sessions "
            f"({n_serve_queries} queries), k={K}, block {SERVE_BLOCK}, "
            f"max_wait_ms {SERVE_WAIT_MS}: every keystroke batched equals "
            f"sequential; sequential {seq_s / n * 1e6:.1f} us a keystroke "
            f"(p50 {seq.stats.p50_keystroke_ms():.3f}, p99 "
            f"{seq.stats.p99_keystroke_ms():.3f} ms), batched "
            f"{bat_s / n * 1e6:.1f} us a keystroke (p50 "
            f"{bat.stats.p50_keystroke_ms():.3f}, p99 "
            f"{bat.stats.p99_keystroke_ms():.3f} ms), "
            f"{seq_s / bat_s:.2f}x; {st.n_flushes} flushes ({st.full_flushes} "
            f"full, {st.deadline_flushes} deadline, {st.forced_flushes} "
            f"forced), mean occupancy {st.mean_occupancy:.2f}, "
            f"{st.fallbacks} fallbacks, {st.rejected} rejected; no host "
            f"sync in any flush's dispatch; launches sequential "
            f"{ {k: v for k, v in c_seq.items() if k != 'widths' and v} }, "
            f"batched { {k: v for k, v in c_bat.items() if k != 'widths' and v} }")
        trace_sessions = [bat.open_session(k=K) for _ in range(SERVE_BLOCK)]
        flush_trace(name, sched, trace_sessions, must)
        for s in trace_sessions:
            s.close()
        del seq, bat, sched
    log(f"scheduler done at {time.perf_counter() - t_start:.1f} s")

    # (b) churn: serve_churn's loop on USPS ET 100k with cache_k=16 — a
    # mutation batch every CHURN_EVERY events, compaction at a backlog of
    # COMPACT_AT, the scheduler's lanes migrating across each swap
    # (built in phase 2's worker processes)
    events = make_keystroke_events(usps_small, SERVE_SESSIONS,
                                   16 if args.small else CHURN_QUERIES,
                                   seed=1)
    svc = rt.CompletionService(churn_idx, batching=True, block=SERVE_BLOCK,
                               max_wait_ms=SERVE_WAIT_MS)
    rng = np.random.default_rng(2)
    base_strings = list(churn_idx.strings)
    deleted = set()
    churn = {"insert": 0, "delete": 0, "rescore": 0, "n_hot": 0,
             "mut_s": 0.0, "compact_s": [], "fold": [],
             "seen": 0, "open": [], "held": 0}
    compact_at = 8 if args.small else COMPACT_AT

    def hold_resolved(tickets):
        """Every ticket resolved since the last mutation against
        ``complete`` on its prefix now: no mutation has landed since it
        was answered, so the index's state is the one it was answered
        on."""
        churn["open"] += range(churn["seen"], len(tickets))
        churn["seen"] = len(tickets)
        ready = [j for j in churn["open"] if tickets[j].done]
        churn["open"] = [j for j in churn["open"] if not tickets[j].done]
        if not ready:
            return
        want = churn_idx.complete([tickets[j].prefix for j in ready], k=K)
        bad = [j for j, w in zip(ready, want) if tickets[j].results != w]
        if bad:
            raise AssertionError(f"churn: keystrokes {bad[:5]} answer "
                                 "otherwise than complete on their prefix")
        churn["held"] += len(ready)

    def churn_step(i, tickets):
        if not i or i % CHURN_EVERY:
            return
        hold_resolved(tickets)
        m = time.perf_counter()
        churn_idx.insert(b"zz~trending-%d" % churn["n_hot"],
                         int(rng.integers(1, 1000)))
        churn["n_hot"] += 1
        churn["insert"] += 1
        victim = base_strings[int(rng.integers(len(base_strings)))]
        if victim not in deleted:
            churn_idx.delete(victim)
            deleted.add(victim)
            churn["delete"] += 1
        target = base_strings[int(rng.integers(len(base_strings)))]
        if target not in deleted:
            churn_idx.update_score(target, int(rng.integers(1, 1000)))
            churn["rescore"] += 1
        churn["mut_s"] += time.perf_counter() - m
        if churn_idx.mutation_backlog >= compact_at:
            # probe answers on the typed prefixes' heads across the fold
            probe = sorted({bytes(tk.prefix)[:3] for tk in tickets})[:24]
            pre = churn_idx.complete(probe, k=K)
            m = time.perf_counter()
            svc.compact()
            churn["compact_s"].append(time.perf_counter() - m)
            churn["fold"].append((len(probe),
                                  churn_idx.complete(probe, k=K) == pre))

    reset_counts()
    t = time.perf_counter()
    tickets = _submit_events(svc, events, SERVE_SESSIONS, k=K,
                             before=churn_step)
    churn_s = time.perf_counter() - t
    c_churn = counts()
    lost = sum(tk.results is None for tk in tickets)
    if not lost:
        hold_resolved(tickets)
    st = svc.scheduler.stats
    n_mut = churn["insert"] + churn["delete"] + churn["rescore"]
    log(f"churn USPS ET cache_k=16: {len(tickets)} keystrokes in "
        f"{churn_s:.3f} s ({churn_s / len(tickets) * 1e6:.1f} us a "
        f"keystroke, p50 {svc.stats.p50_keystroke_ms():.3f}, p99 "
        f"{svc.stats.p99_keystroke_ms():.3f} ms); mutations "
        f"{ {k: churn[k] for k in ('insert', 'delete', 'rescore')} }, "
        f"{churn['mut_s'] / max(n_mut, 1) * 1e3:.3f} ms a mutation call; "
        f"compactions {len(churn['compact_s'])} mid-stream ("
        + ", ".join(f"{s:.3f} s" for s in churn["compact_s"])
        + f"), probes equal across each fold "
        f"{[f'{n}: {same}' for n, same in churn['fold']]}, migrations "
        f"{st.migrations}, lost keystrokes {lost}, {churn['held']} "
        f"keystrokes equal complete on their prefix, "
        f"{st.n_flushes} flushes, mean occupancy {st.mean_occupancy:.2f}, "
        f"{st.fallbacks} fallbacks, backlog {churn_idx.mutation_backlog}, "
        f"launches { {k: v for k, v in c_churn.items() if k != 'widths' and v} }")
    if lost or not churn["compact_s"] or st.migrations < 1:
        raise AssertionError(f"churn: lost {lost} keystrokes, "
                             f"{len(churn['compact_s'])} compactions, "
                             f"{st.migrations} migrations")
    if churn["held"] != len(tickets):
        raise AssertionError(f"churn: {churn['held']} of {len(tickets)} "
                             "keystrokes held against complete")
    if not all(same for _, same in churn["fold"]):
        raise AssertionError("churn: answers changed across a fold")
    for k_name in ("locus_dp", "topk_select"):   # the walk, the merge
        if c_churn[k_name] <= 0:
            raise AssertionError(f"churn: {k_name} never launched")
    if c_churn["plain"]:
        raise AssertionError("churn: a plain version ran")
    record_all(c_churn)
    if not churn_idx.has_mutations:
        raise AssertionError("churn: no mutation pending at the stream's end")

    def mutated_batch(name, idx, ds, must, n_check=None):
        """The 512-query batch workload on a mutated index through the
        service: launches, p50/p99, answers on cuda equal the torch
        substrate's (the first ``n_check``)."""
        out = main_path(name, idx, ds, must, n_check=n_check)
        if out["topk_select"] <= 0:
            raise AssertionError(f"{name}: the overlay merge never ran")
        record_all(out)
        return out

    mutated_batch("USPS ET cache_k=16 churned", churn_idx, usps_small,
                  ("locus_dp", "topk_select"))
    del svc, churn_idx

    # (c) mutations on USPS ET 1M packed with cache_k=16 (a copy of the
    # phase-4 index on the card): inserts that synonym rules reach,
    # deletes and re-scores of strings in the workload's top-10s
    mut = rt.CompletionIndex.from_parts(
        usps_et_pc.trie, usps_et_pc.rule_trie, usps_et_pc.rules,
        usps_et_pc.strings, usps_et_pc.scores, usps_et_pc.cfg, device=dev,
        spec=usps_et_pc.spec, stats=usps_et_pc.stats)
    reset_counts()
    main_path("USPS ET packed cache_k=16 unmutated", mut, usps,
              ("locus_dp_packed", "locus_topk_merge"), n_check=0)
    top = sorted({s for row in answers["USPS ET packed cache_k=16 unmutated"]
                  for _, s in row})
    hits = [s for i, s in enumerate(top) if i % 2 == 0][:N_MUTATE]
    rescored = [s for i, s in enumerate(top) if i % 2 == 1][:N_MUTATE]
    firsts = ("andrew", "robert", "william", "michael")
    t = time.perf_counter()
    for i in range(N_MUTATE):
        mut.insert(f"{firsts[i % 4]} zz{i:02d} {1000 + i} park avenue "
                   f"hillville california", 50_001 + i)
    for s in hits:
        mut.delete(s)
    for i, s in enumerate(rescored):
        mut.update_score(s, 1 + i)
    calls_s = time.perf_counter() - t
    t = time.perf_counter()
    live = mut.live_strings            # the overlay's refresh
    refresh_s = time.perf_counter() - t
    log(f"mutate USPS ET packed cache_k=16: {3 * N_MUTATE} mutation calls "
        f"{calls_s * 1e3:.3f} ms, refresh (ranks over {len(live)} live "
        f"strings, the side index) {refresh_s:.3f} s, backlog "
        f"{mut.mutation_backlog}")
    # the base over-fetched past cache_k (the packed beam), the side index
    # (dense, the rules applied), the merge
    mutated_batch("USPS ET packed cache_k=16 mutated", mut, usps,
                  ("locus_dp_packed", "beam_topk_packed", "locus_dp",
                   "topk_select"), n_check=N_MUTATED_TORCH)
    got = answers["USPS ET packed cache_k=16 mutated"]
    shown = {s for row in got for _, s in row}
    if shown & set(hits) or not any(s.startswith(firsts) and " zz" in s
                                    for s in shown):
        raise AssertionError("mutated answers show a deleted string or no "
                             "inserted one")
    log("  mutated answers: no deleted string, "
        f"{sum(' zz' in s for s in shown)} inserted strings shown")
    del mut
    log(f"live serving done at {time.perf_counter() - t_start:.1f} s")

    # -- phase 5d: training ----------------------------------------------------------
    # run here, after phase 4b: from phase 4c on the card holds ~15 GB more
    # (37.1 GB allocated by the end of phase 5c, where danube's step, 47.0
    # GB above the resident, ran out of memory), and traces taken after
    # phase 5's keystroke traces have come back empty (ROADMAP §3)
    log(f"phase 5d at {time.perf_counter() - t_start:.1f} s")
    training = training_phase(dev, args.small, reset_counts, counts,
                              train_main)
    record(training["launches"], "embedding_bag", "embedding_bag_backward",
           by_width=False)
    log(f"training done at {time.perf_counter() - t_start:.1f} s")

    # -- phase 4c: the sharded index and the serving launcher ------------------
    log(f"phase 4c at {time.perf_counter() - t_start:.1f} s")
    import torch.distributed as tdist
    from torch.distributed.device_mesh import init_device_mesh

    # the cross-shard merges: (shape, k) of every topk_select call, and
    # the last [B, S*k] inputs (timed in phase 6)
    merge_shapes, merge_inputs = [], []
    select = topk_select.topk_select

    def recording_select(scores, payload, k):
        merge_shapes.append((tuple(scores.shape), k))
        merge_inputs[:] = [scores, payload]
        return select(scores, payload, k)

    def sharded_path(name, idx, queries, k, must, n_shards, n_check):
        """``queries`` through ``CompletionService(idx).complete`` in
        batches of B after one warm-up batch: per batch each shard's
        ``must`` kernels once and one merge at [B, n_shards * k], no
        plain version; the first ``n_check`` answers equal the torch
        substrate's over the same stacked tables."""
        batches = [queries[i:i + B] for i in range(0, len(queries), B)]
        service = rt.CompletionService(idx)
        service.complete(batches[0], k=k)            # warm-up
        service.reset_stats()
        torch.cuda.synchronize()
        inexact = idx.inexact
        reset_counts()
        merge_shapes.clear()
        topk_select.topk_select = recording_select
        lat, results = [], []
        for b in batches:
            t = time.perf_counter()
            results += service.complete(b, k=k)
            lat.append((time.perf_counter() - t) * 1e3)
        topk_select.topk_select = select
        c = counts()
        st, lat = service.stats, sorted(lat)
        hits = sum(1 for r in results if r) / len(results)
        log(f"sharded {name}: {st.n_queries} queries in {st.batches} "
            f"batches of {B}, k={k}: "
            f"{st.total_seconds / st.n_queries * 1e6:.1f} us/completion, "
            f"batch p50 {lat[len(lat) // 2]:.3f} ms, p99 "
            f"{lat[min(int(len(lat) * 0.99), len(lat) - 1)]:.3f} ms, hit "
            f"rate {hits:.4f}, inexact shard answers "
            f"{idx.inexact - inexact}, merges {sorted(set(merge_shapes))}, "
            f"launches { {k_: v for k_, v in c.items() if k_ != 'widths' and v} }")
        n_b = len(batches)
        for k_name in must:
            if c[k_name] != n_shards * n_b:
                raise AssertionError(f"sharded {name}: {c[k_name]} "
                                     f"{k_name} launches, not {n_shards} "
                                     f"shards x {n_b} batches")
        if c["topk_select"] != n_b or c["plain"] \
                or set(merge_shapes) != {((B, n_shards * k), k)}:
            raise AssertionError(f"sharded {name}: merges {merge_shapes}, "
                                 f"launches {c}")
        record_all(c)
        if n_check:
            cfg = idx.cfg
            idx.cfg = replace(cfg, substrate="torch")
            want = [r for i in range(0, n_check, B)
                    for r in idx.complete(queries[i:i + B], k=k)]
            idx.cfg = cfg
            if results[:n_check] != want:
                bad = [i for i, (x, y) in enumerate(zip(results, want))
                       if x != y]
                raise AssertionError(f"sharded {name}: cuda and torch "
                                     f"substrates differ on queries "
                                     f"{bad[:5]}")
            log(f"  sharded {name}: cuda answers equal the torch "
                f"substrate's ({n_check} queries)")
        return results

    def same_scores(name, got, want, k):
        """Scores equal row for row; strings equal but inside a run of
        equal scores that k cuts (shards break ties by shard, the
        unsharded index by string)."""
        bad, cut = [], 0
        for i, (g, w) in enumerate(zip(got, want)):
            if [x for x, _ in g] != [x for x, _ in w]:
                bad.append(i)
                continue
            for score in {x for x, _ in w}:
                if sorted(y for x, y in g if x == score) != \
                        sorted(y for x, y in w if x == score):
                    if len(w) == k and score == w[-1][0]:
                        cut += 1
                    else:
                        bad.append(i)
        if bad:
            raise AssertionError(f"sharded {name}: scores or strings differ "
                                 f"from the unsharded index's on queries "
                                 f"{bad[:5]}")
        log(f"  sharded {name}: scores equal the unsharded index's on "
            f"{len(got)} queries (strings differ in {cut} runs of equal "
            "scores cut by k)")

    # (a) USPS ET 1M over 16 shards, cache_k=16, dense, in one process
    # (its shards built in phase 2's worker processes; one after another
    # they take ~150 s)
    t = time.perf_counter()
    shards = [rt.CompletionIndex.from_parts(
        trie, rule_trie, rules, strings, scores, cfg, device=dev, spec=spec,
        stats=stats)
        for trie, rule_trie, rules, strings, scores, cfg, spec, stats
        in shard_parts]
    del shard_parts
    sharded = rt.ShardedCompletionIndex.from_shards(shards)
    torch.cuda.synchronize()
    wrap_s = time.perf_counter() - t
    n_usps = len(usps.strings)
    log(f"sharded USPS ET ({n_usps} strings, {SHARDS} shards, cache_k=16): "
        f"built in phase 2's worker processes ("
        f"{sum(b - a for a, b in shard_spans):.1f} s of builds, "
        f"{min(a for a, _ in shard_spans):.1f}-"
        f"{max(b for _, b in shard_spans):.1f} s in), onto the card and "
        f"stacked "
        f"in {wrap_s:.1f} s; strings a shard "
        f"{min(len(x) for x in sharded.shard_strings)}-{sharded.stride}, "
        f"empty shards {sum(sharded.empty)}; stacked tables "
        f"{device_bytes(sharded)} B on the card = "
        f"{device_bytes(sharded) / n_usps:.1f} B/string with the padding "
        f"(unsharded {device_bytes(usps_et_c) / n_usps:.1f}; the shards' "
        f"own tables {sum(device_bytes(x) for x in shards) / n_usps:.1f}), "
        f"substrate {sharded.cfg.substrate}")
    if sharded.cfg.substrate != "cuda" or not sharded.cfg.use_cache:
        raise AssertionError(f"sharded USPS ET: config {sharded.cfg}")
    workload = make_workload(usps, 512, seed=1)
    got = sharded_path("USPS ET 16 shards cache_k=16", sharded, workload, K,
                       ("locus_dp", "locus_topk_merge"), SHARDS,
                       SHARD_TORCH_QUERIES)
    same_scores("USPS ET 16 shards cache_k=16", got,
                answers["USPS ET cache_k=16"], K)
    shard_merge = list(merge_inputs)
    # one sharded batch under the profiler: the device's busy share and
    # its kernels by name
    service = rt.CompletionService(sharded)
    service.complete(workload[:B], k=K)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(BATCH_WINDOW):
            service.complete(workload[:B], k=K)
    log(f"profile sharded USPS ET 16 shards, one batch of {B}: "
        + batch_trace(prof, "sharded USPS ET", ("locus_dp_kernel",
                                                 "merge_warp",
                                                 "topk_select_warp")))
    beam_q = workload[:SHARD_BEAM_QUERIES]
    got = sharded_path(f"USPS ET 16 shards k={SHARD_K_BEAM}", sharded,
                       beam_q, SHARD_K_BEAM, ("locus_dp", "beam_topk"),
                       SHARDS, SHARD_BEAM_QUERIES)
    same_scores(f"USPS ET 16 shards k={SHARD_K_BEAM}", got,
                usps_et_c.complete(beam_q, k=SHARD_K_BEAM), SHARD_K_BEAM)
    log(f"  sharded USPS ET: {sharded.inexact} inexact shard answers in "
        "all (returned without a retry)")
    del sharded, shards, got
    torch.cuda.empty_cache()
    log(f"  (a) done at {time.perf_counter() - t_start:.1f} s")

    # (b) the mesh path at world size 1 over NCCL, USPS ET 1M cache_k=16
    # as its one shard, against the local mode over the same shard
    torch.cuda.set_device(dev.index or 0)
    tdist.init_process_group("nccl", init_method="tcp://localhost:"
                             f"{free_port()}", world_size=1, rank=0)
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    t = time.perf_counter()
    meshed = rt.ShardedCompletionIndex.from_shards([usps_et_c], mesh=mesh)
    local1 = rt.ShardedCompletionIndex.from_shards([usps_et_c])
    torch.cuda.synchronize()
    log(f"mesh {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))} over "
        f"{tdist.get_backend()}, world size {tdist.get_world_size()}: both "
        f"wrappers of USPS ET cache_k=16 made in "
        f"{time.perf_counter() - t:.1f} s")
    got_mesh = sharded_path("USPS ET 1 shard over the mesh", meshed, workload,
                            K, ("locus_dp", "locus_topk_merge"), 1, 0)
    got_local = sharded_path("USPS ET 1 shard local", local1, workload, K,
                             ("locus_dp", "locus_topk_merge"), 1, 0)
    if got_mesh != got_local:
        bad = [i for i, (x, y) in enumerate(zip(got_mesh, got_local))
               if x != y]
        raise AssertionError(f"mesh and local modes differ on queries "
                             f"{bad[:5]}")
    log(f"  mesh path: answers equal the local mode's ({len(got_mesh)} "
        "queries)")
    del meshed, local1, got_mesh, got_local
    tdist.destroy_process_group()
    torch.cuda.empty_cache()
    log(f"  (b) done at {time.perf_counter() - t_start:.1f} s")

    # (c) save and load a small sharded index: DBLP TT over 3 shards
    t = time.perf_counter()
    dblp_sh = rt.ShardedCompletionIndex(
        dblp.strings, dblp.scores, make_rules(dblp.rules),
        n_shards=DBLP_SHARDS, kind="tt", device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        dblp_sh.save(tmp)
        save_s = time.perf_counter() - t
        size = sum(f.stat().st_size for f in Path(tmp).iterdir())
        t = time.perf_counter()
        loaded = rt.ShardedCompletionIndex.load(tmp, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
    dq = make_workload(dblp, 512, seed=1)[:B]
    reset_counts()
    want = dblp_sh.complete(dq, k=K)
    got = loaded.complete(dq, k=K)
    c = counts()
    if got != want or c["locus_dp"] != 2 * DBLP_SHARDS \
            or c["beam_topk"] != 2 * DBLP_SHARDS or c["plain"]:
        raise AssertionError(f"sharded DBLP TT: loaded answers "
                             f"{'equal' if got == want else 'differ'}, "
                             f"launches {c}")
    record_all(c)
    log(f"sharded DBLP TT ({len(dblp.strings)} strings, {DBLP_SHARDS} "
        f"shards): build {build_s:.3f} s, save {save_s:.3f} s ({size} B), "
        f"load onto the card {load_s:.3f} s; the loaded index answers "
        f"{len(dq)} queries as the original")
    del dblp_sh, loaded
    log(f"  (c) done at {time.perf_counter() - t_start:.1f} s")

    # (d) the serving launcher in process: batch, keystroke, zipf and
    # churn runs that load the container of its default index (USPS ET
    # 100k), built and saved by a worker process in phase 2
    launch_args = ["--arch", "autocomplete-usps"] + (
        ["--n-strings", str(n_usps_plain)] if args.small else [])
    launched_out = {}
    with launch_tmp:
        reset_counts()
        secs = {}
        for w, extra in (("batch", []), ("keystroke", []),
                         ("zipf", ["--repeats", "1"]),
                         ("churn", ["--churn-every",
                                    str(LAUNCH_CHURN_EVERY)])):
            t = time.perf_counter()
            launched_out[w] = serve_main(
                launch_args + ["--workload", w, "--load-index", launch_path]
                + ([] if w == "batch" else
                   ["--queries", str(LAUNCH_QUERIES)]) + extra)
            secs[w] = time.perf_counter() - t
        c = counts()
        loaded = rt.CompletionIndex.load(launch_path, device=dev)
        lq = make_workload(usps_small, 512, seed=1)
        rows = [r for i in range(0, len(lq), B)
                for r in loaded.complete(lq[i:i + B], k=K)]
        del loaded
    hit = round(sum(1 for r in rows if r) / len(rows), 3)
    zipf, churn_out = launched_out["zipf"], launched_out["churn"]
    if not (zipf["bit_identical"] and zipf["fallbacks"] == 0
            and churn_out["verified"] and churn_out["lost_keystrokes"] == 0
            and launched_out["batch"]["hit_rate"] == hit
            and all(o["substrate"] == "cuda"
                    for o in launched_out.values())
            and c["locus_dp"] > 0 and c["beam_topk"] > 0
            and c["plain"] == 0):
        raise AssertionError(f"launcher: {launched_out}, complete's hit "
                             f"rate {hit}, launches {c}")
    record_all(c)
    a, b = spans["USPS ET 100k container"]
    log(f"launcher (python -m repro_torch.launch.serve {' '.join(launch_args)}"
        f" --load-index, its container built and saved in {b - a:.1f} s by "
        f"a worker in phase 2; keystroke, zipf and churn at --queries "
        f"{LAUNCH_QUERIES}, zipf "
        f"--repeats 1, churn --churn-every {LAUNCH_CHURN_EVERY}): seconds "
        f"{ {w: round(x, 1) for w, x in secs.items()} }; zipf bit "
        "identical, 0 fallbacks; churn verified, 0 lost keystrokes; the "
        f"batch hit rate {hit} equals complete's on the loaded container; "
        f"launches { {k_: v for k_, v in c.items() if k_ != 'widths' and v} }")
    log(f"sharding and launcher done at {time.perf_counter() - t_start:.1f} s")

    # -- phase 5: typing sessions, save and load, multi-term completion ---------
    log(f"phase 5 at {time.perf_counter() - t_start:.1f} s")
    n_typed, n_typed_check = (16, 16) if args.small else SESSION_QUERIES
    n_torch_beam = min(n_typed_check, SESSION_QUERIES_TORCH_BEAM)

    def typed(service, queries):
        """Type each query one byte at a time through one ServiceSession,
        reset between queries: the answer after every keystroke."""
        sess = service.open_session(k=K)
        out = []
        for q in queries:
            sess.reset()
            qb = q.encode()
            out.append([sess.type(qb[i:i + 1]) for i in range(len(qb))])
        sess.close()
        return out

    typed_answers = {}

    def session_path(name, idx, ds, must_launch, n_queries, n_check,
                     n_torch=None):
        """``serve_keystroke``'s workload on ``idx``: the first
        ``n_queries`` of the batch workload typed through the service
        after one warm-up query; every keystroke of the first ``n_check``
        held against ``complete`` on its prefix, and of the first
        ``n_torch`` (``n_check`` by default) against the torch
        substrate's session; one keystroke profiled."""
        queries = make_workload(ds, 512, seed=1)[:n_queries]
        service = rt.CompletionService(idx)
        typed(service, queries[:1])                  # warm-up
        service.stats.reset_keystrokes()
        torch.cuda.synchronize()
        reset_counts()
        t = time.perf_counter()
        got = typed(service, queries)
        wall = time.perf_counter() - t
        c = counts()
        st = service.stats
        keys = [r for q in got for r in q]
        hits = sum(1 for r in keys if r) / len(keys)
        log(f"session {name}: {len(queries)} queries, {st.n_keystrokes} "
            f"keystrokes, k={K}: {st.mean_keystroke_ms:.3f} ms a keystroke "
            f"(p50 {st.p50_keystroke_ms():.3f}, p99 "
            f"{st.p99_keystroke_ms():.3f}), {st.n_keystrokes / st.keystroke_seconds:.1f} "
            f"keystrokes/s ({wall:.2f} s wall), hit rate {hits:.4f}, "
            f"launches { {k: v for k, v in c.items() if k != 'widths'} }, "
            "by width " + ", ".join(
                f"{k[0]} E={k[1]} {'F' if 'locus' in k[0] else 'W'}={k[2]}: "
                f"{v}" for k, v in sorted(c["widths"].items())))
        if st.n_keystrokes != len(keys):
            raise AssertionError(f"session {name}: {st.n_keystrokes} "
                                 f"keystrokes counted, {len(keys)} typed")
        for k_name in must_launch:
            if c[k_name] <= 0:
                raise AssertionError(f"session {name}: {k_name} never "
                                     "launched")
        if c["plain"]:
            raise AssertionError(f"session {name}: a plain version ran")
        t = time.perf_counter()
        for qi, q in enumerate(queries[:n_check]):
            qb = q.encode()
            want = idx.complete([qb[:i + 1] for i in range(len(qb))], k=K)
            if got[qi] != want:
                bad = next(i for i, (a, b) in enumerate(zip(got[qi], want))
                           if a != b)
                raise AssertionError(f"session {name}: query {qi} differs "
                                     f"from complete at keystroke {bad}")
        t_complete = time.perf_counter() - t
        n_torch = n_check if n_torch is None else n_torch
        t = time.perf_counter()
        idx.reconfigure(substrate="torch")
        want = typed(rt.CompletionService(idx), queries[:n_torch])
        idx.reconfigure(substrate="cuda")
        if got[:n_torch] != want:
            bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
            raise AssertionError(f"session {name}: cuda and torch sessions "
                                 f"differ on queries {bad[:5]}")
        t_torch = time.perf_counter() - t
        t = time.perf_counter()
        session_trace(name, idx, queries[0].encode(), must_launch[-1])
        log(f"  {name}: every keystroke of {n_check} queries equals complete "
            f"on its prefix ({t_complete:.1f} s), of {n_torch} the torch "
            f"substrate's session ({t_torch:.1f} s); trace "
            f"{time.perf_counter() - t:.1f} s")
        typed_answers[name] = got
        return c

    def session_trace(name, idx, qb, phase2_counter):
        """One keystroke in the middle of ``qb``: no host sync in init and
        advance (CUDA's sync debug mode), the advance's kernels (profiler),
        and the whole keystroke's device busy share and the time of its
        phase-2 kernel (that of ``phase2_counter``); raises where the
        trace lacks either."""
        sess = idx.session(k=K)
        mid = len(qb) // 2
        sess.type(qb[:mid])
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                st = sess._init()
                for b in qb:
                    st = sess._advance(st, b)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = [w for w in caught
                 if "called a synchronizing" in str(w.message)]
        if syncs:
            raise AssertionError(f"session {name}: init/advance synchronised "
                                 f"{len(syncs)} times: {syncs[0].message}")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(ADVANCE_WINDOW):
                sess._advance(sess._states[-1], qb[mid])
                torch.cuda.synchronize()
            with record_function(BATCH_WINDOW):
                sess.type(qb[mid:mid + 1])
        adv = device_kernels(prof, ADVANCE_WINDOW)
        n_adv = sum(n for n, _ in adv.values())
        if not adv:
            raise AssertionError(f"profile {name}: no device events in the "
                                 "advance's trace")
        label = f"{name}, keystroke {mid + 1} of {qb!r}"
        keystroke = batch_trace(prof, label)
        phase2 = {k: v for k, v in device_kernels(prof, BATCH_WINDOW).items()
                  if k in PHASE2_KERNELS[phase2_counter]}
        if not phase2:
            raise AssertionError(f"profile {label}: no "
                                 f"{PHASE2_KERNELS[phase2_counter]} in the "
                                 "trace")
        log(f"  profile {label}: advance {n_adv} CUDA kernels "
            f"({sum(t for _, t in adv.values()):.1f} us device), most: "
            + ", ".join(f"{k} {n}x" for k, (n, _) in sorted(
                adv.items(), key=lambda x: -x[1][0])[:6])
            + f"; the keystroke: {keystroke}; phase 2: "
            + ", ".join(f"{k} {n}x {t:.2f} us" for k, (n, t) in
                        phase2.items())
            + f"; no host sync in init/advance ({len(qb)} advances)")

    # (a) typing sessions on the built indexes, B=1 a keystroke
    for name, idx, ds, phase2 in (
            ("USPS ET cache_k=16", usps_et_c, usps, "locus_topk_merge"),
            ("USPS ET", usps_et, usps, "beam_topk"),
            ("USPS ET packed cache_k=16", usps_et_pc, usps,
             "locus_topk_merge"),
            ("USPS plain cache_k=16", usps_plain_c, usps_small,
             "topk_select")):
        record_all(session_path(
            name, idx, ds, (phase2,), n_typed, n_typed_check,
            n_torch=n_torch_beam if phase2 == "beam_topk" else None))
    usps_et_c.reconfigure(edit_budget=1)
    record_all(session_path("USPS ET cache_k=16 E=1", usps_et_c, usps,
                            ("locus_topk_merge",), n_typed, n_typed_check))
    usps_et_c.reconfigure(edit_budget=0)
    # a rule-bearing trie (the link store: the advance's loop over the
    # lhs history and each rule-trie node's rules), one keystroke traced
    session_trace("DBLP TT", dblp_tt,
                  make_workload(dblp, 512, seed=1)[0].encode(), "beam_topk")
    log(f"sessions done at {time.perf_counter() - t_start:.1f} s")

    # (b) save and load: the container round trip onto the card, answers
    # held against the original index's (the containers written beside
    # phase 3)
    with save_tmp:
        for name, idx, ds, must in (
                ("USPS ET packed cache_k=16", usps_et_pc, usps,
                 ("locus_dp_packed", "locus_topk_merge")),
                ("USPS plain", usps_plain, usps_small,
                 ("trie_walk_loci", "beam_topk"))):
            path, save_s, size = saved[name]
            t = time.perf_counter()
            loaded = rt.CompletionIndex.load(path, device=dev)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t
            log(f"save/load {name}: save {save_s:.3f} s (beside phase 3), "
                f"container {size} B ({size / len(idx.strings):.1f} "
                f"B/string), load onto the card {load_s:.3f} s, "
                f"{device_bytes(loaded)} B on the card (the original "
                f"{device_bytes(idx)} B), epoch {loaded.epoch}, substrate "
                f"{loaded.substrate}; loaded index's batch answers held "
                "against the original's below")
            if loaded.substrate != "cuda" or \
                    device_bytes(loaded) != device_bytes(idx):
                raise AssertionError(f"save/load {name}: the loaded index "
                                     "differs from the original")
            record_all(main_path(f"{name} loaded", loaded, ds, must,
                                 n_check=0))
            same_answers(f"{name} loaded", name)
            del loaded
            Path(path).unlink()

    log(f"save/load done at {time.perf_counter() - t_start:.1f} s")

    # (c) multi-term completion: the JAX package's own example, then DBLP
    mt_spec = dict(kind="multiterm", frontier=32, gens=32, expand=4,
                   max_steps=128, multiterm_gap=2)
    for opt, walk in (({}, "locus_dp"),
                      ({"compression": "packed"}, "locus_dp_packed")):
        mt = rt.build_index(MT_STRINGS, MT_SCORES, [], device=dev,
                            **mt_spec, **opt)
        reset_counts()
        got = mt.complete(list(MT_EXPECT), k=5)
        got_s = [mt.session(k=5).type(q) for q in MT_EXPECT]
        c = counts()
        if got != list(MT_EXPECT.values()) or got_s != got:
            raise AssertionError(f"multiterm example {opt}: {got} / {got_s}")
        if c[walk] <= 0 or c["plain"]:
            raise AssertionError(f"multiterm example {opt}: launches {c}")
        record_all(c)
    log("multiterm example (tests/test_modes.py MT_EXPECT): complete and "
        "sessions as expected, dense and packed")
    for comp, must in (("none", ("locus_dp", "beam_topk")),
                       ("packed", ("locus_dp_packed", "beam_topk_packed"))):
        name = f"DBLP multiterm {comp}"
        idx = mt_indexes.pop(name)
        a, b = spans[name]
        log(f"{name} ({len(dblp_mt.strings)} strings, "
            f"{len(dblp_mt.rules)} rules): built in {b - a:.3f} s by a "
            f"phase-2 worker, "
            f"{len(idx.rules) - len(dblp_mt.rules)} rules synthesized, "
            f"{idx.stats.n_nodes} nodes, tele_width {idx.cfg.tele_width}, "
            f"branch_width {idx.cfg.branch_width}, "
            f"{idx.stats.bytes_per_string:.1f} B/string built, "
            f"{device_bytes(idx)} B on the card")
        record_all(main_path(name, idx, dblp_mt, must, n_check=64))
        if comp == "none":
            record_all(session_path(name, idx, dblp_mt, must[1:], 16, 16,
                                    n_torch=2))
        else:
            # node ids are shared: the packed sessions answer as the dense
            record_all(session_path(name, idx, dblp_mt, must[1:], 16, 16,
                                    n_torch=0))
            if typed_answers[name] != typed_answers["DBLP multiterm none"]:
                raise AssertionError(f"{name}: sessions differ from the "
                                     "dense layout's")
            log(f"  {name}: every keystroke equals the dense layout's")
        if comp == "packed":
            same_answers(name, "DBLP multiterm none")
        del idx

    # -- phase 5b: LM serving ------------------------------------------------------
    log(f"phase 5b at {time.perf_counter() - t_start:.1f} s")
    lm_phase(dev, args.small, counts, serve_main)
    log(f"LM serving done at {time.perf_counter() - t_start:.1f} s")

    # -- phase 5c: the recsys and GNN models ----------------------------------------
    log(f"phase 5c at {time.perf_counter() - t_start:.1f} s")
    models = models_phase(dev, args.small, reset_counts, counts, serve_main,
                          products)
    del products
    record(models["launches"], "candidate_topk", "embedding_bag",
           by_width=False)
    log(f"recsys and GNN models done at {time.perf_counter() - t_start:.1f} s")

    # -- phase 6: kernel times and bounds at the main path's shapes ---------------
    log(f"phase 6 at {time.perf_counter() - t_start:.1f} s")
    q, ql = batch(usps, seed=1)
    t_et, cfg_et = usps_et.tensors, usps_et.cfg
    t_etp, cfg_etp = usps_et_p.tensors, usps_et_p.cfg
    t_pc = usps_et_pc.tensors
    loci_et = locus_dp.locus_dp_walk(t_et, cfg_et, q, ql)[0]
    loci_etp = locus_dp.locus_dp_walk(t_etp, cfg_etp, q, ql)[0]
    node, depth = trie_walk.trie_walk(tp.first_child, tp.edge_char,
                                      tp.edge_child, q_plain, ql_plain)
    loci_plain = trie_walk.trie_walk_loci(tp.first_child, tp.edge_char,
                                          tp.edge_child, q_plain, ql_plain,
                                          1)[0]
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

    def cand_library():
        top = torch.topk(torch.mv(cands, cand_q), CAND_K)
        return top.values, top.indices

    bag_dense = ops.densify_bags(bag_idx, bag_off, bag_w, None,
                                 torch.float32, dev)
    # the bound reads each distinct row once, and its operations count
    # every valid entry
    n_valid = int((bag_idx >= 0).sum())
    n_rows_read = int(torch.unique(bag_idx[bag_idx >= 0]).numel())

    def bag_library():
        return torch.nn.functional.embedding_bag(
            bag_idx, bag_table, bag_off, mode="sum",
            per_sample_weights=bag_w, include_last_offset=True)

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
        ("candidate_topk", "src/repro_torch/kernels/csrc/candidate_topk.cu",
         "src/repro/kernels/candidate_topk.py:51",
         lambda: candidate_topk.candidate_topk(cand_q, cands, CAND_K),
         lambda: candidate_topk.candidate_topk_plain(cand_q, cands, CAND_K),
         cand_library,
         # the candidates and the query read once, the top-k written once;
         # a multiply-add per candidate value
         n_cand * CAND_D * 4 + CAND_D * 4 + CAND_K * 8,
         2 * n_cand * CAND_D),
        ("embedding_bag", "src/repro_torch/kernels/csrc/embedding_bag.cu",
         "src/repro/kernels/embedding_bag.py:41",
         # the ops path's entry: the ragged batch as it is
         lambda: embedding_bag.embedding_bag_ragged(bag_table, bag_idx,
                                                    bag_off, bag_w),
         lambda: embedding_bag.embedding_bag_dense_plain(
             bag_table, *ops.densify_bags(bag_idx, bag_off, bag_w, None,
                                          torch.float32, dev)),
         bag_library,
         # one float32 table row per valid index, the indices, weights and
         # offsets, the output; a multiply-add per gathered value
         n_rows_read * BAG_D * 4 + n_idx * 8 + (BAGS + 1) * 4
         + BAGS * BAG_D * 4,
         2 * n_valid * BAG_D),
    ]
    saved = counts()
    for name, source, replaces, kern, plain, library, nbytes, n_ops in specs:
        ms = cuda_ms(kern, 20)
        plain_ms = cuda_ms(plain, 3)
        library_ms = cuda_ms(library, 20) if library else None
        bound_ms, bound_by = bound(nbytes, n_ops)
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launched[name],
                     "max_abs_err": MAX_ABS_ERR[name], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms})
        log(f"time {name}: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, "
            f"library {library_ms if library_ms is None else f'{library_ms:.4f} ms'}, "
            f"bound {bound_ms:.6f} ms ({bound_by}, {nbytes} B, {n_ops} ops)")
    log("time locus_topk_merge on the dense cache, same loci: "
        f"{cuda_ms(lambda: locus_merge.locus_topk_merge(tc, loci_et, K), 20):.4f}"
        " ms")
    # the other entries and types of rows 12-13
    bf16_bound, _ = bound(n_cand * CAND_D * 2 + CAND_D * 2 + CAND_K * 8,
                          2 * n_cand * CAND_D)
    bf16_ms = cuda_ms(lambda: candidate_topk.candidate_topk(
        cand_q_bf16, cands_bf16, CAND_K), 20)
    log(f"time candidate_topk bfloat16: {bf16_ms:.4f} ms kernel, bound "
        f"{bf16_bound:.6f} ms (bytes, {n_cand * CAND_D * 2} B)")
    dense_bound, _ = bound(n_rows_read * BAG_D * 4
                           + bag_dense[0].numel() * 8 + BAGS * BAG_D * 4,
                           2 * n_valid * BAG_D)
    dense_ms = cuda_ms(lambda: embedding_bag.embedding_bag_dense(
        bag_table, *bag_dense), 20)
    log(f"time embedding_bag dense entry: {dense_ms:.4f} ms kernel, bound "
        f"{dense_bound:.6f} ms (bytes)")
    # rows 12-13 at the models' widths (phase 5c's tensors): candidate_topk
    # at DIN's D=18 and SASRec's D=50 over their 1M items (k=100; rows of
    # 72 and 200 bytes take the scalar loads), on a random query of the
    # width as the D=64 row; DIN's pooled history, embedding_bag_dense at
    # [512, 100] over items [1M, 18], the library's form over the same
    # bags (pads at row 0 with weight 0)
    gen6 = torch.Generator(device=dev).manual_seed(11)
    model_rows = {"candidate_topk": [], "embedding_bag": []}
    for arch, (cands_m, _) in models["cands"].items():
        C_m, D_m = cands_m.shape
        q_m = torch.randn(D_m, generator=gen6, device=dev)
        model_rows["candidate_topk"].append((
            f"{arch} D={D_m} C={C_m} k={RETRIEVAL_K}",
            lambda c=cands_m, q=q_m: candidate_topk.candidate_topk(
                q, c, RETRIEVAL_K),
            lambda c=cands_m, q=q_m: candidate_topk.candidate_topk_plain(
                q, c, RETRIEVAL_K),
            lambda c=cands_m, q=q_m: torch.topk(torch.mv(c, q), RETRIEVAL_K),
            C_m * D_m * 4 + D_m * 4 + RETRIEVAL_K * 8, 2 * C_m * D_m))
    items_m, bag_m, w_m = models["din"]
    bag_lib = bag_m.clamp(min=0).long()
    n_valid_m = int((bag_m >= 0).sum())
    # zipf draws: most entries repeat a row the bag's bound reads once
    n_rows_m = int(torch.unique(bag_m[bag_m >= 0]).numel())
    D_m = int(items_m.shape[1])
    log(f"DIN pooled history: {n_valid_m} valid entries read {n_rows_m} "
        "distinct rows")
    model_rows["embedding_bag"].append((
        f"DIN pooled history {list(bag_m.shape)} D={D_m}",
        lambda: embedding_bag.embedding_bag_dense(items_m, bag_m, w_m),
        lambda: embedding_bag.embedding_bag_dense_plain(items_m, bag_m, w_m),
        lambda: torch.nn.functional.embedding_bag(
            bag_lib, items_m, mode="sum", per_sample_weights=w_m),
        n_rows_m * D_m * 4 + bag_m.numel() * 8 + bag_m.shape[0] * D_m * 4,
        2 * n_valid_m * D_m))
    by_model = {}
    for name, entries in model_rows.items():
        for label, kern, plain, library, nbytes, n_ops in entries:
            ms, plain_ms = cuda_ms(kern, 20), cuda_ms(plain, 3)
            library_ms = cuda_ms(library, 20)
            g_ms, why = graph_ms(kern, 20)
            bound_ms, bound_by = bound(nbytes, n_ops)
            by_model.setdefault(name, []).append({
                "shape": label, "ms": ms, "graph_ms": g_ms,
                "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": bound_ms, "bound_by": bound_by})
            log(f"time {name} at the models' {label}: {ms:.4f} ms kernel "
                "back to back, "
                + (f"{g_ms:.4f} ms in a CUDA graph" if why is None
                   else f"not measured in a CUDA graph ({why})")
                + f", {plain_ms:.4f} ms plain, library {library_ms:.4f} ms, "
                f"bound {bound_ms:.6f} ms ({bound_by}, {nbytes} B, {n_ops} "
                "ops)")
    del models
    # device time with the host out, and host time per call, for the rows
    # whose back-to-back time may be the host's: (label, the row that keeps
    # the times, their keys' prefix, the call, whether the row also keeps
    # its back-to-back time)
    by_name = {sp[0]: sp for sp in specs}
    host_out = []
    for n in ("trie_walk", "topk_select", "locus_topk_merge",
              "candidate_topk", "embedding_bag"):
        host_out.append((f"{n} kernel", n, "", by_name[n][3], False))
        if by_name[n][5] is not None:
            host_out.append((f"{n} library", n, "library_", by_name[n][5],
                             False))
    # the rule-free phase 1 as the substrate runs it (kernel and the loci
    # around it)
    host_out.append(("trie_walk loci entry", "trie_walk", "loci_",
                     lambda: trie_walk.trie_walk_loci(
                         tp.first_child, tp.edge_char, tp.edge_child,
                         q_plain, ql_plain, usps_plain.cfg.frontier), True))
    host_out.append(("trie_walk rule-free walk_batch", "trie_walk",
                     "walk_batch_", lambda: cuda_sub.walk_batch(
                         tp, usps_plain.cfg, q_plain, ql_plain), True))
    # the merge on the dense cache with the packed run's loci (the two
    # layouts' loci are equal): the gap to the packed row is the rank
    # lookups' cost
    host_out.append(("locus_topk_merge dense cache kernel",
                     "locus_topk_merge", "dense_cache_",
                     lambda: locus_merge.locus_topk_merge(tc, loci_etp, K),
                     True))
    host_out.append(("embedding_bag dense entry kernel", None, "",
                     lambda: embedding_bag.embedding_bag_dense(bag_table,
                                                               *bag_dense),
                     False))
    for label, row_name, pre, fn, keep_b2b in host_out:
        g_ms, why = graph_ms(fn, 20)
        h_us = host_us(fn, 1000)
        b2b = cuda_ms(fn, 20)
        log(f"time {label}: {b2b:.4f} ms back to back, "
            + (f"{g_ms:.4f} ms in a CUDA graph" if why is None
               else f"not measured in a CUDA graph ({why})")
            + f", host {h_us:.2f} us a call")
        row = next((r for r in rows if r["name"] == row_name), None)
        if row is not None:
            if keep_b2b:
                row[pre + "ms"] = b2b
            row[pre + "graph_ms"] = g_ms
            row[pre + "host_us"] = h_us
    # topk_select at the cross-shard merge's shape (phase 4c (a): [B,
    # 16 * k] of the 16 shards' answers)
    ms_s, ms_p = shard_merge

    def shard_merge_library():
        top = torch.topk(ms_s, K, dim=1)
        return top.values, torch.gather(ms_p, 1, top.indices)

    m_bound, m_by = bound(ms_s.numel() * 8 + B * K * 8, ms_s.numel())
    m_row = {"shape": list(ms_s.shape),
             "ms": cuda_ms(lambda: topk_select.topk_select(ms_s, ms_p, K), 20),
             "plain_ms": cuda_ms(lambda: topk_select.topk_select_plain(
                 ms_s, ms_p, K), 3),
             "library_ms": cuda_ms(shard_merge_library, 20),
             "bound_ms": m_bound, "bound_by": m_by}
    m_row["graph_ms"], why = graph_ms(
        lambda: topk_select.topk_select(ms_s, ms_p, K), 20)
    m_row["host_us"] = host_us(
        lambda: topk_select.topk_select(ms_s, ms_p, K), 1000)
    m_row["library_graph_ms"], _ = graph_ms(shard_merge_library, 20)
    next(r for r in rows if r["name"] == "topk_select")["shard_merge"] = m_row
    log(f"time topk_select at the cross-shard merge {list(ms_s.shape)}: "
        f"{m_row['ms']:.4f} ms back to back, "
        + (f"{m_row['graph_ms']:.4f} ms in a CUDA graph" if why is None
           else f"not measured in a CUDA graph ({why})")
        + f", host {m_row['host_us']:.2f} us a call, plain "
        f"{m_row['plain_ms']:.4f} ms, library {m_row['library_ms']:.4f} ms "
        f"(graph {m_row['library_graph_ms']}), bound {m_bound:.6f} ms "
        f"({m_by})")
    for e in (1, 2):
        for name, tt, cfg in (("locus_dp", t_et, cfg_et),
                              ("locus_dp_packed", t_etp, cfg_etp)):
            cfg_e = replace(cfg, edit_budget=e)
            ls = locus_dp.launch_shape(cfg_e, L_BUCKET)
            ms = cuda_ms(lambda: locus_dp.locus_dp_walk(tt, cfg_e, q, ql), 20)
            plain_ms = cuda_ms(
                lambda: locus_dp.locus_dp_plain(tt, cfg_e, q, ql), 3)
            log(f"time {name} E={e} (F={cfg_e.frontier}, BW="
                f"{cfg_e.branch_width}, cand={ls.cand}, {ls.threads} "
                f"threads, {ls.shared} B shared): {ms:.4f} ms kernel, "
                f"{plain_ms:.4f} ms plain")
    # locus_dp and the beam at every width phase 4's batches launched
    # them, on the first batch of the workload at that width
    for name in ("locus_dp", "beam_topk", "locus_dp_packed",
                 "beam_topk_packed"):
        n_width = sum(n for key, n in width_launched.items()
                      if key[0] == name)
        if n_width != batch_launched[name]:
            raise AssertionError(f"{name}: {n_width} launches by width, "
                                 f"{batch_launched[name]} in phase 4")
    by_width = {}
    for (name, e, w), n in sorted(width_launched.items()):
        tt, cfg = (t_etp, cfg_etp) if "packed" in name else (t_et, cfg_et)
        r = next(r for r in range(4)
                 if round_widths(cfg, r)["gens" if "beam" in name
                                         else "frontier"] == w)
        cfg_w = replace(cfg, edit_budget=e, **round_widths(cfg, r))
        loci_w = locus_dp.locus_dp_walk(tt, cfg_w, q, ql)[0]
        if "locus" in name:
            ms = cuda_ms(lambda: locus_dp.locus_dp_walk(tt, cfg_w, q, ql), 20)
            ls = locus_dp.launch_shape(cfg_w, L_BUCKET)
            rate = (16 + 4 * cfg_w.tele_width if "packed" not in name
                    else 2 + 4 + 4 * cfg_w.tele_width)
            nbytes = (B * L_BUCKET * 4 + B * 4 + B * cfg_w.frontier * 4
                      + B * 4 + n_chars * rate)
            shape = (f"F={cfg_w.frontier}, {ls.threads} threads, "
                     f"{ls.shared} B shared, workspace {ls.ws_stride}")
        else:
            ms = cuda_ms(lambda: beam_topk.beam_topk_batch(
                tt, cfg_w, loci_w, K), 20)
            found = int((beam_topk.beam_topk_batch(tt, cfg_w, loci_w, K)[1]
                         >= 0).sum())
            keys, threads, shared = beam_topk.launch_shape(cfg_w, K)
            per_locus = 12 if "packed" in name else 8
            per_found = (4 + w_esc + 1 + 4 + w_sid if "packed" in name
                         else 13)
            nbytes = (B * cfg_w.frontier * 4 + B * K * 8 + B
                      + int((loci_w >= 0).sum()) * per_locus
                      + found * per_found)
            shape = (f"F={cfg_w.frontier} W={cfg_w.gens} max_steps="
                     f"{cfg_w.max_steps}, {threads} threads, {shared} B "
                     "shared")
        bound_ms, bound_by = bound(nbytes, n_chars * 8 if "locus" in name
                                   else found * 8)
        by_width.setdefault(name, []).append(
            {"E": e, "width": w, "launches": n, "ms": ms,
             "bound_ms": bound_ms, "bound_by": bound_by})
        log(f"time {name} E={e} {'F' if 'locus' in name else 'W'}={w} "
            f"({shape}): {ms:.4f} ms kernel, {n} phase 4 launches, bound "
            f"{bound_ms:.6f} ms ({bound_by}), loss {n * (ms - bound_ms):.3f} "
            "ms")
    rows.append({**training["row"],
                 "launches": launched["embedding_bag_backward"]})
    for row in rows:
        if row["name"] in by_width:
            row["by_width"] = by_width[row["name"]]
        if row["name"] in by_model:
            row["model_widths"] = by_model[row["name"]]
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
