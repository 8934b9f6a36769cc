"""The keystroke scheduler and the serving layer around it: the port's
``KeystrokeScheduler`` / ``CompletionService(batching=True)`` against the
port's own sequential ``Session`` replay and against ``repro``'s
scheduler (``substrate="jnp"``).

Every keystroke answered through the port's scheduler must equal the
port's sequential replay of the same events and ``repro``'s scheduler's
answer, in scores, strings and order, on both substrates (``"torch"``,
and ``"cuda"`` answered by the kernels' plain versions on the CPU, so its
routing runs) and both layouts.  The scheduler's own behaviour — mixed k
in one flush, backspace, reset, reopened lanes, deferred close, deadline
flushes under a fake clock, backpressure, lane exhaustion, the idle
pipeline's settling — is one script run on both packages, whose
transcripts must be equal.  Reranking with over-fetch runs one host
callable through both packages' services, and the workload makers give
``repro``'s lists.
"""

from types import SimpleNamespace

import pytest
import torch

import repro.serving as jax_serving
import repro_torch as rt
from repro.api import IndexSpec as JaxSpec
from repro.api import build_index as jax_build
from repro.core import make_rules as jax_rules
from repro.data import strings as jax_strings
from repro.launch.serve import _replay_batched as jax_replay_batched
from repro_torch.core import engine as eng
from repro_torch.core.trie_build import make_rules
from repro_torch.data import strings as port_strings
from repro_torch.launch.serve import _replay_batched as replay_batched
from repro_torch.launch.serve import _replay_sequential as replay_sequential
from torch_fast_jit import fast_jax_jit  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

PAPER = (["andrew pavlo", "andrew parker", "andrew packard",
          "william smith", "bill of rights"], [50, 40, 30, 20, 10],
         [("andy", "andrew"), ("bill", "william")])
SUBSTRATES = ["torch", "cuda"]
JAX = SimpleNamespace(KeystrokeScheduler=jax_serving.KeystrokeScheduler,
                      CompletionService=jax_serving.CompletionService,
                      SchedulerOverloaded=jax_serving.SchedulerOverloaded)
PORT = SimpleNamespace(KeystrokeScheduler=rt.KeystrokeScheduler,
                       CompletionService=rt.CompletionService,
                       SchedulerOverloaded=rt.SchedulerOverloaded)


class FakeClock:
    """Injectable monotonic clock so deadline tests never sleep."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


@pytest.fixture(scope="module")
def usps():
    return port_strings.make_usps(n=400, seed=0)


@pytest.fixture(scope="module")
def jax_paper():
    return jax_build(PAPER[0], PAPER[1], jax_rules(PAPER[2]),
                     JaxSpec(kind="et", cache_k=4, substrate="jnp"))


@pytest.fixture(scope="module")
def port_paper():
    return {sub: rt.build_index(PAPER[0], PAPER[1], make_rules(PAPER[2]),
                                rt.IndexSpec(kind="et", cache_k=4,
                                             substrate=sub), device="cpu")
            for sub in SUBSTRATES}


# -- the workload makers -------------------------------------------------------


@pytest.mark.parametrize("n_sessions,n_queries,seed,kw", [
    (4, 10, 2, dict(max_len=10)),
    (3, 6, 5, dict(max_len=8)),
    (8, 64, 1, {}),
    (5, 20, 7, dict(a=1.1, min_len=1, max_len=30)),
])
def test_keystroke_events_match_repro(usps, n_sessions, n_queries, seed,
                                      kw):
    jds = jax_strings.make_usps(n=400, seed=0)
    assert (usps.strings, list(usps.scores), usps.rules) == \
        (jds.strings, list(jds.scores), jds.rules)
    assert port_strings.make_zipf_queries(usps, n_queries, seed=seed,
                                          **kw) == \
        jax_strings.make_zipf_queries(jds, n_queries, seed=seed, **kw)
    events = port_strings.make_keystroke_events(usps, n_sessions,
                                                n_queries, seed=seed, **kw)
    assert events == jax_strings.make_keystroke_events(
        jds, n_sessions, n_queries, seed=seed, **kw)
    assert {s for s, _ in events} == set(range(n_sessions))


def test_zipf_queries_on_dblp_match_repro():
    ds, jds = port_strings.make_dblp(300, seed=0), \
        jax_strings.make_dblp(300, seed=0)
    assert port_strings.make_zipf_queries(ds, 40, seed=3) == \
        jax_strings.make_zipf_queries(jds, 40, seed=3)


# -- determinism against sequential replay and repro ---------------------------

_JAX_REPLAYS = {}


def _usps_pair(ds, compression, substrate, **kw):
    """(repro's batched answers, stats) once per (layout, options), and
    the port's index."""
    spec = dict(kind="et", cache_k=4, compression=compression, **kw)
    key = tuple(sorted(spec.items()))
    if key not in _JAX_REPLAYS:
        j = jax_build(ds.strings, ds.scores, jax_rules(ds.rules),
                      JaxSpec(substrate="jnp", **spec))
        _JAX_REPLAYS[key] = j
    p = rt.build_index(ds.strings, ds.scores, make_rules(ds.rules),
                       rt.IndexSpec(substrate=substrate, **spec),
                       device="cpu")
    return _JAX_REPLAYS[key], p


def _batched_service(pkg, idx, sessions, **kw):
    svc = pkg.CompletionService(idx, batching=True, block=sessions, **kw)
    svc._scheduler().clock = FakeClock()   # deadlines never fire
    return svc


@pytest.mark.parametrize("compression", ["none", "packed"])
@pytest.mark.parametrize("substrate", SUBSTRATES)
def test_batched_bit_identical_to_sequential_and_repro(usps, substrate,
                                                       compression):
    """One interleaved Zipf keystroke stream replayed a keystroke at a
    time and through the scheduler's coalesced blocks: identical top-k
    per keystroke (inexact-fallback lanes included), equal to repro's
    scheduler, with the same flush accounting under a frozen clock."""
    j, p = _usps_pair(usps, compression, substrate)
    sessions = 4
    # dense: k past cache_k (the beam); packed: the cached merge
    k = 5 if compression == "none" else 4
    events = port_strings.make_keystroke_events(usps, sessions,
                                                n_queries=10, seed=2,
                                                max_len=10)
    jsvc = _batched_service(JAX, j, sessions, max_queue=8 * sessions)
    want = jax_replay_batched(jsvc, events, sessions, k=k)
    seq = replay_sequential(rt.CompletionService(p), events, sessions, k=k)
    bat = _batched_service(PORT, p, sessions, max_queue=8 * sessions)
    got = replay_batched(bat, events, sessions, k=k)
    assert seq == got
    assert got == want
    st = bat.scheduler.stats
    assert st.n_keystrokes == sum(c >= 0 for _, c in events)
    assert st.mean_occupancy > 1.0      # keystrokes really coalesced
    assert vars(st) == vars(jsvc.scheduler.stats)
    assert bat.stats.n_keystrokes == len(got)


@pytest.mark.parametrize("substrate", SUBSTRATES)
def test_partial_block_flushes_stay_deterministic(usps, substrate):
    """max_wait_ms=0 forces a deadline flush per submit — every block is
    partial, so idle lanes ride every flush — and answers do not change;
    a frontier too narrow for the corpus makes inexact lanes, answered by
    the one-shot path."""
    narrow = rt.build_index(usps.strings, usps.scores, make_rules(usps.rules),
                            rt.IndexSpec(kind="et", cache_k=4, frontier=1,
                                         substrate=substrate), device="cpu")
    sessions = 3
    events = port_strings.make_keystroke_events(usps, sessions,
                                                n_queries=6, seed=5,
                                                max_len=8)
    seq = replay_sequential(rt.CompletionService(narrow), events, sessions,
                            k=4)
    bat = rt.CompletionService(narrow, batching=True, block=sessions,
                               max_wait_ms=0.0, max_queue=64)
    assert replay_batched(bat, events, sessions, k=4) == seq
    st = bat.scheduler.stats
    assert st.deadline_flushes > 0
    assert st.fallbacks > 0


# -- the scheduler's behaviour: one script, both packages ----------------------


def _raises(fn):
    try:
        fn()
    except Exception as err:   # the transcript records what was raised
        return (type(err).__name__, str(err))
    return None


def sc_mixed_k(pkg, idx):
    """Lanes with different k in one flush each get their own batched
    top-k group; advance-only keystrokes resolve without results."""
    sched = pkg.KeystrokeScheduler(idx, block=4, max_wait_ms=1e6)
    a, b = sched.open(k=3), sched.open(k=5)
    ta = [a.submit(c, want_topk=(i == 3)) for i, c in enumerate(b"andy")]
    tb = [b.submit(c, want_topk=(i == 3)) for i, c in enumerate(b"bill")]
    sched.drain()
    return [all(t.done for t in ta + tb), ta[-1].results, tb[-1].results,
            ta[0].results, ta[0].done, a.topk(), a.topk(k=2),
            idx.complete(["andy"], k=3)[0], idx.complete(["bill"], k=5)[0]]


def sc_backspace_reset_reopen(pkg, idx):
    sched = pkg.KeystrokeScheduler(idx, block=2, max_wait_ms=1e6)
    s = sched.open(k=3)
    out = [s.type("andy pa"), s.backspace(3), s.prefix]
    s.reset()
    out += [s.type("bill"), s.type(""), s.backspace(9), s.prefix]
    s.close()
    out.append(_raises(lambda: s.submit(b"x")))
    s2 = sched.open(k=3)         # the freed lane, re-initialised
    out += [s2.lane == s.lane, s2.type("an"), s2.prefix_bytes]
    out += [idx.complete([q], k=3)[0] for q in ("andy pa", "andy", "bill",
                                                "an")]
    return out


def sc_deadline(pkg, idx):
    clock = FakeClock()
    sched = pkg.KeystrokeScheduler(idx, block=2, max_wait_ms=2.0,
                                   clock=clock)
    idle = sched.open(k=3)          # occupied lane with nothing queued
    s = sched.open(k=3)
    t = s.submit(b"a")
    out = [sched.pump(), sched.stats.n_flushes, t.done]
    clock.t += 0.0015
    out.append(sched.pump())        # 1.5 ms < 2 ms budget
    clock.t += 0.001
    out.append(sched.pump())        # 2.5 ms: deadline flush, partial block
    out.append(sched.stats.deadline_flushes)
    sched.drain()                   # settle the pipelined demux
    out += [t.done, t.results, abs(t.latency_s - (clock.t - t.created))
            < 1e-12, idx.complete(["a"], k=3)[0]]
    idle.close()
    return out


def sc_full_block(pkg, idx):
    sched = pkg.KeystrokeScheduler(idx, block=2, max_wait_ms=1e6,
                                   clock=FakeClock())
    a, b = sched.open(k=3), sched.open(k=3)
    a.submit(b"a")
    out = [sched.stats.n_flushes]
    b.submit(b"b")                  # every occupied lane ready
    return out + [sched.stats.full_flushes]


def sc_poll_settles(pkg, idx):
    """After the LAST flush its results sit stashed: pump() alone never
    resolves them, poll() does."""
    clock = FakeClock()
    sched = pkg.KeystrokeScheduler(idx, block=2, max_wait_ms=2.0,
                                   clock=clock)
    idle = sched.open(k=3)
    s = sched.open(k=3)
    t = s.submit(b"a")
    clock.t += 0.010
    out = [sched.pump(), sched.pending, t.done, sched.pump(), t.done,
           sched.poll(), t.done, t.results]
    idle.close()
    return out


def sc_service_poll(pkg, idx):
    svc = pkg.CompletionService(idx, batching=True, block=2,
                                max_wait_ms=0.0)
    a, b = svc.open_session(k=3), svc.open_session(k=3)
    ta, tb = a.submit(b"a"), b.submit(b"b")
    out = [svc.pump(), svc.scheduler.pending, svc.poll(), ta.done, tb.done,
           ta.results, tb.results]
    a.close(), b.close()
    plain = pkg.CompletionService(idx)
    return out + [plain.poll(), plain.pump(), plain.flush(), plain.drain()]


def sc_backpressure(pkg, idx):
    sched = pkg.KeystrokeScheduler(idx, block=2, max_wait_ms=1e6,
                                   max_queue=2, clock=FakeClock())
    idle = sched.open(k=3)          # keeps full-flush from firing
    s = sched.open(k=3)
    s.submit(b"a")
    s.submit(b"n")
    out = [_raises(lambda: s.submit(b"d")), sched.stats.rejected, s.prefix]
    sched.flush()                   # one forced flush makes room
    t = s.submit(b"d")
    sched.drain()
    out += [t.results, s.prefix, idx.complete(["and"], k=3)[0]]
    idle.close()
    return out


def sc_lane_exhaustion(pkg, idx):
    sched = pkg.KeystrokeScheduler(idx, block=2, max_wait_ms=1e6)
    a, b = sched.open(k=3), sched.open(k=3)
    out = [_raises(lambda: sched.open(k=3))]
    a.close()
    c = sched.open(k=3)             # the freed lane is reusable
    out.append(c.lane == a.lane)
    b.close()
    c.close()
    out += [_raises(lambda: pkg.KeystrokeScheduler(idx, block=0)),
            _raises(lambda: pkg.KeystrokeScheduler(idx, max_queue=0))]
    return out


def sc_deferred_close(pkg, idx):
    """Closing a session with keystrokes in flight forces no partial
    flush: the lane drains through normal flushes, then frees."""
    sched = pkg.KeystrokeScheduler(idx, block=2, max_wait_ms=1e6)
    a, b = sched.open(k=3), sched.open(k=3)
    tickets = [a.submit(c) for c in b"an"]
    a.close()
    out = [sched._draining[a.lane]]
    out.append(b.type("bil"))       # normal traffic drains lane a
    sched.drain()
    out += [all(t.done for t in tickets), tickets[-1].results,
            sched._lanes[a.lane] is None, sched._draining[a.lane]]
    b.close()
    return out


def sc_counters(pkg, idx):
    """The O(1) pump counters agree with full lane scans through a mixed
    open/submit/close/flush workload."""
    sched = pkg.KeystrokeScheduler(idx, block=3, max_wait_ms=1e6)
    out = []

    def check():
        out.append((sched._n_ready, sched._n_occupied))
        assert sched._n_ready == len(sched._ready_lanes())
        assert sched._n_occupied == sched._occupied()

    sessions = [sched.open(k=3) for _ in range(3)]
    check()
    sessions[0].submit(b"a"); check()
    sessions[0].submit(b"n"); check()
    sessions[1].submit(b"b"); check()
    sessions[2].submit(b"w"); check()       # full block -> auto flush
    sessions[1].close(); check()
    sched.drain(); check()
    sessions[0].close(); sessions[2].close(); check()
    return out + [vars(sched.stats)]


def sc_service_stats(pkg, idx):
    svc = pkg.CompletionService(idx, batching=True, block=2,
                                max_wait_ms=1e6)
    a, b = svc.open_session(k=3), svc.open_session(k=3)
    ra = [a.submit(c) for c in b"andy"]
    rb = [b.submit(c) for c in b"bill"]
    svc.drain()
    out = [ra[-1].result(svc.scheduler), rb[-1].result(svc.scheduler),
           svc.stats.n_keystrokes,
           svc.stats.p99_keystroke_ms() >= svc.stats.p50_keystroke_ms() >= 0]
    a.close(); b.close()
    return out


def sc_unbatched_submit(pkg, idx):
    sess = pkg.CompletionService(idx).open_session(k=3)
    return [_raises(lambda: sess.submit(b"a")), sess.type("an")]


SCENARIOS = [sc_mixed_k, sc_backspace_reset_reopen, sc_deadline,
             sc_full_block, sc_poll_settles, sc_service_poll,
             sc_backpressure, sc_lane_exhaustion, sc_deferred_close,
             sc_counters, sc_service_stats, sc_unbatched_submit]
_JAX_TRANSCRIPTS = {}


@pytest.mark.parametrize("substrate", SUBSTRATES)
@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__[3:] for s in SCENARIOS])
def test_scheduler_behaves_as_repro(jax_paper, port_paper, scenario,
                                    substrate):
    if scenario not in _JAX_TRANSCRIPTS:
        _JAX_TRANSCRIPTS[scenario] = scenario(JAX, jax_paper)
    assert scenario(PORT, port_paper[substrate]) == \
        _JAX_TRANSCRIPTS[scenario]


# -- the slab ------------------------------------------------------------------


@pytest.mark.parametrize("compression", ["none", "packed"])
@pytest.mark.parametrize("substrate", SUBSTRATES)
def test_slab_reset_mask_and_idle_lanes(usps, substrate, compression):
    """In one advance: a reset lane that gets a char equals init then
    advance, a reset lane without a char equals init, and an idle lane
    stays bit for bit as it was, overflow included (a frontier of 1
    overflows on this corpus)."""
    idx = rt.build_index(usps.strings, usps.scores, make_rules(usps.rules),
                         rt.IndexSpec(kind="et", frontier=1,
                                      compression=compression,
                                      substrate=substrate), device="cpu")
    t, cfg = idx.tensors, idx.cfg
    init, advance = idx._slab_fns(4)
    slab = init()
    typed = [b"ja", b"wil", b"bob", b"s"]
    for step in range(3):
        chars = torch.tensor([p[step] if step < len(p) else -1
                              for p in typed], dtype=torch.int32)
        slab = advance(slab, chars, torch.zeros(4, dtype=torch.bool))
    assert int(slab.overflow.max()) > 0
    before = [x.clone() for x in slab]
    # lane 0 reset + 'b', lane 1 reset alone, lane 2 idle, lane 3 'x'
    chars = torch.tensor([ord("b"), -1, -1, ord("x")], dtype=torch.int32)
    resets = torch.tensor([True, True, False, False])
    after = advance(slab, chars, resets)
    fresh = eng.init_locus_state(t, cfg)
    want0 = eng.advance_locus_state(t, cfg, fresh, ord("b"))
    lane = [eng.LocusState(*(x[i] for x in after)) for i in range(4)]
    for got, want in ((lane[0], want0), (lane[1], fresh)):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    for g, b in zip(lane[2], (x[2] for x in before)):
        assert torch.equal(g, b)
    want3 = eng.advance_locus_state(
        t, cfg, eng.LocusState(*(x[3] for x in before)), ord("x"))
    for g, w in zip(lane[3], want3):
        assert torch.equal(g, w)


@pytest.mark.parametrize("substrate", SUBSTRATES)
def test_reconfigure_mid_stream_migrates_the_slab(port_paper, substrate):
    """A reconfigure between flushes bumps the epoch: the next flush
    settles the stash, refetches the slab fns, replays every lane's
    consumed prefix, and the queued keystrokes answer as before."""
    idx = rt.build_index(PAPER[0], PAPER[1], make_rules(PAPER[2]),
                         rt.IndexSpec(kind="et", cache_k=4,
                                      substrate=substrate), device="cpu")
    sched = rt.KeystrokeScheduler(idx, block=2, max_wait_ms=1e6)
    a, b = sched.open(k=3), sched.open(k=3)
    ta = [a.submit(c) for c in b"andy "]
    tb = [b.submit(c) for c in b"wi"]
    sched.flush()
    # tickets consumed so far are answered on the old epoch's slab
    n_old = [len(p) for p in sched._consumed]
    idx.reconfigure(edit_budget=1)
    tb += [b.submit(c) for c in b"lliam"]
    sched.drain()
    assert sched.stats.migrations == 1
    assert 0 < n_old[a.lane] < len(ta) and 0 < n_old[b.lane] < len(tb)
    old = port_paper[substrate]
    for lane, tickets in ((a.lane, ta), (b.lane, tb)):
        for i, t in enumerate(tickets):
            src = old if i < n_old[lane] else idx
            assert t.results == src.complete([t.prefix], k=3)[0], t.prefix
    # past the epoch the reconfigured index answers: typos match
    assert b.type("x") == idx.complete(["williamx"], k=3)[0]
    assert a.type("pavl") == idx.complete(["andy pavl"], k=3)[0]
    assert idx.complete(["wiliam"], k=3)[0] != old.complete(["wiliam"],
                                                            k=3)[0]


def test_cpu_flush_keeps_host_tensors(port_paper):
    """On a CPU index a flush's stash is the packed result itself: no
    pinned buffer and no event (a dispatch on the device type)."""
    sched = rt.KeystrokeScheduler(port_paper["torch"], block=2,
                                  max_wait_ms=1e6)
    s = sched.open(k=3)
    s.submit(b"a")                  # the one open lane is ready: a flush
    ((k, tickets, (packed, host, ready), strings),) = sched._unsettled
    assert k == 3 and ready is None and host is packed
    assert strings is port_paper["torch"].strings
    assert packed.dtype == torch.int32 and packed.shape == (2 * 2 * 3 + 2,)
    sched.drain()
    assert tickets[0].results == port_paper["torch"].complete(["a"], k=3)[0]


# -- reranking ----------------------------------------------------------------


def rerank(query, rows):
    """A host reranker: shortest suggestion first, then the string."""
    return sorted(rows, key=lambda r: (len(r[1]), r[1]))


def _rerank_transcript(pkg, idx, batching):
    svc = pkg.CompletionService(idx, reranker=rerank, overfetch=4,
                                batching=batching, block=2,
                                max_wait_ms=1e6)
    out = [svc.complete(["an", "andy", "bill", "w", "zzz"], k=2)]
    a, b = svc.open_session(k=2), svc.open_session(k=2)
    out += [a.type("andy"), b.type("wil"), a.type(""), a.backspace(2),
            b.backspace(1), a.prefix, b.prefix]
    a.reset()
    out.append(a.type("bill of"))
    a.close(), b.close()
    return out + [svc.stats.n_queries]


@pytest.mark.parametrize("batching", [False, True])
@pytest.mark.parametrize("substrate", SUBSTRATES)
def test_rerank_with_overfetch_matches_repro(jax_paper, port_paper,
                                             substrate, batching):
    key = ("rerank", batching)
    if key not in _JAX_TRANSCRIPTS:
        _JAX_TRANSCRIPTS[key] = _rerank_transcript(JAX, jax_paper, batching)
    got = _rerank_transcript(PORT, port_paper[substrate], batching)
    assert got == _JAX_TRANSCRIPTS[key]
    # the over-fetch: the reranker saw 4k candidates and k came back
    idx = port_paper[substrate]
    assert got[0][0] == rerank("an", idx.complete(["an"], k=8)[0])[:2]
