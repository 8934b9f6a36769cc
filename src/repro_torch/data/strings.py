"""String corpora + synonym-rule generators mirroring the paper's datasets
(Table 1): DBLP (publication titles + CS abbreviations), USPS (addresses +
nickname/state rules), SPROT (gene/protein records + term-variation rules).

Offline environment => faithful *synthetic* regeneration with matched
statistics: string counts/lengths, rule counts, and rules-per-string in the
paper's reported ranges; scores uniform in [1, 50000] as in §7.1.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_WORDS = """system database management query optimization transaction neural
network learning deep graph stream processing distributed parallel storage
index structure algorithm efficient scalable adaptive dynamic incremental
approximate probabilistic semantic knowledge information retrieval search
ranking completion string synonym abbreviation entity resolution join
similarity vector spatial temporal crowd privacy secure federated quantum
""".split()

_FIRST = """james mary john patricia robert jennifer michael linda william
elizabeth david barbara richard susan joseph jessica thomas sarah charles
karen christopher nancy daniel lisa matthew betty anthony margaret mark
sandra donald ashley steven kimberly paul emily andrew donna joshua michelle
kenneth carol kevin amanda brian melissa george deborah""".split()

_NICK = {
    "james": "jim", "john": "jack", "robert": "bob", "michael": "mike",
    "william": "bill", "david": "dave", "richard": "dick", "joseph": "joe",
    "thomas": "tom", "charles": "chuck", "christopher": "chris",
    "daniel": "dan", "matthew": "matt", "anthony": "tony", "donald": "don",
    "steven": "steve", "kenneth": "ken", "kevin": "kev", "andrew": "andy",
    "joshua": "josh", "elizabeth": "liz", "jennifer": "jen",
    "patricia": "pat", "margaret": "peggy", "deborah": "deb",
    "kimberly": "kim", "jessica": "jess", "sandra": "sandy",
}

_STATES = {
    "texas": "tx", "california": "ca", "new york": "ny", "florida": "fl",
    "illinois": "il", "ohio": "oh", "georgia": "ga", "michigan": "mi",
    "virginia": "va", "washington": "wa", "arizona": "az", "oregon": "or",
    "colorado": "co", "nevada": "nv", "montana": "mt", "utah": "ut",
}

_STREET = "main oak pine maple cedar elm park lake hill river sunset".split()
_STYPE = {"street": "st", "avenue": "ave", "boulevard": "blvd",
          "drive": "dr", "road": "rd", "court": "ct", "lane": "ln"}


@dataclass
class StringDataset:
    name: str
    strings: list[str]
    scores: np.ndarray
    rules: list[tuple[str, str]]   # (query-side lhs, dictionary-side rhs)


def _scores(rng, n):
    return rng.integers(1, 50_001, n).astype(np.int32)


def make_dblp(n: int = 24_810, seed: int = 0) -> StringDataset:
    """Titles from a CS word vocabulary; rules = abbreviation -> word."""
    rng = np.random.default_rng(seed)
    strings = set()
    while len(strings) < n:
        k = rng.integers(4, 10)
        strings.add(" ".join(rng.choice(_WORDS, k)))
    strings = sorted(strings)
    rules = []
    for w in sorted(set(_WORDS)):
        if len(w) >= 6:
            rules.append((w[:3] + ".", w))       # "dat." -> "database"
        if len(w) >= 8:
            rules.append((w[:4], w))             # "data" -> "database"-ish
    rules = sorted(set(rules))[:214]
    return StringDataset("DBLP", strings, _scores(rng, len(strings)), rules)


def make_usps(n: int = 1_000_000, seed: int = 0) -> StringDataset:
    """person name + street + city + state records; nickname/state rules."""
    rng = np.random.default_rng(seed)
    firsts = np.array(_FIRST)
    streets = np.array(_STREET)
    stypes = np.array(list(_STYPE.keys()))
    states = np.array(list(_STATES.keys()))
    f = firsts[rng.integers(0, len(firsts), n)]
    l = firsts[rng.integers(0, len(firsts), n)]
    num = rng.integers(1, 9999, n)
    st = streets[rng.integers(0, len(streets), n)]
    ty = stypes[rng.integers(0, len(stypes), n)]
    ct = streets[rng.integers(0, len(streets), n)]
    sa = states[rng.integers(0, len(states), n)]
    strings = [f"{a} {b} {c} {d} {e} {g}ville {h}"
               for a, b, c, d, e, g, h in zip(f, l, num, st, ty, ct, sa)]
    rules = [(v, k) for k, v in _NICK.items()]
    rules += [(v, k) for k, v in _STATES.items()]
    rules += [(v, k) for k, v in _STYPE.items()]
    # common misspellings / short forms of street words
    rules += [(w[:3], w) for w in _STREET if len(w) >= 5]
    rules = sorted(set(rules))[:341]
    return StringDataset("USPS", strings, _scores(rng, len(strings)), rules)


def make_sprot(n: int = 1_000_000, seed: int = 0) -> StringDataset:
    """entry name + protein + gene + organism; acronym/variation rules."""
    rng = np.random.default_rng(seed)
    prots = ["kinase", "receptor", "transferase", "hydrolase", "ligase",
             "polymerase", "phosphatase", "synthase", "reductase", "protease"]
    orgs = ["human", "mouse", "yeast", "ecoli", "zebrafish", "drosophila"]
    entry = rng.integers(0, 10**6, n)
    p1 = np.array(prots)[rng.integers(0, len(prots), n)]
    num = rng.integers(1, 99, n)
    gene = rng.integers(0, 26**3, n)
    org = np.array(orgs)[rng.integers(0, len(orgs), n)]

    def g3(x):
        return (chr(97 + x // 676) + chr(97 + (x // 26) % 26)
                + chr(97 + x % 26))

    strings = [f"q{e:06d} interleukin-{k} {p} {g3(g)} {o}"
               for e, k, p, g, o in zip(entry, num, p1, gene, org)]
    rules = [(f"il-{k}", f"interleukin-{k}") for k in range(1, 99)]
    rules += [(f"il{k}", f"interleukin-{k}") for k in range(1, 99)]
    rules += [(p[:4], p) for p in prots]
    rules += [(p + "s", p) for p in prots]
    rules += [(f"{o[:3]}.", o) for o in orgs]
    # pad with numbered variant rules to reach ~1000 like the paper
    k = 0
    while len(rules) < 1000:
        rules.append((f"v{k:03d}", f"variant-{k:03d}"))
        k += 1
    return StringDataset("SPROT", strings, _scores(rng, len(strings)),
                         sorted(set(rules))[:1000])


def make_workload(ds: StringDataset, n_queries: int, seed: int = 0,
                  min_len: int = 2, max_len: int = 24) -> list[str]:
    """Paper §7.3 workload: apply rules to dictionary strings (dict-side ->
    query-side rewriting), then take a prefix of the rewritten string."""
    rng = np.random.default_rng(seed)
    inv = {}  # dictionary-side rhs -> query-side lhs choices
    for lhs, rhs in ds.rules:
        inv.setdefault(rhs, []).append(lhs)
    rhs_keys = sorted(inv)
    queries = []
    n_strings = len(ds.strings)
    while len(queries) < n_queries:
        s = ds.strings[int(rng.integers(0, n_strings))]
        # rewrite up to 2 applicable dictionary-side substrings
        for _ in range(2):
            hits = [r for r in rhs_keys if r in s]
            if not hits or rng.random() < 0.3:
                break
            r = hits[int(rng.integers(0, len(hits)))]
            lhs = inv[r][int(rng.integers(0, len(inv[r])))]
            i = s.find(r)
            s = s[:i] + lhs + s[i + len(r):]
        ln = int(rng.integers(min_len, max_len + 1))
        q = s[:ln].rstrip()
        if q:
            queries.append(q)
    return queries


def make_zipf_queries(ds: StringDataset, n_queries: int, seed: int = 0,
                      a: float = 1.3, min_len: int = 2,
                      max_len: int = 24) -> list[str]:
    """Zipf-skewed prefix queries: real autocomplete traffic concentrates
    on hot strings, so strings are drawn by Zipf rank (parameter ``a``)
    instead of uniformly; rule rewriting and prefix truncation match
    :func:`make_workload`."""
    rng = np.random.default_rng(seed)
    inv = {}
    for lhs, rhs in ds.rules:
        inv.setdefault(rhs, []).append(lhs)
    rhs_keys = sorted(inv)
    n_strings = len(ds.strings)
    queries = []
    while len(queries) < n_queries:
        rank = min(int(rng.zipf(a)), n_strings) - 1
        s = ds.strings[rank]
        for _ in range(2):
            hits = [r for r in rhs_keys if r in s]
            if not hits or rng.random() < 0.3:
                break
            r = hits[int(rng.integers(0, len(hits)))]
            lhs = inv[r][int(rng.integers(0, len(inv[r])))]
            i = s.find(r)
            s = s[:i] + lhs + s[i + len(r):]
        ln = int(rng.integers(min_len, max_len + 1))
        q = s[:ln].rstrip()
        if q:
            queries.append(q)
    return queries


def make_keystroke_events(ds: StringDataset, n_sessions: int,
                          n_queries: int, seed: int = 0, a: float = 1.3,
                          min_len: int = 2, max_len: int = 24
                          ) -> list[tuple[int, int]]:
    """Interleaved multi-session keystroke stream for the serving layer.

    Zipf-skewed queries (:func:`make_zipf_queries`) are dealt to
    ``n_sessions`` concurrent typists balancing total keystroke count
    (each query goes to the least-loaded session, so streams end together
    instead of staggering with the heavy-tailed query lengths), each
    query preceded by a session reset; the per-session typing is then
    interleaved by a random schedule, so at any instant several sessions
    have a keystroke in flight — the shape continuous batching coalesces.

    Returns ``[(session, char), ...]`` where ``char`` is a byte value and
    ``-1`` marks a session reset (a new query starts).
    """
    rng = np.random.default_rng(seed)
    queries = make_zipf_queries(ds, n_queries, seed=seed + 1, a=a,
                                min_len=min_len, max_len=max_len)
    pending: list[list[int]] = [[] for _ in range(n_sessions)]
    for q in queries:
        s = min(range(n_sessions), key=lambda i: len(pending[i]))
        pending[s].append(-1)
        pending[s].extend(q.encode())
    events = []
    cursors = [0] * n_sessions
    live = [s for s in range(n_sessions) if pending[s]]
    while live:
        s = live[int(rng.integers(0, len(live)))]
        events.append((s, pending[s][cursors[s]]))
        cursors[s] += 1
        if cursors[s] == len(pending[s]):
            live.remove(s)
    return events


DATASETS = {"dblp": make_dblp, "usps": make_usps, "sprot": make_sprot}
