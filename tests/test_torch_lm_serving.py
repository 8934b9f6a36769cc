"""The port's continuous-batching LM server and the launcher's LM mode
against ``repro``'s on the CPU: one weight tree (``torch_lm_trees``), the
same requests, equal tokens and completion order.

Greedy tokens are compared for equality: both packages compute float32
logits within 1e-4 of each other (``tests/test_torch_lm_model.py``), and
these configs' logits have no near-ties at that size.
"""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_arch as repro_arch
from repro.launch import serve as repro_serve
from repro.models import transformer as jtf
from repro.models.transformer import TransformerConfig
from repro.serving import LMServer as JServer
from repro.serving import Request as JRequest
from repro_torch.configs import LM_ARCHS, get_arch
from repro_torch.launch import serve
from repro_torch.serving import LMServer, Request, SlotScheduler
from torch_lm_trees import both, port_cfg
from torch_threads import one_torch_thread  # noqa: F401

# tests/test_substrates.py's one-layer LM
TINY = TransformerConfig(n_layers=1, d_model=32, n_heads=2, n_kv=1,
                         d_head=16, d_ff=64, vocab=64, loss_chunk=8)


def smoke(arch):
    return repro_arch(arch).make_smoke_config()


def requests(prompts, new_tokens):
    """The same requests for both packages: (repro's, the port's)."""
    return ([JRequest(rid=i, prompt=p, max_new_tokens=n)
             for i, (p, n) in enumerate(zip(prompts, new_tokens))],
            [Request(rid=i, prompt=p, max_new_tokens=n)
             for i, (p, n) in enumerate(zip(prompts, new_tokens))])


def served(server, reqs):
    for r in reqs:
        server.scheduler.submit(r)
    return [(r.rid, r.tokens) for r in server.run()]


def prompts(cfg, lengths, seed):
    r = np.random.default_rng(seed)
    return [r.integers(0, cfg.vocab, n).astype(np.int32) for n in lengths]


CASES = {
    # tests/test_substrates.py:176: 5 requests over 2 slots
    "substrates-5x2": (TINY, 2, 48,
                       [np.arange(3 + i) % 64 for i in range(5)], [4] * 5),
    # the window's ring wraps in decode; slots recycle
    "danube-ring": (smoke("h2o-danube-1.8b"), 3, 24, (10,) * 7,
                    [12, 5, 9, 12, 5, 9, 3]),
    # MoE: lanes left empty decode their stale tokens beside live ones
    "granite-stale-lanes": (smoke("granite-moe-1b-a400m"), 4, 32, (8,) * 6,
                            [6, 3, 10, 2, 7, 4]),
    # no window: decoding past max_len overwrites the cache's last slot
    "qwen-past-max-len": (smoke("qwen2.5-14b"), 2, 12, (10,) * 3, [6, 4, 9]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_lm_server_matches_repro(case):
    cfg, n_slots, max_len, lengths, new_tokens = CASES[case]
    ps = lengths if isinstance(lengths[0], np.ndarray) else \
        prompts(cfg, lengths, seed=len(case))
    jp, tp = both(cfg, seed=4)
    jreqs, treqs = requests(ps, new_tokens)
    want = served(JServer(jp, cfg, n_slots=n_slots, max_len=max_len), jreqs)
    got = served(LMServer(tp, port_cfg(cfg), n_slots=n_slots,
                          max_len=max_len), treqs)
    assert got == want                      # tokens and completion order
    assert [len(t) for _, t in got] == [new_tokens[i] for i, _ in got]
    for r in treqs:
        assert r.done and r.created <= r.first_token_at <= r.finished_at


def test_slot_scheduler_admits_and_completes_in_order():
    s = SlotScheduler(2)
    for i in range(3):
        s.submit(Request(rid=i, prompt=np.zeros(1, np.int32),
                         max_new_tokens=1 + i))
    assert [(i, r.rid) for i, r in s.admit()] == [(0, 0), (1, 1)]
    s.record(np.array([5, 6]))
    assert [r.rid for r in s.completed] == [0] and s.active
    assert [(i, r.rid) for i, r in s.admit()] == [(0, 2)]
    s.record(np.array([7, 8]), eos_id=8)                 # rid 1 stops on eos
    assert [r.rid for r in s.completed] == [0, 1]
    assert s.completed[1].tokens == [6, 8]


def test_int8_cache_server_of_repro_decodes_unscaled_values():
    """repro's LMServer with cache_dtype="int8": prefill quantizes its
    cache, and the server writes the int8 values into its float32 cache
    without their scales, so decode attends to integers ~100x the keys.
    The port's LMServer refuses such a config."""
    cfg = dataclasses.replace(TINY, cache_dtype="int8")
    jp, tp = both(cfg, seed=5)
    prompt = np.arange(6, dtype=np.int32) % 64
    server = JServer(jp, cfg, n_slots=1, max_len=16)
    server.scheduler.submit(JRequest(rid=0, prompt=prompt, max_new_tokens=1))
    server.run()
    cached = np.asarray(server.cache["k"])[:, 0, :, :6]
    _, ref = jax.jit(lambda p, t: jtf.prefill(
        p, t, cfg, 16, cache_dtype=jnp.float32))(jp, jnp.asarray(prompt)[None])
    keys = np.asarray(ref["k"], np.float32) * np.asarray(
        ref["k_scale"])[..., None]                    # dequantized keys
    assert np.abs(keys).max() < 1.0
    assert np.array_equal(cached, np.round(cached))   # whole numbers
    assert np.abs(cached).max() == 127.0               # unscaled int8
    with pytest.raises(ValueError, match="int8"):
        LMServer(tp, port_cfg(cfg), n_slots=1, max_len=16)


def test_serve_lm_matches_repro_keys_and_counts(capsys, monkeypatch):
    init_lm = jtf.init_lm

    def init_lm_compiled(key, cfg):
        # repro's init_lm compiled once: run op by op it takes ~20 s here;
        # serve_lm reads only the parameters
        return jax.jit(lambda k: init_lm(k, cfg)[0])(key), None

    monkeypatch.setattr(jtf, "init_lm", init_lm_compiled)
    arch = "mistral-nemo-12b"
    theirs = repro_serve.serve_lm(repro_arch(arch), argparse.Namespace(
        queries=2, batch=2))
    ours = serve.main(["--arch", arch, "--queries", "2", "--batch", "2",
                       "--device", "cpu"])
    assert ours.keys() == theirs.keys()
    assert (ours["arch"], ours["requests"], ours["tokens"]) == \
        (theirs["arch"], theirs["requests"], theirs["tokens"]) == (arch, 2, 32)
    for a in LM_ARCHS:   # prompts of 8-12 tokens over 2 lanes
        out = serve.main(["--arch", a, "--queries", "5", "--batch", "2",
                          "--device", "cpu"])
        assert out.keys() == theirs.keys() and out["arch"] == a
        assert (out["requests"], out["tokens"]) == (5, 80)
        assert out["tok_per_s"] > 0 and out["mean_ttft_ms"] > 0
        assert get_arch(a).family == "lm"
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 + len(LM_ARCHS)
