"""The port's LM layers (``repro_torch.models.layers``) against ``repro``'s
on the CPU: the same inputs, made from a numpy seed, through both.

Tolerances: float32 results within 1e-5 of ``repro``'s (relative to the
result's largest magnitude, at least 1), bfloat16 within 2e-2; integer
results (int8 cache values, head layouts, the MoE's dropped tokens) equal.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL
from torch_threads import one_torch_thread  # noqa: F401

F32_TOL, BF16_TOL = 1e-5, 2e-2


def jit(fn, **static):
    """``repro``'s function compiled once: JAX's op-by-op dispatch compiles
    every op of an un-jitted call apart."""
    return jax.jit(partial(fn, **static))


def rng(seed=0):
    return np.random.default_rng(seed)


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)   # no JAX op to compile


def close(got, want, tol=F32_TOL):
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol * scale, (err, scale)


def both(a, dtype="float32"):
    """The same array for both packages, in ``dtype``."""
    a = np.asarray(a, np.float32)
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def params(shapes: dict, seed: int):
    r = rng(seed)
    arrs = {k: (r.standard_normal(s) * 0.2).astype(np.float32)
            for k, s in shapes.items()}
    return ({k: jnp.asarray(v) for k, v in arrs.items()},
            {k: torch.from_numpy(v) for k, v in arrs.items()})


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL),
                                       ("bfloat16", BF16_TOL)])
def test_rms_norm(dtype, tol):
    xj, xt = both(rng(1).standard_normal((2, 5, 16)) * 3, dtype)
    wj, wt = both(1 + 0.1 * rng(2).standard_normal(16))
    got, want = TL.rms_norm(xt, wt), JL.rms_norm(xj, wj)
    assert got.dtype == getattr(torch, dtype)
    close(got, want, tol)


@pytest.mark.parametrize("theta", [10_000.0, 1e6])
@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL),
                                       ("bfloat16", BF16_TOL)])
def test_apply_rope_interleaved(theta, dtype, tol):
    xj, xt = both(rng(3).standard_normal((2, 3, 7, 16)), dtype)
    pos = rng(4).integers(0, 5000, (2, 7))
    want = JL.apply_rope(xj, jnp.asarray(pos)[:, None, :], theta)
    got = TL.apply_rope(xt, torch.as_tensor(pos)[:, None, :], theta)
    assert got.dtype == xt.dtype
    close(got, want, tol)


FLASH = [  # (Sq, Skv, causal, window, q_offset, block)
    (37, 37, True, None, 0, 16),     # Sq not a multiple of the block
    (37, 37, False, None, 0, 16),
    (37, 37, True, 8, 0, 16),        # window smaller than the block
    (40, 40, True, 24, 0, 8),        # window spanning several blocks
    (10, 30, True, None, 20, 4),     # a continuation chunk
    (10, 30, True, 6, 20, 4),
    (5, 5, True, None, 0, 512),      # one block of the default size
]


@pytest.mark.parametrize("sq,skv,causal,window,q_offset,block", FLASH)
def test_flash_attention(sq, skv, causal, window, q_offset, block):
    r = rng(5)
    qj, qt = both(r.standard_normal((2, 3, sq, 8)))
    kj, kt = both(r.standard_normal((2, 3, skv, 8)))
    vj, vt = both(r.standard_normal((2, 3, skv, 8)))
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              block_q=block, block_kv=block)
    close(TL.flash_attention(qt, kt, vt, **kw),
          jit(JL.flash_attention, **kw)(qj, kj, vj))


def test_flash_attention_matches_dense_softmax():
    """The chunked online softmax equals one dense masked softmax."""
    r = rng(6)
    q, k, v = (torch.from_numpy(r.standard_normal((1, 2, 33, 8))
                                .astype(np.float32)) for _ in range(3))
    s = (q @ k.transpose(-1, -2)) / np.sqrt(8)
    i = torch.arange(33)
    keep = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - 5)
    want = torch.softmax(s.masked_fill(~keep, -1e30), -1) @ v
    close(TL.flash_attention(q, k, v, window=5, block_q=8, block_kv=8), want)


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("n_heads,n_kv", [(4, 2), (8, 2), (32, 8), (56, 8),
                                          (16, 8), (40, 8), (4, 1)])
def test_head_layout(n_heads, n_kv, tp):
    hp, mask = TL.head_layout(n_heads, n_kv, tp)
    hp_j, mask_j = JL.head_layout(n_heads, n_kv, tp)
    assert hp == hp_j and np.array_equal(mask, mask_j)
    assert int(mask.sum()) == n_heads


def _attn_params(tp, bias, seed=7, d=24, heads=6, kv=2, hd=8):
    hp, _ = TL.head_layout(heads, kv, tp)
    shapes = {"wq": (d, hp, hd), "wk": (d, kv, hd), "wv": (d, kv, hd),
              "wo": (hp, hd, d)}
    if bias:
        shapes |= {"bq": (hp, hd), "bk": (kv, hd), "bv": (kv, hd)}
    return params(shapes, seed)


# 6 query heads over 2 KV heads: at tp=4 two padded head slots are inert
ATTN_KW = dict(n_heads=6, n_kv=2, rope_theta=10_000.0)


@pytest.mark.parametrize("tp,bias,window", [(1, False, None), (1, True, 5),
                                             (2, True, None), (4, False, 5),
                                             (4, True, None)])
def test_attention_prefill(tp, bias, window):
    pj, pt = _attn_params(tp, bias)
    xj, xt = both(rng(8).standard_normal((2, 11, 24)))
    yj, (kj, vj) = jit(JL.attention, window=window, tp=tp, **ATTN_KW)(pj, xj)
    yt, (kt, vt) = TL.attention(pt, xt, window=window, tp=tp, **ATTN_KW)
    close(yt, yj)
    close(kt, kj)
    close(vt, vj)


def test_attention_prefill_bf16_activations_promote_to_f32():
    """bfloat16 activations against float32 weights compute in float32, as
    JAX promotes them; the output is float32 too."""
    pj, pt = _attn_params(1, True)
    xj, xt = both(rng(9).standard_normal((1, 6, 24)), "bfloat16")
    yj, _ = jit(JL.attention, **ATTN_KW)(pj, xj)
    yt, _ = TL.attention(pt, xt, **ATTN_KW)
    assert yj.dtype == jnp.float32 and yt.dtype == torch.float32
    close(yt, yj)


def _cache(sc, seed, b=3, quantized=False):
    r = rng(seed)
    k, v = (r.standard_normal((b, 2, sc, 8)).astype(np.float32) * 0.5
            for _ in range(2))
    if not quantized:
        return ((jnp.asarray(k), jnp.asarray(v)),
                (torch.from_numpy(k), torch.from_numpy(v)))
    kq, ks = JL.quantize_kv(jnp.asarray(k))
    vq, vs = JL.quantize_kv(jnp.asarray(v))
    jc = (kq, vq, ks, vs)
    return jc, tuple(torch.from_numpy(np.array(a)) for a in jc)


DECODE = [  # (window, positions): scalar or one a row
    (None, 4),
    (None, [0, 3, 7]),
    (None, [2, 9, 15]),      # past the cache's end: clamped to its last slot
    (6, 4),
    (6, 13),                 # the ring has wrapped
    (6, [1, 6, 20]),         # one row short of the ring, two wrapped
]


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("window,pos,tp", [d + (1,) for d in DECODE]
                         + [(None, [0, 3, 7], 4), (6, [1, 6, 20], 4)])
def test_attention_decode(window, pos, quantized, tp):
    sc = 6 if window else 8
    pj, pt = _attn_params(tp, True)
    xj, xt = both(rng(10).standard_normal((3, 1, 24)))
    cj, ct = _cache(sc, 11, quantized=quantized)
    pos_np = np.asarray(pos, np.int32)
    positions = pos_np[:, None] if pos_np.ndim else pos_np[None, None]
    yj, ncj = jit(JL.attention, window=window, tp=tp, **ATTN_KW)(
        pj, xj, cache=cj, cache_pos=jnp.asarray(pos_np),
        positions=jnp.asarray(positions))
    yt, nct = TL.attention(pt, xt, window=window, tp=tp, cache=ct,
                           cache_pos=torch.as_tensor(pos_np),
                           positions=torch.as_tensor(positions), **ATTN_KW)
    close(yt, yj)
    assert len(nct) == len(ncj)
    for a, b in zip(nct, ncj):
        if quantized and a.dtype == torch.int8:
            assert np.array_equal(a.numpy(), np.asarray(b))
        else:
            close(a, b)
    assert not torch.equal(nct[0], ct[0])   # the cache passed in is kept


def test_per_slot_write_past_the_end_clamps_to_the_last_slot():
    """Without a window a row whose position is past the cache's end
    overwrites the cache's last slot (repro clips the index); the port
    keeps the clamp."""
    pj, pt = _attn_params(1, False)
    _, xt = both(rng(12).standard_normal((3, 1, 24)))
    _, ct = _cache(8, 13)
    pos = torch.tensor([2, 8, 30], dtype=torch.int32)
    _, (ck, cv) = TL.attention(pt, xt, cache=ct, cache_pos=pos,
                               positions=pos[:, None], **ATTN_KW)
    changed = (ck != ct[0]).any(dim=(1, 3))          # [B, Sc]
    assert changed[0].nonzero().flatten().tolist() == [2]
    assert changed[1].nonzero().flatten().tolist() == [7]
    assert changed[2].nonzero().flatten().tolist() == [7]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_roundtrip(dtype):
    xj, xt = both(rng(14).standard_normal((2, 3, 5, 8)) * 2, dtype)
    xt[0, 0, 0] = 0.0                                 # an all-zero row
    xj = xj.at[0, 0, 0].set(0.0)
    qj, sj = JL.quantize_kv(xj)
    qt, st = TL.quantize_kv(xt)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert np.array_equal(qt.numpy(), np.asarray(qj))
    close(st, sj, 0.0)
    close(TL.dequantize_kv(qt, st, torch.float32),
          JL.dequantize_kv(qj, sj, jnp.float32), 0.0)


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL),
                                       ("bfloat16", F32_TOL)])
def test_mlp(dtype, tol):
    pj, pt = params({"w_gate": (16, 24), "w_up": (16, 24),
                     "w_down": (24, 16)}, 15)
    xj, xt = both(rng(16).standard_normal((2, 5, 16)), dtype)
    got, want = TL.mlp(pt, xt), JL.mlp(pj, xj)
    assert got.dtype == torch.float32          # promoted by the weights
    close(got, want, tol)


def _moe_params(e, seed, d=16, f=8, skew=0.0):
    pj, pt = params({"router": (d, e), "w_gate": (e, d, f),
                     "w_up": (e, d, f), "w_down": (e, f, d)}, seed)
    if skew:   # route almost every token to expert 0
        pj["router"] = pj["router"].at[:, 0].add(skew)
        pt["router"][:, 0] += skew
    return pj, pt


def _dropped(x, router, e, k):
    """Token-expert choices past an expert's capacity."""
    probs = torch.softmax(x.reshape(-1, x.shape[-1]) @ router, -1)
    top = probs.topk(k, dim=-1).indices
    counts = torch.bincount(top.flatten(), minlength=e)
    cap = max(int(top.shape[0] * k * 1.25 / e), 4)
    return int((counts - cap).clamp_min(0).sum())


@pytest.mark.parametrize("e,k,skew,tokens,ties", [
    (4, 2, 0.0, (2, 5), False), (8, 2, 3.0, (4, 8), False),
    (32, 8, 0.0, (3, 7), False),
    (8, 3, 0.0, (2, 6), True)])    # zero tokens: every expert ties
def test_moe_ffn(e, k, skew, tokens, ties):
    pj, pt = _moe_params(e, 17, skew=skew)
    x = rng(18).standard_normal(tokens + (16,)) * 2
    if ties:
        x[:, ::2] = 0.0
    xj, xt = both(x)
    if skew:      # the skewed batch drops tokens past expert 0's capacity
        assert _dropped(xt, pt["router"], e, k) > 0
    yj, aux_j = jit(JL.moe_ffn, n_experts=e, top_k=k)(pj, xj)
    yt, aux_t = TL.moe_ffn(pt, xt, n_experts=e, top_k=k)
    close(yt, yj)
    close(aux_t, aux_j)


def test_embed_lookup():
    tj, tt = both(rng(19).standard_normal((10, 4)))
    ids = rng(20).integers(0, 10, (2, 3))
    close(TL.embed_lookup(tt, torch.as_tensor(ids)),
          JL.embed_lookup(tj, jnp.asarray(ids)), 0.0)


def test_init_draws_from_the_generator():
    """Random init is reproducible from a seeded torch.Generator."""
    def draw():
        g = torch.Generator().manual_seed(3)
        return (TL.init_attention(g, 16, 4, 2, 8, qkv_bias=True, tp=2),
                TL.init_mlp(g, 16, 24), TL.init_moe(g, 16, 8, 4))
    a, b = draw(), draw()
    for pa, pb in zip(a, b):
        assert pa.keys() == pb.keys()
        assert all(torch.equal(pa[n], pb[n]) for n in pa)
    attn = a[0]
    assert attn["wq"].shape == (16, 4, 8) and attn["wo"].shape == (4, 8, 16)
    assert float(attn["bq"].abs().sum()) == 0.0
    assert 0.015 < float(a[1]["w_up"].std()) < 0.025
