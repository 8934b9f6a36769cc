"""Shared NN layers of the LM (``repro``'s ``models/layers.py`` on one
device), plain functions on tensors.

Each function takes its parameters as a mapping of tensors (a dict or an
``nn.ParameterDict``) and computes what ``repro``'s function of the same
name computes, in the same dtypes: where ``repro`` mixes bfloat16
activations with float32 weights, JAX promotes the product to float32, so
the port casts both operands to the promoted dtype (:func:`_einsum`).

Included:
  - flash-style chunked attention (online softmax over KV blocks) so a
    long prefill never materializes an [S, S] score matrix,
  - sliding-window attention with true sub-quadratic compute (per query
    block only window+block keys are sliced in),
  - GQA decode against a KV cache (scalar or per-slot positions, a ring
    buffer under a window, an optional int8 cache),
  - SwiGLU MLP and capacity-bounded token-choice MoE on one device,
  - chunked cross-entropy (never materializes [B, S, V] logits: each
    chunk runs under ``torch.utils.checkpoint``, so its logits are
    recomputed in the backward instead of kept).

Autograd differentiates every function here.  The mesh routes (the
sequence-sharded flash decode, expert-parallel MoE) are ROADMAP.md §1
item 12.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

#: the score given to masked keys (finite, as ``repro``'s: a fully masked
#: row stays finite)
NEG = -1e30


def _as(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` in ``dtype``, with no dispatch where it is already."""
    return x if x.dtype == dtype else x.to(dtype)


def _promoted(a: torch.Tensor, b: torch.Tensor):
    """``a`` and ``b`` in the dtype JAX's promotion gives the pair (a cast
    only where one is needed: each dispatch costs host time)."""
    if a.dtype == b.dtype:
        return a, b
    dt = torch.promote_types(a.dtype, b.dtype)
    return _as(a, dt), _as(b, dt)


def _repeat_kv(x, g: int):
    """jnp.repeat(x, g, axis=1) of x [B, KV, S, hd]: each KV head g times
    in a row, as one copy."""
    if g == 1:
        return x
    B, KV, S, hd = x.shape
    return x[:, :, None].expand(B, KV, g, S, hd).reshape(B, KV * g, S, hd)


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.einsum(eq, *_promoted(a, b))


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = _promoted(a, b)
    return a @ b


def _heads_in(x, w):
    """einsum("bsd,dnh->bnsh", x, w) as one matmul: x [B,S,D], w [D,N,H]."""
    B, S, D = x.shape
    x, w = _promoted(x, w)
    return (x @ w.reshape(D, -1)).reshape(B, S, *w.shape[1:]).transpose(1, 2)


def _heads_out(o, w):
    """einsum("bnsh,nhd->bsd", o, w) as one matmul: o [B,N,S,H],
    w [N,H,D]."""
    B, N, S, H = o.shape
    o, w = _promoted(o, w)
    return o.transpose(1, 2).reshape(B, S, N * H) @ w.reshape(N * H, -1)


def _normal(generator: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=generator,
                       device=generator.device) * 0.02


def rms_norm(x, w, eps=1e-6):
    dt = x.dtype
    if dt != torch.float32:
        x = x.float()
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return _as(x * w, dt)


# ---------------------------------------------------------------------------
# RoPE (interleaved pairs (0::2, 1::2))
# ---------------------------------------------------------------------------


def rope_freqs(d_head: int, theta: float, device=None):
    return theta ** (-torch.arange(0, d_head, 2, dtype=torch.float32,
                                   device=device) / d_head)


def _rope_angles(positions, d: int, theta: float, device):
    ang = positions[..., None].float() * rope_freqs(d, theta, device)
    return torch.cos(ang), torch.sin(ang)               # [..., S, d/2]


def _rotate(x, cos, sin):
    x1, x2 = x[..., 0::2], x[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(o1.shape[:-1] + x.shape[-1:])
    return _as(out, x.dtype)


def apply_rope(x, positions, theta: float):
    """x: [..., S, d_head]; positions: broadcastable to [..., S]."""
    return _rotate(x, *_rope_angles(positions, x.shape[-1], theta, x.device))


# ---------------------------------------------------------------------------
# attention (GQA + causal + optional sliding window), flash-style chunking
# ---------------------------------------------------------------------------


def _online_softmax_block(q, k, v, mask, m, l, acc, scale):
    """One KV block of online-softmax attention.

    q [B,N,bq,hd], k/v [B,N,bk,hd], mask [.., bq, bk] bool (True=keep)."""
    s = _as(_einsum("bnqh,bnkh->bnqk", q, k), torch.float32) * scale
    s = s.masked_fill(~mask, NEG)
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * alpha + p.sum(dim=-1)
    acc_new = acc * alpha[..., None] + _as(_einsum(
        "bnqk,bnkh->bnqh", _as(p, v.dtype), v), torch.float32)
    return m_new, l_new, acc_new


def flash_attention(q, k, v, *, causal=True, window: int | None = None,
                    block_q: int = 512, block_kv: int = 512,
                    q_offset: int = 0):
    """Chunked attention. q [B,N,Sq,hd], k/v [B,N,Skv,hd] (N = query heads;
    callers fold GQA groups into N by repeating KV).

    q_offset: absolute position of q[0] relative to k[0] (prefill: 0 with
    Sq == Skv; continuation chunks use > 0).
    """
    B, N, Sq, hd = q.shape
    Skv = k.shape[2]
    dev = q.device
    scale = 1.0 / math.sqrt(hd)
    block_q = min(block_q, Sq)
    block_kv = min(block_kv, Skv)
    nq = (Sq + block_q - 1) // block_q
    pad_q = nq * block_q - Sq
    if pad_q:
        q = F.pad(q, (0, 0, 0, pad_q))
    ar_q = torch.arange(block_q, device=dev)

    def init():
        return (torch.full((B, N, block_q), NEG, dtype=torch.float32,
                           device=dev),
                torch.zeros((B, N, block_q), dtype=torch.float32, device=dev),
                torch.zeros((B, N, block_q, hd), dtype=torch.float32,
                            device=dev))

    outs = []
    if window is not None:
        # sub-quadratic: per q block slice [lo, lo + window + block_q) keys
        span = window + block_q
        kp = F.pad(k, (0, 0, span, span))
        vp = F.pad(v, (0, 0, span, span))
        ar_k = torch.arange(span, device=dev)
        for i in range(nq):
            qb = q[:, :, i * block_q:(i + 1) * block_q]
            q_pos = q_offset + i * block_q + ar_q
            lo = q_offset + i * block_q + block_q - span  # original coords
            # a dynamic slice's start is clamped so that the slice fits
            start = min(max(lo + span, 0), kp.shape[2] - span)
            kb = kp[:, :, start:start + span]
            vb = vp[:, :, start:start + span]
            k_pos = lo + ar_k
            mask = k_pos[None, :] <= q_pos[:, None]
            mask &= k_pos[None, :] > q_pos[:, None] - window
            mask &= (k_pos[None, :] >= 0) & (k_pos[None, :] < Skv)
            m, l, acc = _online_softmax_block(qb, kb, vb, mask, *init(),
                                              scale)
            outs.append(acc / l.clamp_min(1e-30)[..., None])
        out = torch.cat(outs, dim=2)
        return out[:, :, :Sq].to(q.dtype)

    nkv = (Skv + block_kv - 1) // block_kv
    pad_kv = nkv * block_kv - Skv
    if pad_kv:
        k = F.pad(k, (0, 0, 0, pad_kv))
        v = F.pad(v, (0, 0, 0, pad_kv))
    ar_kv = torch.arange(block_kv, device=dev)
    for i in range(nq):
        qb = q[:, :, i * block_q:(i + 1) * block_q]
        q_pos = q_offset + i * block_q + ar_q
        m, l, acc = init()
        for j in range(nkv):
            if causal and j * block_kv > q_offset + (i + 1) * block_q - 1:
                # every key of this block and after lies past every query
                # of the block: the online softmax would leave m, l and
                # acc exactly as they are
                break
            kb = k[:, :, j * block_kv:(j + 1) * block_kv]
            vb = v[:, :, j * block_kv:(j + 1) * block_kv]
            k_pos = j * block_kv + ar_kv
            mask = k_pos[None, :] < Skv
            if causal:
                mask = mask & (k_pos[None, :] <= q_pos[:, None])
            m, l, acc = _online_softmax_block(qb, kb, vb, mask, m, l, acc,
                                              scale)
        outs.append(acc / l.clamp_min(1e-30)[..., None])
    out = torch.cat(outs, dim=2)
    return out[:, :, :Sq].to(q.dtype)


def head_layout(n_heads: int, n_kv: int, tp: int):
    """Pad the query-head dim so it tiles evenly over a tp-way model axis.

    KV heads are logically replicated (weights stay [KV]; activations are
    repeated), and query heads are padded with inert slots whose output is
    masked to zero — exact GQA(H, KV) at any tp.
    Returns (Hp padded q-heads, head_mask bool[Hp]).
    """
    g = n_heads // n_kv
    if n_heads % n_kv:
        raise ValueError("q heads must divide evenly into kv groups")
    if tp <= 1:
        return n_heads, np.ones(n_heads, bool)
    if n_kv >= tp:
        if n_kv % tp:
            raise ValueError(f"n_kv {n_kv} does not tile tp {tp}")
        r = 1
    else:
        if tp % n_kv:
            raise ValueError(f"tp {tp} is not a multiple of n_kv {n_kv}")
        r = tp // n_kv
    gp = -(-g // r)                    # q heads per replicated kv slot
    hp = n_kv * r * gp
    mask = np.zeros(hp, bool)
    for j in range(n_kv * r):          # kv' slot j = copy (j % r) of kv j//r
        c = j % r
        gi = g // r + (1 if c < g % r else 0)
        mask[j * gp : j * gp + gi] = True
    return hp, mask


def init_attention(generator, d_model, n_heads, n_kv, d_head,
                   qkv_bias=False, tp: int = 1) -> dict:
    """Random attention weights, drawn from ``generator`` on its device."""
    hp, _ = head_layout(n_heads, n_kv, tp)
    dev = generator.device
    p = {
        "wq": _normal(generator, (d_model, hp, d_head)),
        "wk": _normal(generator, (d_model, n_kv, d_head)),
        "wv": _normal(generator, (d_model, n_kv, d_head)),
        "wo": _normal(generator, (hp, d_head, d_model)),
    }
    if qkv_bias:
        p |= {"bq": torch.zeros((hp, d_head), device=dev),
              "bk": torch.zeros((n_kv, d_head), device=dev),
              "bv": torch.zeros((n_kv, d_head), device=dev)}
    return p


def attention(p, x, *, n_heads, n_kv, rope_theta, window=None,
              positions=None, cache=None, cache_pos=None, tp: int = 1):
    """GQA attention. Train/prefill: x [B,S,D], cache None -> (out, (k, v)).
    Decode: x [B,1,D] with cache (k,v) [B,KV,Sc,hd] (or (k, v, k_scale,
    v_scale) int8) -> (out, new cache); ``cache_pos`` a scalar or one
    position a row.  The cache passed in is not written.

    Query heads use the tp-padded layout (head_layout); the inert padded
    slots are masked out of wo, so this is exact GQA(H, KV) at any tp."""
    B, S, D = x.shape
    dev = x.device
    hp, hmask = head_layout(n_heads, n_kv, tp)
    g = hp // n_kv
    q = _heads_in(x, p["wq"])
    k = _heads_in(x, p["wk"])
    v = _heads_in(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"][None, :, None, :]
        k = k + p["bk"][None, :, None, :]
        v = v + p["bv"][None, :, None, :]

    if positions is None:
        positions = torch.arange(S, device=dev)[None, :]
    cos, sin = _rope_angles(positions[:, None, :], q.shape[-1], rope_theta,
                            dev)
    q, k = _rotate(q, cos, sin), _rotate(k, cos, sin)

    if cache is None:
        kk, vv = _repeat_kv(k, g), _repeat_kv(v, g)
        out = flash_attention(q, kk, vv, causal=True, window=window)
        new_cache = (k, v)
    else:
        quantized = len(cache) == 4
        if quantized:
            ck, cv, ksc, vsc = cache   # int8 caches + fp32 scales [B,KV,Sc]
            kq, ks_new = quantize_kv(k)
            vq, vs_new = quantize_kv(v)
            k_store, v_store = kq, vq
        else:
            ck, cv = cache             # [B, KV, Sc, hd]
            ksc = vsc = None
            k_store, v_store = k, v
        B_, KV_, Sc, _ = ck.shape
        pos = torch.as_tensor(cache_pos, device=dev)
        slot = pos % Sc if window is not None else pos
        # a write past the cache's end lands on its last slot (the
        # reference's dynamic_update_slice and clip both clamp)
        sl = slot.clamp(0, Sc - 1)
        if pos.ndim == 0:
            ck = _cache_set(ck, k_store, sl)
            cv = _cache_set(cv, v_store, sl)
            if quantized:
                ksc = _cache_set(ksc, ks_new, sl)
                vsc = _cache_set(vsc, vs_new, sl)
        else:  # per-slot positions (continuous batching)
            bi = torch.arange(B_, device=dev)
            ck, cv = ck.clone(), cv.clone()
            ck[bi, :, sl, :] = _as(k_store[:, :, 0, :], ck.dtype)
            cv[bi, :, sl, :] = _as(v_store[:, :, 0, :], cv.dtype)
            if quantized:
                ksc, vsc = ksc.clone(), vsc.clone()
                ksc[bi, :, sl] = ks_new[:, :, 0]
                vsc[bi, :, sl] = vs_new[:, :, 0]
        if quantized:
            kk = _repeat_kv(dequantize_kv(ck, ksc, q.dtype), g)
            vv = _repeat_kv(dequantize_kv(cv, vsc, q.dtype), g)
        else:
            kk, vv = _repeat_kv(ck, g), _repeat_kv(cv, g)
        kpos = torch.arange(Sc, device=dev)
        posb = pos if pos.ndim else pos[None]           # [B] or [1]
        slotb = slot if pos.ndim else slot[None]
        if window is not None:
            # ring buffer: valid entries are the last min(pos+1, Sc)
            age = (slotb[:, None] - kpos[None, :]) % Sc
            valid = age <= posb.clamp_max(Sc - 1)[:, None]
        else:
            valid = kpos[None, :] <= posb[:, None]      # [B or 1, Sc]
        s = _as(_einsum("bnqh,bnkh->bnqk", q, kk), torch.float32)
        s = s / math.sqrt(q.shape[-1])
        s = s.masked_fill(~valid[:, None, None, :], NEG)
        w = _as(torch.softmax(s, dim=-1), x.dtype)
        out = _einsum("bnqk,bnkh->bnqh", w, vv)
        new_cache = (ck, cv, ksc, vsc) if quantized else (ck, cv)

    if not hmask.all():  # zero the inert padded head slots
        out = out * torch.as_tensor(hmask, dtype=out.dtype,
                                    device=dev)[None, :, None, None]
    return _heads_out(out, p["wo"]), new_cache


def _cache_set(cache, kv, slot):
    """cache [B,KV,Sc(,hd)]; kv [B,KV,1(,hd)]; write at ``slot`` (clamped
    to the cache, as a dynamic update slice clamps), out of place."""
    sl = torch.as_tensor(slot, device=cache.device).clamp(
        0, cache.shape[2] - 1).reshape(1).long()
    return cache.index_copy(2, sl, _as(kv, cache.dtype))


def quantize_kv(x):
    """Per-(batch, head, position) int8 KV quantization. x [B,KV,S,hd] ->
    (int8 [B,KV,S,hd], fp32 scale [B,KV,S])."""
    scale = x.abs().amax(dim=-1).clamp_min(1e-8).float() / 127.0
    q = torch.round(x / scale[..., None].to(x.dtype)).clamp(-127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q, scale, dtype):
    return (q.float() * scale[..., None]).to(dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU) and MoE
# ---------------------------------------------------------------------------


def init_mlp(generator, d_model, d_ff) -> dict:
    return {"w_gate": _normal(generator, (d_model, d_ff)),
            "w_up": _normal(generator, (d_model, d_ff)),
            "w_down": _normal(generator, (d_ff, d_model))}


def mlp(p, x):
    h = F.silu(_matmul(x, p["w_gate"])) * _matmul(x, p["w_up"])
    return _matmul(h, p["w_down"])


def init_moe(generator, d_model, d_ff, n_experts) -> dict:
    return {"router": _normal(generator, (d_model, n_experts)),
            "w_gate": _normal(generator, (n_experts, d_model, d_ff)),
            "w_up": _normal(generator, (n_experts, d_model, d_ff)),
            "w_down": _normal(generator, (n_experts, d_ff, d_model))}


def _moe_local(p_local, x, *, top_k, n_experts, expert_offset, n_local,
               capacity_factor=1.25, norm_topk=True):
    """MoE over the experts ``p_local`` holds: x [T, D] tokens, experts
    ``expert_offset`` .. ``expert_offset + n_local - 1``.

    Token-choice top-k with per-expert capacity: a token's place in an
    expert's queue is its order among the tokens that chose it, and
    tokens past the capacity are dropped.  Returns (y [T, D], aux loss).
    """
    T, D = x.shape
    dev = x.device
    logits = _matmul(x, p_local["router"]).float()            # [T, E]
    probs = torch.softmax(logits, dim=-1)

    # top-k selection: repro's k rounds of argmax (ties to the first
    # expert, the chosen one set to -1 between rounds) are the first k of
    # a stable descending sort (probabilities are >= 0)
    sel_p, sel_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    sel_p, sel_idx = sel_p[:, :top_k], sel_idx[:, :top_k]       # [T, k]
    if norm_topk:
        sel_p = sel_p / sel_p.sum(dim=1, keepdim=True).clamp_min(1e-9)

    # per-LOCAL-expert chosen mask + gate
    le = sel_idx - expert_offset                              # [T, k]
    in_local = (le >= 0) & (le < n_local)
    # a token's k experts are distinct, so a scatter over all k at once
    # is the k updates in turn (clipped entries outside the local experts
    # add False and 0.0)
    lek = le.clamp(0, n_local - 1)
    chosen = torch.zeros((T, n_local), dtype=torch.int32,
                         device=dev).scatter_reduce(
        1, lek, in_local.to(torch.int32), "amax").bool()
    gate = torch.zeros((T, n_local), dtype=torch.float32,
                       device=dev).scatter_add(
        1, lek, torch.where(in_local, sel_p, 0.0))

    capacity = max(int(T * top_k * capacity_factor / n_experts), 4)
    pos = torch.cumsum(chosen.to(torch.int32), dim=0) - 1     # [T, E_l]
    slot_ok = chosen & (pos < capacity)
    # token table [E_l, capacity]: a write not kept goes to one spare
    # entry past the table, which is dropped
    flat = torch.where(
        slot_ok, torch.arange(n_local, device=dev)[None, :] * capacity + pos,
        n_local * capacity)
    table = torch.full((n_local * capacity + 1,), -1, dtype=torch.int32,
                       device=dev)
    tok_ids = torch.arange(T, dtype=torch.int32,
                           device=dev)[:, None].expand(T, n_local)
    table[flat.reshape(-1)] = tok_ids.reshape(-1)
    table = table[:-1].reshape(n_local, capacity)

    tvalid = table >= 0
    tsafe = table.clamp(0, T - 1).long()
    xin = x[tsafe] * tvalid[..., None]                         # [E_l, C, D]
    h = F.silu(_einsum("ecd,edf->ecf", xin, p_local["w_gate"])) \
        * _einsum("ecd,edf->ecf", xin, p_local["w_up"])
    y = _einsum("ecf,efd->ecd", h, p_local["w_down"])          # [E_l, C, D]

    g = gate[tsafe, torch.arange(n_local, device=dev)[:, None]]  # [E_l, C]
    y = y * (g * tvalid)[..., None]
    out = torch.zeros((T, D), dtype=y.dtype, device=dev).index_add_(
        0, tsafe.reshape(-1), y.reshape(-1, D) * tvalid.reshape(-1)[:, None])

    # load-balance aux loss
    frac_tokens = torch.zeros((n_experts,), dtype=torch.float32,
                              device=dev).index_add_(
        0, sel_idx.reshape(-1).clamp(0, n_experts - 1),
        torch.ones(T * top_k, device=dev)) / (T * top_k)
    mean_prob = probs.mean(dim=0)
    aux = n_experts * torch.sum(frac_tokens * mean_prob)
    return out.to(x.dtype), aux


def moe_ffn(p, x, *, n_experts, top_k, capacity_factor=1.25, norm_topk=True):
    """x [B, S, D] -> (y [B, S, D], aux loss): every expert on this device
    (the expert-parallel route over a mesh is ROADMAP.md §1 item 12)."""
    B, S, D = x.shape
    y, aux = _moe_local(p, x.reshape(B * S, D), top_k=top_k,
                        n_experts=n_experts, expert_offset=0,
                        n_local=n_experts, capacity_factor=capacity_factor,
                        norm_topk=norm_topk)
    return y.reshape(B, S, D), aux


# ---------------------------------------------------------------------------
# embedding
# ---------------------------------------------------------------------------


def embed_lookup(table, tokens):
    return F.embedding(torch.as_tensor(tokens, device=table.device).long(),
                       table)


def xent_loss_chunked(x, w_unembed, targets, mask=None, chunk: int = 512,
                      vocab_real: int | None = None, reduce: str = "mean"):
    """Mean next-token cross entropy without materializing [B,S,V].

    x [B,S,D], w_unembed [D,V], targets [B,S] (already shifted), mask [B,S].
    vocab_real: when the vocab dim is padded for sharding, logits beyond it
    are masked out of the softmax.  ``reduce="sum"`` returns (summed nll,
    token count).  When a gradient is wanted each chunk is checkpointed,
    as ``repro`` remats its scan body.
    """
    B, S, D = x.shape
    dev = x.device
    chunk = min(chunk, S)
    n = (S + chunk - 1) // chunk
    pad = n * chunk - S
    targets = torch.as_tensor(targets, device=dev).long()
    mask = (torch.ones((B, S), dtype=torch.bool, device=dev) if mask is None
            else torch.as_tensor(mask, device=dev).bool())
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))
    V = w_unembed.shape[-1]
    cols = torch.arange(V, device=dev)
    masked = vocab_real is not None and vocab_real < V

    def body(xc, w, tc, mc):
        logits = _as(_matmul(xc, w), torch.float32)
        if masked:
            logits = logits.masked_fill(cols >= vocab_real, NEG)
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, tc[..., None])[..., 0]
        return ((lse - ll) * mc).sum()

    remat = torch.is_grad_enabled() and (x.requires_grad
                                         or w_unembed.requires_grad)
    tot = torch.zeros((), dtype=torch.float32, device=dev)
    cnt = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        args = (x[:, sl], w_unembed, targets[:, sl], mask[:, sl])
        part = (checkpoint(body, *args, use_reentrant=False) if remat
                else body(*args))
        tot = tot + part
        cnt = cnt + mask[:, sl].sum()
    if reduce == "sum":
        return tot, cnt
    return tot / torch.clamp_min(cnt, 1)
