"""Decoder-only transformer: dense / GQA / SWA / MoE variants
(``repro``'s ``models/transformer.py`` on one device: training and
serving).

Covers all five LM architectures from one config dataclass:
granite-moe-1b-a400m (MoE 32e top-8), arctic-480b (MoE 128e top-2 + dense
residual), mistral-nemo-12b, h2o-danube-1.8b (SWA), qwen2.5-14b (QKV bias).

The model is an ``nn.Module`` (:class:`TransformerLM`, an
``nn.ModuleList`` of :class:`Block` modules); the functions keep ``repro``'s
names and take the module where ``repro`` takes its parameter tree.  The
dtypes follow ``repro``'s exactly: ``forward`` and ``prefill`` cast the
residual stream to ``activation_dtype`` at entry and after each layer,
``decode_step`` never does.  :func:`params_from_numpy` builds the module
from ``repro``'s ``init_lm`` tree, so both packages compute one function.

Training: :func:`loss_fn` is ``repro``'s (chunked cross-entropy plus
``aux_loss_weight`` times the MoE's load-balance loss), differentiated by
autograd; with ``cfg.remat`` each layer of :func:`forward` runs under
``torch.utils.checkpoint`` in grad mode (``repro`` remats its scan body),
so a layer's activations are recomputed in the backward.  The weights are
created as serving weights (no gradient); ``configs.cells``'s train step
turns gradients on for the model it trains.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import _tree
from repro_torch.models import layers as L

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.int8}


def torch_dtype(name) -> torch.dtype:
    """A config's dtype name (or a torch dtype) as a torch dtype."""
    return name if isinstance(name, torch.dtype) else _DTYPES[name]


@dataclass(frozen=True)
class TransformerConfig:
    name: str = "lm"
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv: int = 2
    d_head: int = 32
    d_ff: int = 256
    vocab: int = 256
    qkv_bias: bool = False
    window: int | None = None          # sliding-window attention
    moe_experts: int = 0               # 0 = dense
    moe_top_k: int = 0
    moe_dense_residual: bool = False   # arctic-style parallel dense FFN
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    remat: bool = True
    aux_loss_weight: float = 0.01
    loss_chunk: int = 512
    param_dtype: str = "float32"
    vocab_pad_to: int = 128    # table rows padded for even vocab sharding
    tp_heads: int = 1          # model-axis size for the padded head layout
    activation_dtype: str = "float32"   # full configs use bfloat16
    cache_dtype: str = "bfloat16"        # serving KV cache; "int8" = KIVI-
                                         # style quantized cache
    seq_parallel: bool = True  # Megatron-SP residual sharding (a mesh's)

    @property
    def padded_vocab(self) -> int:
        m = max(self.vocab_pad_to, 1)
        return (self.vocab + m - 1) // m * m

    @property
    def is_moe(self) -> bool:
        return self.moe_experts > 0

    def param_count(self) -> int:
        d, f = self.d_model, self.d_ff
        attn = 2 * d * self.d_head * (self.n_heads + self.n_kv)
        if self.is_moe:
            ffn = 3 * d * f * self.moe_experts + d * self.moe_experts
            if self.moe_dense_residual:
                ffn += 3 * d * f
        else:
            ffn = 3 * d * f
        per_layer = attn + ffn + 2 * d
        return self.n_layers * per_layer + 2 * self.vocab * d + d

    def active_param_count(self) -> int:
        if not self.is_moe:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        attn = 2 * d * self.d_head * (self.n_heads + self.n_kv)
        ffn = 3 * d * f * self.moe_top_k + d * self.moe_experts
        if self.moe_dense_residual:
            ffn += 3 * d * f
        per_layer = attn + ffn + 2 * d
        return self.n_layers * per_layer + 2 * self.vocab * d + d


def _params(tree: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: _tree.param(v) for k, v in tree.items()})


class Block(nn.Module):
    """One decoder layer's weights: ``attn`` (``wq``, ``wk``, ``wv``,
    ``wo``, the QKV biases where the config has them), ``ln1``, ``ln2``,
    and ``mlp`` and/or ``moe`` — ``repro``'s layer tree, one layer."""

    def __init__(self, tree: dict):
        super().__init__()
        self.attn = _params(tree["attn"])
        self.ln1 = _tree.param(tree["ln1"])
        self.ln2 = _tree.param(tree["ln2"])
        self.mlp = _params(tree["mlp"]) if "mlp" in tree else None
        self.moe = _params(tree["moe"]) if "moe" in tree else None

    def tree(self) -> dict:
        out = {"attn": dict(self.attn), "ln1": self.ln1, "ln2": self.ln2}
        for name in ("mlp", "moe"):
            if getattr(self, name) is not None:
                out[name] = dict(getattr(self, name))
        return out


class TransformerLM(nn.Module):
    """The LM's weights: ``embed [Vp, D]``, ``blocks``, ``final_ln [D]``,
    ``unembed [D, Vp]``, and its config."""

    def __init__(self, cfg: TransformerConfig, tree: dict):
        super().__init__()
        self.cfg = cfg
        self.embed = _tree.param(tree["embed"])
        self.blocks = nn.ModuleList(Block(t) for t in tree["layers"])
        self.final_ln = _tree.param(tree["final_ln"])
        self.unembed = _tree.param(tree["unembed"])

    def forward(self, tokens):
        return forward(self, tokens, self.cfg)

    def n_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def param_tree(self) -> dict:
        """The parameters in ``repro``'s tree: each ``layers`` leaf a tuple
        of the layers' tensors (``repro`` stacks it ``[L, ...]``)."""
        return {"embed": self.embed, "final_ln": self.final_ln,
                "unembed": self.unembed,
                "layers": _tree.stack_leaves([b.tree() for b in self.blocks])}


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype)


def init_layer(generator: torch.Generator, cfg: TransformerConfig) -> dict:
    """One layer's random weights (float32), drawn on the generator's
    device."""
    dev = generator.device
    p = {"attn": L.init_attention(generator, cfg.d_model, cfg.n_heads,
                                  cfg.n_kv, cfg.d_head, cfg.qkv_bias,
                                  tp=cfg.tp_heads),
         "ln1": torch.ones((cfg.d_model,), device=dev),
         "ln2": torch.ones((cfg.d_model,), device=dev)}
    if cfg.is_moe:
        p["moe"] = L.init_moe(generator, cfg.d_model, cfg.d_ff,
                              cfg.moe_experts)
        if cfg.moe_dense_residual:
            p["mlp"] = L.init_mlp(generator, cfg.d_model, cfg.d_ff)
    else:
        p["mlp"] = L.init_mlp(generator, cfg.d_model, cfg.d_ff)
    return p


def init_lm(generator: torch.Generator, cfg: TransformerConfig,
            device="cuda") -> TransformerLM:
    """A model of random weights (normal, std 0.02; norms 1, biases 0) in
    ``cfg.param_dtype``, drawn from ``generator`` on its own device and
    placed on ``device``."""
    dev = generator.device
    vp = cfg.padded_vocab
    tree = {"embed": L._normal(generator, (vp, cfg.d_model)),
            "layers": [init_layer(generator, cfg)
                       for _ in range(cfg.n_layers)],
            "final_ln": torch.ones((cfg.d_model,), device=dev),
            "unembed": L._normal(generator, (cfg.d_model, vp))}
    tree = _cast(tree, torch_dtype(cfg.param_dtype))
    return TransformerLM(cfg, tree).to(device)


def _from_numpy(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":     # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_numpy(tree: dict, cfg: TransformerConfig,
                      device="cuda") -> TransformerLM:
    """The model of ``repro``'s ``init_lm`` parameter tree, given as numpy
    arrays: ``embed``, ``final_ln``, ``unembed`` and ``layers``, whose
    leaves are stacked ``[L, ...]`` (``attn``: ``wq [D, Hp, hd]``, ``wk``,
    ``wv``, ``wo [Hp, hd, D]``, ``bq``/``bk``/``bv``; ``ln1``, ``ln2``;
    ``mlp``; ``moe``'s ``[E, ...]`` experts).  Every leaf is kept in
    ``cfg.param_dtype``."""
    dt = torch_dtype(cfg.param_dtype)

    def layer(sub, i):
        if isinstance(sub, dict):
            return {k: layer(v, i) for k, v in sub.items()}
        return _from_numpy(np.asarray(sub)[i]).to(dt)

    layers = [layer(tree["layers"], i) for i in range(cfg.n_layers)]
    out = {"embed": _from_numpy(tree["embed"]).to(dt), "layers": layers,
           "final_ln": _from_numpy(tree["final_ln"]).to(dt),
           "unembed": _from_numpy(tree["unembed"]).to(dt)}
    return TransformerLM(cfg, out).to(device)


def params_to_numpy(model: TransformerLM) -> dict:
    """The inverse of :func:`params_from_numpy`: ``repro``'s tree layout,
    layer leaves stacked ``[L, ...]`` (bfloat16 weights as float32, which
    holds them exactly)."""

    def np_(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return np.stack([np_(t) for t in trees])

    return {"embed": np_(model.embed),
            "layers": stack([b.tree() for b in model.blocks]),
            "final_ln": np_(model.final_ln), "unembed": np_(model.unembed)}


def _ffn(cfg: TransformerConfig, blk: Block, hn):
    """The layer's feed-forward half on the normed stream: (out, aux)."""
    if cfg.is_moe:
        mo, aux = L.moe_ffn(blk.moe, hn, n_experts=cfg.moe_experts,
                            top_k=cfg.moe_top_k)
        if cfg.moe_dense_residual:
            mo = mo + L.mlp(blk.mlp, hn)
        return mo, aux
    return L.mlp(blk.mlp, hn), torch.zeros((), device=hn.device)


def _layer_fwd(cfg: TransformerConfig, x, blk: Block, positions):
    h, kv = L.attention(blk.attn, L.rms_norm(x, blk.ln1, cfg.norm_eps),
                        n_heads=cfg.n_heads, n_kv=cfg.n_kv,
                        rope_theta=cfg.rope_theta, window=cfg.window,
                        positions=positions, tp=cfg.tp_heads)
    x = x + h
    mo, aux = _ffn(cfg, blk, L.rms_norm(x, blk.ln2, cfg.norm_eps))
    x = x + mo
    return x.to(torch_dtype(cfg.activation_dtype)), aux, kv


def _layer_train(cfg: TransformerConfig, blk: Block, positions, x):
    x, aux, _ = _layer_fwd(cfg, x, blk, positions)
    return x, aux


def forward(params: TransformerLM, tokens, cfg: TransformerConfig):
    """tokens [B, S] -> final hidden [B, S, D] (+ mean aux loss).  With
    ``cfg.remat``, in grad mode on weights that want a gradient, each
    layer is checkpointed."""
    B, S = tokens.shape
    x = L.embed_lookup(params.embed, tokens)
    x = x.to(torch_dtype(cfg.activation_dtype))
    positions = torch.arange(S, device=x.device)[None, :]
    # serving (no gradient wanted) runs as before
    remat = cfg.remat and torch.is_grad_enabled() and any(
        p.requires_grad for p in params.parameters())
    auxes = []
    for blk in params.blocks:
        if remat:
            x, aux = checkpoint(_layer_train, cfg, blk, positions, x,
                                use_reentrant=False)
        else:
            x, aux = _layer_train(cfg, blk, positions, x)
        auxes.append(aux)
    x = L.rms_norm(x, params.final_ln, cfg.norm_eps)
    return x, torch.stack(auxes).mean()


def loss_fn(params: TransformerLM, batch, cfg: TransformerConfig):
    """batch: dict(tokens [B,S], targets [B,S], mask [B,S]) -> (loss,
    {"nll", "aux"})."""
    x, aux = forward(params, batch["tokens"], cfg)
    nll = L.xent_loss_chunked(x, params.unembed, batch["targets"],
                              batch.get("mask"), chunk=cfg.loss_chunk,
                              vocab_real=cfg.vocab)
    loss = nll + cfg.aux_loss_weight * aux
    return loss, {"nll": nll, "aux": aux}


# ---------------------------------------------------------------------------
# serving: prefill + single-token decode with KV cache
# ---------------------------------------------------------------------------


def _span(cfg: TransformerConfig, max_len: int) -> int:
    return min(max_len, cfg.window) if cfg.window else max_len


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               dtype=None, device="cuda"):
    """An empty cache: ``k``/``v`` ``[L, B, KV, span, hd]`` (span = the
    window where it is shorter than ``max_len``), ``pos`` a scalar; the
    int8 cache also ``k_scale``/``v_scale`` ``[L, B, KV, span]``."""
    shape = (cfg.n_layers, batch, cfg.n_kv, _span(cfg, max_len), cfg.d_head)
    quantized = cfg.cache_dtype == "int8"
    dtype = torch_dtype(dtype) if dtype is not None else (
        torch.int8 if quantized else torch_dtype(cfg.cache_dtype))
    cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device),
             "pos": torch.zeros((), dtype=torch.int32, device=device)}
    if quantized and dtype == torch.int8:
        cache["k_scale"] = torch.zeros(shape[:-1], device=device)
        cache["v_scale"] = torch.zeros(shape[:-1], device=device)
    return cache


def _mask_pad_vocab(logits, cfg: TransformerConfig):
    if cfg.padded_vocab == cfg.vocab:
        return logits
    cols = torch.arange(logits.shape[-1], device=logits.device)
    return logits.masked_fill(cols[None, :] >= cfg.vocab, L.NEG)


def _layer_decode(cfg: TransformerConfig, x, blk: Block, cache_layer, pos):
    positions = pos[:, None] if pos.ndim else pos[None, None]
    h, new_cache = L.attention(
        blk.attn, L.rms_norm(x, blk.ln1, cfg.norm_eps),
        n_heads=cfg.n_heads, n_kv=cfg.n_kv, rope_theta=cfg.rope_theta,
        window=cfg.window, positions=positions,
        cache=cache_layer, cache_pos=pos, tp=cfg.tp_heads)
    x = x + h
    mo, _ = _ffn(cfg, blk, L.rms_norm(x, blk.ln2, cfg.norm_eps))
    return x + mo, new_cache


def decode_step(params: TransformerLM, cache, tokens,
                cfg: TransformerConfig):
    """tokens [B] -> (logits [B, V] float32, new cache). One decode
    position; the cache passed in is not written.

    cache["pos"] may be a scalar (lockstep decode) or an int32[B] vector of
    per-slot positions (continuous batching)."""
    x = L.embed_lookup(params.embed, tokens[:, None])
    pos = cache["pos"]
    names = ("k", "v", "k_scale", "v_scale") if "k_scale" in cache \
        else ("k", "v")
    new = {n: [] for n in names}
    for i, blk in enumerate(params.blocks):
        x, nc = _layer_decode(cfg, x, blk, tuple(cache[n][i] for n in names),
                              pos)
        for n, t in zip(names, nc):
            new[n].append(t)
    x = L.rms_norm(x, params.final_ln, cfg.norm_eps)
    logits = L._matmul(x[:, 0], params.unembed).float()
    logits = _mask_pad_vocab(logits, cfg)
    new_cache = {n: torch.stack(ts) for n, ts in new.items()}
    new_cache["pos"] = pos + 1
    return logits, new_cache


def prefill(params: TransformerLM, tokens, cfg: TransformerConfig,
            max_len: int, cache_dtype=torch.bfloat16):
    """Run the prompt, build the KV cache, return last-position logits
    (float32 [B, V]) and the cache."""
    B, S = tokens.shape
    cache_dtype = torch_dtype(cache_dtype)
    x = L.embed_lookup(params.embed, tokens)
    x = x.to(torch_dtype(cfg.activation_dtype))
    positions = torch.arange(S, device=x.device)[None, :]
    span = _span(cfg, max_len)
    ks, vs = [], []
    for blk in params.blocks:
        x, _, (k, v) = _layer_fwd(cfg, x, blk, positions)
        # keep the last `span` positions, placed at slot = position % span
        # (ring layout for SWA; identity when S <= span)
        if S < span:
            ck = torch.nn.functional.pad(k, (0, 0, 0, span - S))
            cv = torch.nn.functional.pad(v, (0, 0, 0, span - S))
        else:
            ck = torch.roll(k[:, :, -span:, :], shifts=S % span, dims=2)
            cv = torch.roll(v[:, :, -span:, :], shifts=S % span, dims=2)
        ks.append(ck.to(cache_dtype))
        vs.append(cv.to(cache_dtype))
    x = L.rms_norm(x, params.final_ln, cfg.norm_eps)
    logits = L._matmul(x[:, -1], params.unembed).float()
    logits = _mask_pad_vocab(logits, cfg)
    ks, vs = torch.stack(ks), torch.stack(vs)
    cache = {"k": ks, "v": vs,
             "pos": torch.full((), S, dtype=torch.int32, device=x.device)}
    if cfg.cache_dtype == "int8" and ks.dtype != torch.int8:
        kq, ksc = L.quantize_kv(ks)
        vq, vsc = L.quantize_kv(vs)
        cache = {"k": kq, "v": vq, "k_scale": ksc, "v_scale": vsc,
                 "pos": cache["pos"]}
    return logits, cache
