"""CUDA kernel: EmbeddingBag over a dense [B, MB] index matrix or a ragged
(indices, offsets) batch.

Replaces ``repro/kernels/embedding_bag.py:41`` ``embedding_bag_dense``:
out[b] = Σ_m w[b, m] · table[idx[b, m]] over the entries with idx >= 0
(an index past the table reads its last row, as the TPU kernel's clip
does), divided by max(#valid, 1) in ``"mean"`` mode.  The table is
float32 or bfloat16; the output has its type, weights are rounded to it
first, and the sum is taken in float32.  One warp per bag
(``csrc/embedding_bag.cu``) gathers the bag's rows with 16-byte loads.
The same kernel reads a ragged batch straight from its flat arrays
(:func:`embedding_bag_ragged`, the function ``repro``'s
``ops.embedding_bag`` computes): no dense copy and no host sync.

Bound on the H100: the bytes gathered — one table row per valid index —
plus the indices, weights and output.

Each wrapper launches the kernel for CUDA tensors and answers CPU tensors
with its plain version: :func:`embedding_bag_dense_plain`, and for the
ragged entry :func:`densify_bags` followed by it.

Gradients: the dense entry is differentiable in ``table`` and ``weights``.
On CUDA tensors a ``torch.autograd.Function`` runs the forward launch and,
in the backward, a second kernel of ``csrc/embedding_bag.cu``
(``d_weights[b, m] = <table[idx[b, m]], g[b]>``, ``d_table[idx[b, m]] +=
w[b, m] * g[b]``, each divided by the bag's count in ``"mean"``; nothing
for a ``-1`` pad).  ``d_table`` is summed in float64 and rounded once to
the table's type: a float32 sum over a row that ~1 M entries share
(DIN's zipf draws), in an order the atomics do not fix, strays further
from the exact one than ``chip_smoke.py``'s 1e-5 of its scale.
:func:`embedding_bag_dense_backward_plain` is its plain version, summing
the same way.  On CPU tensors autograd differentiates the plain forward.
The ragged entry has no backward: it raises when grad mode is on and an
input requires a gradient.
"""

from __future__ import annotations

import ctypes
import torch

from repro_torch.kernels import _build

#: kernel launches (each call on CUDA tensors adds one, either entry) and
#: plain-version calls; the same for the dense entry's backward
launches = 0
plain_calls = 0
backward_launches = 0
backward_plain_calls = 0

MODES = ("sum", "mean")
FLOAT_DTYPES = (torch.float32, torch.bfloat16)
INDEX_DTYPES = (torch.int32, torch.int64)
#: ``max_bag=None``: no bag is cut
NO_CUT = 2**31 - 1
_V, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_launch = None
_backward = None


def embedding_bag_dense_plain(table: torch.Tensor, idx: torch.Tensor,
                              weights: torch.Tensor, mode: str = "sum"):
    """The plain version: gather, weight and reduce in float32, then the
    table's type."""
    global plain_calls
    plain_calls += 1
    valid = idx >= 0
    rows = table[idx.clamp(0, int(table.shape[0]) - 1).long()].float()
    rows = torch.where(valid[..., None], rows * weights.float()[..., None],
                       0.0)
    out = rows.sum(dim=1)
    if mode == "mean":
        out = out / valid.sum(dim=1).clamp(min=1)[:, None].float()
    return out.to(table.dtype)


def embedding_bag_dense_backward_plain(table: torch.Tensor,
                                       idx: torch.Tensor,
                                       weights: torch.Tensor,
                                       grad: torch.Tensor, mode: str = "sum"):
    """The plain backward of :func:`embedding_bag_dense_plain` for the
    output gradient ``grad [B, D]``: (d_table [V, D] in the table's type,
    d_weights [B, MB] in the weights' type), the products in float32,
    d_table's sums in float64; a ``-1`` pad gets d_weights 0 and adds
    nothing."""
    global backward_plain_calls
    backward_plain_calls += 1
    V, D = table.shape
    valid = idx >= 0
    r = idx.clamp(0, int(V) - 1).long()
    g = grad.float()[:, None, :]                                 # [B, 1, D]
    denom = (valid.sum(dim=1).clamp(min=1)[:, None].float()
             if mode == "mean" else torch.ones((), device=table.device))
    dots = (table[r].float() * g).sum(dim=-1)                    # [B, MB]
    d_w = torch.where(valid, dots / denom, 0.0)
    s = torch.where(valid, weights.float() / denom, 0.0)
    d_table = torch.zeros((V, D), dtype=torch.float64, device=table.device)
    d_table.index_add_(0, r.reshape(-1),
                       (s[..., None] * g).reshape(-1, D).double())
    return d_table.to(table.dtype), d_w.to(weights.dtype)


def densify_bags(indices, offsets, weights, max_bag: int | None,
                 dtype: torch.dtype, device):
    """A ragged (indices int32[I], offsets int32[B+1], weights [I] or None)
    batch as (idx int32[B, MB] with -1 padding, weights [B, MB] of
    ``dtype`` with 0 padding), MB = ``max_bag`` or the longest bag (at
    least 1); entries past MB in a bag are dropped (``repro``'s
    ``ops.embedding_bag``)."""
    indices = torch.as_tensor(indices, device=device).to(torch.int32)
    offsets = torch.as_tensor(offsets, device=device).long()
    B = int(offsets.shape[0]) - 1
    n = int(indices.shape[0])
    lens = offsets[1:] - offsets[:-1]
    mb = int(max_bag if max_bag is not None
             else max(int(lens.max()) if B > 0 else 1, 1))
    w = (torch.ones(n, dtype=dtype, device=device) if weights is None
         else torch.as_tensor(weights, device=device).to(dtype))
    at = torch.arange(n, device=device)
    bag = torch.searchsorted(offsets[1:].contiguous(), at, right=True)
    bag_c = bag.clamp(max=max(B - 1, 0))
    pos = at - offsets[bag_c] if B > 0 else at
    ok = (bag < B) & (pos >= 0) & (pos < mb)
    dense = torch.full((B, mb), -1, dtype=torch.int32, device=device)
    wdense = torch.zeros((B, mb), dtype=dtype, device=device)
    dense[bag_c[ok], pos[ok]] = indices[ok]
    wdense[bag_c[ok], pos[ok]] = w[ok]
    return dense, wdense


def _on(x, device, dtypes, to: torch.dtype) -> torch.Tensor:
    """``x`` as a contiguous tensor on ``device`` of one of ``dtypes``,
    converted (to ``to``) only where it is not one already."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    if t.device != device:
        t = t.to(device)
    if t.dtype not in dtypes:
        t = t.to(to)
    return t if t.is_contiguous() else t.contiguous()


def ragged_args(table: torch.Tensor, indices, offsets, weights=None,
                max_bag: int | None = None):
    """The ragged entry's launch arguments on the table's device, as
    (indices, offsets, weights, max_bag): the flat arrays as they are
    (int32 or int64 indices and offsets; float32 or bfloat16 weights,
    rounded to the table's type in the kernel, or None for ones),
    converted only where the kernel does not read them as they are; bag b
    takes entries ``offsets[b] .. min(offsets[b+1], offsets[b] +
    max_bag)``, ``max_bag`` :data:`NO_CUT` when None."""
    dev = table.device
    indices = _on(indices, dev, INDEX_DTYPES, torch.int64)
    offsets = _on(offsets, dev, INDEX_DTYPES, torch.int64)
    if weights is not None:
        weights = _on(weights, dev, FLOAT_DTYPES, table.dtype)
    if indices.dim() != 1 or offsets.dim() != 1 or offsets.numel() < 1 or (
            weights is not None and (weights.dim() != 1
                                     or weights.numel() != indices.numel())):
        raise ValueError(
            f"embedding_bag: indices {tuple(indices.shape)}, offsets "
            f"{tuple(offsets.shape)} and weights "
            f"{None if weights is None else tuple(weights.shape)} must be "
            "[I], [B+1] (B >= 0) and [I] or None")
    if max_bag is None:
        max_bag = NO_CUT
    elif not 0 <= max_bag <= NO_CUT:
        raise ValueError(f"embedding_bag: max_bag must be in [0, {NO_CUT}], "
                         f"got {max_bag}")
    return indices, offsets, weights, int(max_bag)


def _fn():
    global _launch
    if _launch is None:
        fn = _build.library("embedding_bag").embedding_bag_launch
        fn.argtypes = ([_V, _LL, _I, _I, _I, _I, _V, _I, _LL, _V, _I, _V,
                        _I, _I, _I, _I, _V, _V])
        fn.restype = _I
        _launch = fn
    return _launch


def _bfn():
    global _backward
    if _backward is None:
        fn = _build.library("embedding_bag").embedding_bag_backward_launch
        fn.argtypes = [_V, _LL, _I, _I, _I, _V, _V, _I, _V, _I, _I, _I, _V,
                       _V, _V]
        fn.restype = _I
        _backward = fn
    return _backward


def _check_table(table: torch.Tensor, mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"embedding_bag: mode must be one of {MODES}, got "
                         f"{mode!r}")
    if table.dim() != 2 or 0 in table.shape:
        raise ValueError(f"embedding_bag: table {tuple(table.shape)} must be "
                         "[V >= 1, D >= 1]")


def _check(arg: str, t: torch.Tensor, device, dtypes) -> None:
    if t.device != device:
        raise ValueError(f"embedding_bag: {arg} is on {t.device}, expected "
                         f"{device}")
    if t.dtype not in dtypes:
        raise TypeError(f"embedding_bag: {arg} has dtype {t.dtype}, "
                        f"expected one of {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"embedding_bag: {arg} is not contiguous")


def _run(table, dev, idx, weights, offsets, n_bags, max_bag, mode):
    """One launch on ``dev``, every tensor checked by the caller
    (``offsets`` None: the dense entry).  Host time is most of a call at
    serving sizes, so the flags are plain comparisons of dtype singletons."""
    global launches
    V, D = table.shape
    esize = table.element_size()
    ptr = table.data_ptr()
    vec = (D * esize) % 16 == 0 and ptr % 16 == 0
    out = torch.empty((n_bags, D), dtype=table.dtype, device=dev)
    err = _fn()(ptr, V, D, table.dtype is torch.bfloat16, vec,
                _build.lanes_per_row(D, esize, vec), idx.data_ptr(),
                idx.dtype is torch.int64, idx.numel(),
                None if weights is None else weights.data_ptr(),
                0 if weights is None else
                1 if weights.dtype is torch.float32 else 2,
                None if offsets is None else offsets.data_ptr(),
                offsets is not None and offsets.dtype is torch.int64,
                n_bags, max_bag, mode == "mean", out.data_ptr(),
                _build.stream(dev))
    _build.check_launch("embedding_bag", err)
    launches += 1
    return out


def _run_backward(table, idx, weights, grad, mode, want_table: bool,
                  want_weights: bool):
    """The backward launch on the table's device: (d_table in the table's
    type or None, d_weights in the weights' type or None)."""
    global backward_launches
    dev = table.device
    V, D = table.shape
    B, MB = idx.shape
    if tuple(grad.shape) != (B, D):
        raise ValueError(f"embedding_bag: the output gradient "
                         f"{tuple(grad.shape)} must be [{B}, {D}]")
    g = _as_f32(grad)
    d_table = (torch.zeros((V, D), dtype=torch.float64, device=dev)
               if want_table else None)
    d_w = (torch.empty((B, MB), dtype=torch.float32, device=dev)
           if want_weights else None)
    err = _bfn()(table.data_ptr(), V, D, table.dtype is torch.bfloat16,
                 _build.lanes_per_row(D, table.element_size(), False),
                 idx.data_ptr(), weights.data_ptr(),
                 1 if weights.dtype is torch.float32 else 2, g.data_ptr(),
                 B, MB, mode == "mean",
                 None if d_table is None else d_table.data_ptr(),
                 None if d_w is None else d_w.data_ptr(), _build.stream(dev))
    _build.check_launch("embedding_bag", err)
    backward_launches += 1
    return (None if d_table is None else d_table.to(table.dtype),
            None if d_w is None else d_w.to(weights.dtype))


def _as_f32(t: torch.Tensor) -> torch.Tensor:
    t = t if t.dtype is torch.float32 else t.float()
    return t if t.is_contiguous() else t.contiguous()


class _DenseBag(torch.autograd.Function):
    """The dense entry on CUDA tensors with its backward kernel."""

    @staticmethod
    def forward(ctx, table, idx, weights, mode):
        ctx.mode = mode
        ctx.save_for_backward(table, idx, weights)
        B, MB = idx.shape
        return _run(table, table.device, idx, weights, None, B, MB, mode)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        table, idx, weights = ctx.saved_tensors
        d_table, d_w = _run_backward(table, idx, weights, grad, ctx.mode,
                                     ctx.needs_input_grad[0],
                                     ctx.needs_input_grad[2])
        return d_table, None, d_w, None


def embedding_bag_dense(table: torch.Tensor, idx: torch.Tensor,
                        weights: torch.Tensor, mode: str = "sum"):
    """table [V, D] float32|bfloat16, idx int32[B, MB] (-1 skipped),
    weights [B, MB] -> [B, D] in the table's type: the kernel on CUDA
    tensors (differentiable in ``table`` and ``weights`` through the
    backward kernel), the plain version on CPU tensors (differentiated by
    autograd)."""
    _check_table(table, mode)
    dev = table.device
    if dev.type == "cpu":
        return embedding_bag_dense_plain(table, idx, weights, mode)
    _check("table", table, dev, FLOAT_DTYPES)
    if idx.dim() != 2 or weights.shape != idx.shape:
        raise ValueError(f"embedding_bag: idx {tuple(idx.shape)} and weights "
                         f"{tuple(weights.shape)} must be one [B, MB] shape")
    if weights.dtype not in FLOAT_DTYPES:
        weights = weights.to(table.dtype)
    _check("idx", idx, dev, (torch.int32,))
    _check("weights", weights, dev, FLOAT_DTYPES)
    if _build.wants_grad(table, weights):
        return _DenseBag.apply(table, idx, weights, mode)
    B, MB = idx.shape
    return _run(table, dev, idx, weights, None, B, MB, mode)


def embedding_bag_ragged(table: torch.Tensor, indices, offsets, weights=None,
                         mode: str = "sum", max_bag: int | None = None):
    """EmbeddingBag over a ragged batch: indices [I] (-1 skipped), offsets
    [B+1], weights [I] or None (each 1); bag b takes at most ``max_bag``
    entries (all when None).  The kernel on a CUDA table, reading the flat
    arrays; on a CPU table the plain version, :func:`densify_bags` then
    :func:`embedding_bag_dense_plain`.  It has no backward: with grad mode
    on, a table or weights that require a gradient raise."""
    _check_table(table, mode)
    _build.refuse_grad("embedding_bag_ragged", "embedding_bag_dense has "
                       "a backward", table=table, weights=weights)
    dev = table.device
    if dev.type == "cpu":
        idx, w = densify_bags(indices, offsets, weights, max_bag,
                              table.dtype, dev)
        return embedding_bag_dense_plain(table, idx, w, mode)
    _check("table", table, dev, FLOAT_DTYPES)
    idx, off, w, cut = ragged_args(table, indices, offsets, weights, max_bag)
    return _run(table, dev, idx, w, off, off.numel() - 1, cut, mode)
