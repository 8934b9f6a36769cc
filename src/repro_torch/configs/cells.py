"""The train step of ``repro``'s ``configs/cells.py`` (``make_train_step``)
and its recsys table ``_REC_FNS``.

``repro``'s cell builders (``build_cell`` and the ``_build_*`` functions)
lower a step onto a TPU mesh for dry runs; they wait with the mesh routes
(ROADMAP.md §1 item 12), and ``param_axes`` (gradients constrained to a
parameter sharding) raises ``not_ported("mesh")``.
"""

from __future__ import annotations

from repro_torch.models import recsys as rec_m
from repro_torch.not_ported import not_ported
from repro_torch.optim import apply_updates, grad_tree


def _detached(metrics: dict) -> dict:
    return {k: v.detach() for k, v in metrics.items()}


def make_train_step(loss_fn, model_cfg, opt_cfg, param_axes=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: one eager step on the model ``params`` (an ``nn.Module``;
    its gradients are turned on, as the model now trains): the loss and
    its backward, then :func:`apply_updates`, which writes the parameters
    and the state in place.  Metrics: ``loss``, the loss function's own,
    ``lr`` and ``grad_norm`` (0-d tensors on the device, no host sync).

    ``opt_cfg.accum_steps > 1`` splits the batch's leading axis into that
    many micro-batches, in order; their gradients are summed in the
    parameters' dtype (``.grad`` accumulates) and divided by the count,
    and the loss and metrics are their means, as ``repro``'s scan gives
    them."""
    if param_axes is not None:
        raise not_ported("mesh")
    accum = max(opt_cfg.accum_steps, 1)

    def train_step(params, opt_state, batch):
        params.requires_grad_(True)
        params.zero_grad(set_to_none=True)
        if accum == 1:
            loss, metrics = loss_fn(params, batch, model_cfg)
            loss.backward()
            loss, metrics = loss.detach(), _detached(metrics)
        else:
            parts = []
            for i in range(accum):
                mb = {k: v[i * (v.shape[0] // accum):
                           (i + 1) * (v.shape[0] // accum)]
                      for k, v in batch.items()}
                l, m = loss_fn(params, mb, model_cfg)
                l.backward()
                parts.append((l.detach(), _detached(m)))
            for p in params.parameters():
                if p.grad is not None:
                    p.grad.div_(accum)
            loss = sum(l for l, _ in parts) / accum
            metrics = {k: sum(m[k] for _, m in parts) / accum
                       for k in parts[0][1]}
        params, opt_state, om = apply_updates(opt_cfg, params,
                                              grad_tree(params), opt_state)
        params.zero_grad(set_to_none=True)
        return params, opt_state, {"loss": loss, **metrics, **om}
    return train_step


#: per recsys arch: (init, loss, serving forward, user embedding, the
#: candidate table's key), as ``repro``'s ``_REC_FNS``; the rows of
#: ``models.recsys.ARCHS``
_REC_FNS = {
    name: (a.init, a.loss, a.forward, a.user, a.table)
    for name, a in (("dlrm-rm2", rec_m.ARCHS[rec_m.DLRMConfig]),
                    ("din", rec_m.ARCHS[rec_m.DINConfig]),
                    ("sasrec", rec_m.ARCHS[rec_m.SASRecConfig]),
                    ("mind", rec_m.ARCHS[rec_m.MINDConfig]))
}
