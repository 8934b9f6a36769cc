"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

  python -m repro_torch.launch.train --arch h2o-danube-1.8b --steps 20
  python -m repro_torch.launch.train --arch din --device cpu --steps 5

``repro``'s launcher on one device (CUDA unless ``--device`` names
another): the arch's smoke config (``--full``: its published config),
random weights drawn on the host from a generator seeded 0 (so every
device starts from the same weights), the family's data pipeline
(``TokenStream``, ``ClickStream``, the neighbor sampler), the eager train
step of ``configs.cells.make_train_step`` with the arch's optimizer, and
``TrainSupervisor`` (checkpoints every ``--ckpt-every`` steps under
``--ckpt-dir/<arch>``, restarts from the newest valid one, the straggler
watchdog).  It logs ``repro``'s step lines and ends with one JSON line
(``arch``, ``steps``, ``first_loss``, ``last_loss``, ``restarts``,
``stragglers``).  A ``torch.distributed`` world of more than one process
(``repro``'s mesh) is ROADMAP.md §1 item 12.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import all_archs
from repro_torch.configs.cells import _REC_FNS, make_train_step
from repro_torch.core.engine.structs import resolve_device
from repro_torch.data.graph import NeighborSampler, make_random_graph
from repro_torch.data.lm import LMDataConfig, TokenStream
from repro_torch.data.recsys import ClickStream, RecsysDataConfig
from repro_torch.distributed.fault_tolerance import TrainSupervisor
from repro_torch.models import gnn as gnn_m
from repro_torch.models import transformer as tf
from repro_torch.not_ported import not_ported
from repro_torch.optim import init_optimizer


def _generator() -> torch.Generator:
    return torch.Generator().manual_seed(0)


def _lm_setup(spec, smoke, batch, seq, dev):
    cfg = spec.make_smoke_config() if smoke else spec.make_config()
    params = tf.init_lm(_generator(), cfg, device=dev)
    stream = TokenStream(LMDataConfig(vocab=cfg.vocab, seq_len=seq,
                                      global_batch=batch))
    step = make_train_step(tf.loss_fn, cfg, spec.optimizer)
    return cfg, params, stream.next_batch, step, stream


def _gnn_setup(spec, smoke, batch, seq, dev):
    base = spec.make_smoke_config() if smoke else spec.make_config()
    cfg = gnn_m.GINConfig(name=base.name, n_layers=base.n_layers,
                          d_hidden=base.d_hidden, d_feat=32, n_classes=8)
    g = make_random_graph(2000, 12000, 32, 8, seed=0)
    sampler = NeighborSampler(g, seed=0)

    def next_batch():
        seeds = np.random.default_rng(sampler.rng.integers(2**31)).choice(
            g.n_nodes, batch, replace=False)
        return sampler.sample(seeds, (10, 5), n_pad=batch * 61,
                              e_pad=batch * 60)

    params = gnn_m.init_gin(_generator(), cfg, device=dev)
    step = make_train_step(gnn_m.loss_full_graph, cfg, spec.optimizer)
    return cfg, params, next_batch, step, None


def _recsys_setup(spec, smoke, batch, seq, dev):
    cfg = spec.make_smoke_config() if smoke else spec.make_config()
    init, loss_fn = _REC_FNS[spec.arch_id][0], _REC_FNS[spec.arch_id][1]
    params = init(_generator(), cfg, device=dev)
    stream = ClickStream(RecsysDataConfig(
        n_items=cfg.vocab, batch=batch, seq_len=getattr(cfg, "seq_len", 50)))

    def next_batch():
        if spec.arch_id == "dlrm-rm2":
            return stream.next_dlrm()
        raw = stream.next_seq(with_negatives=8)
        if spec.arch_id == "sasrec":
            return {"hist": raw["hist"], "pos": raw["pos"],
                    "neg": raw["neg_seq"]}
        return {k: raw[k] for k in
                ("hist", "target", "label", "neg")
                if k in raw} if spec.arch_id == "mind" else \
            {k: raw[k] for k in ("hist", "target", "label")}

    step = make_train_step(loss_fn, cfg, spec.optimizer)
    return cfg, params, next_batch, step, stream


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="device the model trains on (default: cuda; pass "
                         "cpu on a host without one)")
    return ap


def _world_size() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def main(argv=None) -> dict:
    """Train ``--steps`` steps; returns the final JSON line's dict."""
    args = parser().parse_args(argv)
    if _world_size() > 1:
        raise not_ported("mesh")
    spec = all_archs()[args.arch]
    setup = {"lm": _lm_setup, "gnn": _gnn_setup,
             "recsys": _recsys_setup}[spec.family]
    dev = resolve_device(args.device)
    cfg, params, next_batch, step_fn, stream = setup(
        spec, args.smoke, args.batch, args.seq, dev)
    opt_state = init_optimizer(spec.optimizer, params)

    sup = TrainSupervisor(f"{args.ckpt_dir}/{args.arch}",
                          ckpt_every=args.ckpt_every)
    hist = []

    def one_step(state, i):
        params, opt_state = state["params"], state["opt"]
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in next_batch().items()}
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        if i % args.log_every == 0:
            dt = time.perf_counter() - t0
            print(f"step {i:5d} loss {loss:8.4f} "
                  f"gnorm {float(metrics['grad_norm']):7.3f} {dt*1e3:7.1f}ms",
                  flush=True)
        hist.append(loss)
        return {"params": params, "opt": opt_state}

    state, report = sup.run(
        init_state={"params": params, "opt": opt_state},
        step_fn=one_step, n_steps=args.steps)

    out = {
        "arch": args.arch, "steps": args.steps,
        "first_loss": hist[0] if hist else None,
        "last_loss": hist[-1] if hist else None,
        "restarts": report.restarts,
        "stragglers": len(report.straggler_events),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
