"""Train a ~100M-parameter LM for a few hundred steps with the PyTorch/CUDA
port (the counterpart of ``examples/train_lm.py``).

Uses the port's training stack: the token pipeline, the eager train step,
AdamW, checkpointing + the restart supervisor. The config is a scaled
granite-family MoE (12 layers x 512, 8 experts top-2).

  PYTHONPATH=src python examples/torch_train_lm.py [--steps 300]
  PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 20 \\
      --batch 4 --seq 64                                  (on the CPU)
"""

import argparse
import os
import tempfile
import time

import torch

from repro_torch.configs.cells import make_train_step
from repro_torch.core.engine.structs import resolve_device
from repro_torch.data.lm import LMDataConfig, TokenStream
from repro_torch.distributed.fault_tolerance import TrainSupervisor
from repro_torch.models.transformer import TransformerConfig, init_lm, loss_fn
from repro_torch.optim import OptimizerConfig, init_optimizer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_lm"))
    ap.add_argument("--device", default=None,
                    help="default: cuda; pass cpu on a host without one")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    # ~100M params: 12L x 512d with 8 small experts
    cfg = TransformerConfig(
        name="lm100m", n_layers=12, d_model=512, n_heads=8, n_kv=4,
        d_head=64, d_ff=1024, vocab=8192, moe_experts=8, moe_top_k=2,
        loss_chunk=128)
    params = init_lm(torch.Generator(device=dev).manual_seed(0), cfg,
                     device=dev)
    print(f"model: {params.n_params() / 1e6:.1f}M params "
          f"({cfg.active_param_count() / 1e6:.1f}M active)")

    opt_cfg = OptimizerConfig(name="adamw", lr=1e-3, warmup_steps=50,
                              decay_steps=args.steps)
    opt = init_optimizer(opt_cfg, params)
    step_fn = make_train_step(loss_fn, cfg, opt_cfg)
    stream = TokenStream(LMDataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                      global_batch=args.batch))

    sup = TrainSupervisor(args.ckpt, ckpt_every=100)
    losses = []

    def one_step(state, i):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in stream.next_batch().items()}
        t0 = time.perf_counter()
        p, o, m = step_fn(state["params"], state["opt"], batch)
        losses.append(float(m["loss"]))
        if i % 25 == 0:
            print(f"step {i:4d}  loss {losses[-1]:.4f}  "
                  f"lr {float(m['lr']):.2e}  "
                  f"{(time.perf_counter() - t0) * 1e3:.0f}ms", flush=True)
        return {"params": p, "opt": o}

    state, report = sup.run(init_state={"params": params, "opt": opt},
                            step_fn=one_step, n_steps=args.steps,
                            extra_from_state=lambda s: {
                                "data_step": stream.state()})
    print(f"done: loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({report.steps_run} steps, {report.restarts} restarts)")
    assert losses[-1] < losses[0], "training must reduce loss"


if __name__ == "__main__":
    main()
