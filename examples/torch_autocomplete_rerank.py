"""Trie proposes, model re-ranks, on the PyTorch/CUDA port: the completion
index fetches cheap candidates; a SASRec user model re-scores them by
per-user affinity.  The counterpart of ``autocomplete_rerank.py`` (the
same lines; the model's random weights come from a torch generator, not
JAX's).  Runs on the card; pass ``--device cpu`` to run the kernels'
plain versions on the CPU.

  PYTHONPATH=src python examples/torch_autocomplete_rerank.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.core import CompletionIndex, make_rules
from repro_torch.models import recsys
from repro_torch.serving import CompletionService


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="the index's and the model's device (default: cuda)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    # -- a tiny product-title catalogue with abbreviations -------------------
    products = [
        "mechanical keyboard rgb", "mechanical keyboard silent",
        "memory card 128gb", "memory card 256gb", "monitor 27 inch 4k",
        "monitor 32 inch curved", "mouse wireless ergonomic",
        "mouse pad extended", "microphone usb condenser",
        "macbook case 14 inch",
    ]
    scores = [90, 70, 85, 60, 95, 55, 80, 40, 75, 65]
    rules = make_rules([("mech", "mechanical"), ("kb", "keyboard"),
                        ("mem", "memory"), ("mon", "monitor"),
                        ("mic", "microphone"), ("wl", "wireless")])
    index = CompletionIndex.build(products, scores, rules, kind="et",
                                  device=dev)

    # -- a user-affinity reranker (SASRec user embedding vs title embedding)
    cfg = recsys.SASRecConfig(vocab=len(products), seq_len=8, d_embed=16)
    params = recsys.init_sasrec(torch.Generator(device=dev).manual_seed(0),
                                cfg, device=dev)
    title_to_id = {t: i for i, t in enumerate(products)}
    # pretend the user recently browsed monitors
    user_hist = torch.tensor([[title_to_id["monitor 27 inch 4k"],
                               title_to_id["monitor 32 inch curved"],
                               -1, -1, -1, -1, -1, -1]], device=dev)
    with torch.no_grad():
        user_vec = recsys.sasrec_user_embedding(params, {"hist": user_hist},
                                                cfg)[0]
    item_emb = params.items.detach()

    def rerank(query, candidates):
        if not candidates:
            return candidates
        ids = torch.tensor([title_to_id[s] for _, s in candidates],
                           device=dev)
        affinity = (item_emb[ids] @ user_vec).cpu().numpy()
        order = np.argsort(-affinity)
        return [(float(affinity[i]), candidates[i][1]) for i in order]

    service = CompletionService(index, reranker=rerank, overfetch=2)
    plain = CompletionService(index)

    for q in ("m", "mon", "mem c", "mech kb"):
        a = [s for _, s in plain.complete([q], k=3)[0]]
        b = [s for _, s in service.complete([q], k=3)[0]]
        print(f"{q!r:8} popularity: {a}")
        print(f"{'':8} user-aware: {b}\n")


if __name__ == "__main__":
    main()
