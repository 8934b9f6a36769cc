"""One training case an arch for the training parity tests: ``repro``'s
parameter tree as numpy arrays, both packages' configs and loss
functions, and batches of the arch's launcher data (``repro``'s numpy
generators, equal to the port's bit for bit).

The ten archs are ``repro``'s assigned ones at their smoke configs, GIN
at the launcher's d_feat 32 and 8 classes.  Trees: the LMs' from a numpy
seed in ``init_lm``'s layout (``tests/torch_lm_trees.py``), the recsys
and GNN ones from ``repro``'s ``init_*``, jitted (GIN's eps set away
from 0).
Batches: the LM's ``TokenStream`` rows with a mask that drops a fifth of
the positions and a length that pads the last loss chunk; DIN's with
``-1`` pads and a real use of the last item row (``repro`` gathers that
row for a pad); GIN's from the launcher's neighbor sampler.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_arch as repro_arch
from repro.configs.cells import _REC_FNS as J_REC_FNS
from repro.data.graph import NeighborSampler, make_random_graph
from repro.data.lm import LMDataConfig, TokenStream
from repro.data.recsys import ClickStream, RecsysDataConfig
from repro.models import gnn as jgnn
from repro.models import transformer as jtf
from repro_torch.configs import GNN_ARCHS, LM_ARCHS, RECSYS_ARCHS, get_arch
from repro_torch.configs.cells import _REC_FNS as T_REC_FNS
from repro_torch.models import gnn as tgnn
from repro_torch.models import recsys as trec
from repro_torch.models import transformer as ttf
from torch_fast_jit import FAST
from torch_lm_trees import port_cfg, random_tree

ARCHS = LM_ARCHS + RECSYS_ARCHS + GNN_ARCHS
BATCH, SEQ = 8, 24


def gin_cfgs(arch):
    base = repro_arch(arch).make_smoke_config()
    kw = dict(name=base.name, n_layers=base.n_layers,
              d_hidden=base.d_hidden, d_feat=32, n_classes=8)
    return jgnn.GINConfig(**kw), tgnn.GINConfig(**kw)


def jit_init(init, key, cfg) -> dict:
    """``repro``'s ``init(key, cfg)`` parameter tree as numpy arrays,
    compiled as one program (op by op, its first call compiles each op
    and takes seconds)."""
    jp = jax.jit(lambda k: init(k, cfg)[0], compiler_options=FAST)(key)
    return jax.tree.map(np.asarray, jp)


class Case:
    """``arch``'s smoke config in both packages, ``repro``'s tree as numpy
    arrays, the two loss functions and a batch source."""

    def __init__(self, arch):
        self.arch = arch
        self.family = repro_arch(arch).family
        self.opt = repro_arch(arch).optimizer
        if self.family == "lm":
            self.jcfg = repro_arch(arch).make_smoke_config()
            self.tcfg = port_cfg(self.jcfg)
            self.tree = random_tree(self.jcfg, 1)
            self.jloss, self.tloss = jtf.loss_fn, ttf.loss_fn
            self._stream = TokenStream(LMDataConfig(
                vocab=self.jcfg.vocab, seq_len=SEQ, global_batch=BATCH))
        elif self.family == "recsys":
            self.jcfg = repro_arch(arch).make_smoke_config()
            self.tcfg = get_arch(arch).make_smoke_config()
            init, self.jloss = J_REC_FNS[arch][:2]
            self.tloss = T_REC_FNS[arch][1]
            self.tree = jit_init(init, jax.random.PRNGKey(3), self.jcfg)
            self._stream = ClickStream(RecsysDataConfig(
                n_items=self.jcfg.vocab, batch=BATCH,
                seq_len=getattr(self.jcfg, "seq_len", 50)))
        else:
            self.jcfg, self.tcfg = gin_cfgs(arch)
            self.jloss, self.tloss = jgnn.loss_full_graph, tgnn.loss_full_graph
            self.tree = jit_init(jgnn.init_gin, jax.random.PRNGKey(2),
                                 self.jcfg)
            for i, lp in enumerate(self.tree["layers"]):
                lp["eps"] = np.float32(0.1 * (i + 1))
            g = make_random_graph(300, 1800, 32, 8, seed=0)
            self._sampler = NeighborSampler(g, seed=0)
            self._graph = g

    def batch(self) -> dict:
        """The next batch as numpy arrays."""
        if self.family == "lm":
            b = self._stream.next_batch()
            r = np.random.default_rng(self._stream.step)
            b["mask"] = r.random(b["mask"].shape) < 0.8
            return b
        if self.family == "gnn":
            seeds = np.random.default_rng(
                self._sampler.rng.integers(2**31)).choice(
                    self._graph.n_nodes, 4, replace=False)
            return self._sampler.sample(seeds, (10, 5), n_pad=4 * 61,
                                        e_pad=4 * 60)
        if self.arch == "dlrm-rm2":
            return self._stream.next_dlrm()
        raw = self._stream.next_seq(with_negatives=8)
        if self.arch == "sasrec":
            return {"hist": raw["hist"], "pos": raw["pos"],
                    "neg": raw["neg_seq"]}
        if self.arch == "mind":
            return {k: raw[k] for k in ("hist", "target", "label", "neg")}
        b = {k: raw[k] for k in ("hist", "target", "label")}
        V = self.jcfg.vocab
        assert (b["hist"] < 0).any()           # pads
        b["hist"][1, 0] = V - 1                # the pads' row, really used
        b["target"][2] = V - 1
        return b

    def jparams(self, tree=None):
        return jax.tree.map(jnp.asarray, self.tree if tree is None else tree)

    def model(self, tree=None):
        """The port's model of ``tree`` (default: the case's) on the CPU."""
        tree = self.tree if tree is None else tree
        if self.family == "lm":
            return ttf.params_from_numpy(tree, self.tcfg, device="cpu")
        if self.family == "recsys":
            return trec.params_from_numpy(tree, self.tcfg, device="cpu")
        return tgnn.params_from_numpy(tree, self.tcfg, device="cpu")


def jbatch(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def tbatch(b: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def as_np(x) -> np.ndarray:
    if isinstance(x, tuple):
        return np.stack([as_np(t) for t in x])
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).numpy().copy()
    return np.asarray(x, dtype=np.float32) if np.asarray(x).dtype.kind == "f" \
        else np.asarray(x)


def leaf_close(got, want, tol, what=""):
    """Each leaf pair within ``tol`` of the leaf's largest magnitude."""
    got, want = as_np(got), as_np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)
