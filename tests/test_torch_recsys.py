"""The port's recsys models (``repro_torch.models.recsys``) and click stream
(``repro_torch.data.recsys``) against ``repro``'s on the CPU, at the four
recsys archs' smoke configs: one parameter tree from ``repro``'s
``init_*`` goes to both packages as numpy arrays (``params_from_numpy``
for the port), and both run on the same ``ClickStream`` batches.

Tolerances: logits, user embeddings and retrieval scores within 1e-5 of
``repro``'s, relative to their largest magnitude; retrieval ids equal
wherever ``repro``'s neighbouring scores differ by more than that (the
two float32 sums may swap near-tied ids).  The click stream equals
``repro``'s bit for bit.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as repro_arch
from repro.configs.registry import ASSIGNED
from repro.data import recsys as jdata
from repro.models import recsys as jrec
from repro_torch.configs import RECSYS_ARCHS, all_archs, get_arch
from repro_torch.data import recsys as tdata
from repro_torch.kernels import candidate_topk, embedding_bag
from repro_torch.models import recsys as trec
from repro_torch.optim import grad_tree
from repro_torch.optim.optimizers import leaves
from torch_fast_jit import FAST
from torch_threads import one_torch_thread  # noqa: F401
from torch_train_cases import Case, as_np, jbatch, leaf_close, tbatch

TOL = 1e-5
BATCH, K = 6, 10
JAX_FNS = {   # repro's configs/cells.py _REC_FNS: (init, forward, user)
    "dlrm-rm2": (jrec.init_dlrm, jrec.dlrm_forward, jrec.dlrm_user_embedding),
    "din": (jrec.init_din, jrec.din_forward,
            lambda p, b, c: jrec.din_user_embedding(p, b, c)[0]),
    "sasrec": (jrec.init_sasrec, jrec.sasrec_user_embedding,
               jrec.sasrec_user_embedding),
    "mind": (jrec.init_mind, jrec.mind_user_embedding,
             jrec.mind_user_embedding),
}


def close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def same_topk(got, want, tol=TOL):
    """Scores within ``tol``; ids equal away from ``repro``'s near-ties."""
    (gs, gi), (ws, wi) = got, want
    gi, ws, wi = gi.numpy(), np.asarray(ws), np.asarray(wi)
    close(gs, ws, tol)
    assert gi.dtype == np.int32
    scale = max(float(np.abs(ws).max()), 1e-30)
    tie = np.abs(np.diff(ws, axis=1)) <= tol * scale
    near = np.zeros_like(wi, bool)
    near[:, 1:] |= tie
    near[:, :-1] |= tie
    assert ((gi == wi) | near).all(), np.argwhere((gi != wi) & ~near)


def batch_for(arch, cfg, seed=0):
    """One ``ClickStream`` batch in ``repro``'s numpy layout.  The
    sequence archs' first row is a whole history (the stream pads every
    row shorter than ``seq_len``; SASRec reads the last position)."""
    stream = jdata.ClickStream(jdata.RecsysDataConfig(
        n_items=cfg.vocab, seq_len=getattr(cfg, "seq_len", 50), batch=BATCH,
        seed=seed))
    if arch == "dlrm-rm2":
        b = stream.next_dlrm()
        return {"dense": b["dense"], "sparse": b["sparse"]}
    b = stream.next_seq()
    hist = b["hist"].copy()
    hist[0] = np.arange(cfg.seq_len) * 7 % cfg.vocab
    return {"hist": hist, "target": b["target"]}


class Pair:
    """One arch's smoke config and weights in both packages, and a batch."""

    def __init__(self, arch):
        self.arch = arch
        self.jcfg = repro_arch(arch).make_smoke_config()
        self.cfg = get_arch(arch).make_smoke_config()
        init, self.jfwd, self.juser = JAX_FNS[arch]
        jp, _ = init(jax.random.PRNGKey(3), self.jcfg)
        self.tree = jax.tree.map(np.asarray, jp)
        self.jp = jax.tree.map(jnp.asarray, self.tree)
        self.tp = trec.params_from_numpy(self.tree, self.cfg, device="cpu")
        self.np_batch = batch_for(arch, self.cfg)
        self.jb = {k: jnp.asarray(v) for k, v in self.np_batch.items()}
        self.tb = {k: torch.from_numpy(v) for k, v in self.np_batch.items()}
        a = trec.ARCHS[type(self.cfg)]
        self.fwd, self.user, self.table = a.forward, a.user, a.table


@pytest.fixture(scope="module", params=RECSYS_ARCHS)
def pair(request):
    return Pair(request.param)


def test_configs_and_registry_match_repro():
    assert set(ASSIGNED) <= set(all_archs())
    for arch in ASSIGNED:
        ours, theirs = get_arch(arch), repro_arch(arch)
        assert (ours.family, ours.source, ours.notes) == (
            theirs.family, theirs.source, theirs.notes)
        assert ({k: dataclasses.asdict(v) for k, v in ours.shapes.items()}
                == {k: dataclasses.asdict(v)
                    for k, v in theirs.shapes.items()})
        for make in ("make_config", "make_smoke_config"):
            a, b = getattr(ours, make)(), getattr(theirs, make)()
            assert type(a).__name__ == type(b).__name__
            assert dataclasses.asdict(a) == dataclasses.asdict(b), arch


def test_click_stream_equals_repro():
    for cfg in (dict(), dict(n_items=1000, seq_len=12, batch=5, seed=4)):
        ours = tdata.ClickStream(tdata.RecsysDataConfig(**cfg), start_step=2)
        theirs = jdata.ClickStream(jdata.RecsysDataConfig(**cfg),
                                   start_step=2)
        for step in range(3):
            a = (ours.next_dlrm() if step != 1
                 else ours.next_seq(with_negatives=3))
            b = (theirs.next_dlrm() if step != 1
                 else theirs.next_seq(with_negatives=3))
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
            assert ours.state() == theirs.state()


def test_params_round_trip(pair):
    tree = trec.params_to_numpy(pair.tp)
    assert jax.tree.structure(tree) == jax.tree.structure(pair.tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(pair.tree)):
        assert np.array_equal(a, b)
    assert pair.tp.n_params() == sum(x.size for x in jax.tree.leaves(
        pair.tree))
    g = torch.Generator().manual_seed(0)
    fresh = trec.ARCHS[type(pair.cfg)].init(g, pair.cfg, device="cpu")
    assert jax.tree.map(np.shape, trec.params_to_numpy(fresh)) == \
        jax.tree.map(np.shape, pair.tree)


def test_forward_matches_repro(pair):
    want = pair.jfwd(pair.jp, pair.jb, pair.jcfg)
    with torch.no_grad():
        got = pair.tp(pair.tb)
        close(got, want)
        close(pair.fwd(pair.tp, pair.tb, pair.cfg), want)


def test_user_embedding_matches_repro(pair):
    want = pair.juser(pair.jp, pair.jb, pair.jcfg)
    with torch.no_grad():
        got = pair.user(pair.tp, pair.tb, pair.cfg)
    close(got, want)
    if pair.arch == "sasrec":   # the padded rows' last position is 0
        assert np.all(np.asarray(want)[1:][
            pair.np_batch["hist"][1:, -1] < 0] == 0)
        assert np.abs(np.asarray(want)[0]).max() > 0


def test_retrieval_topk_matches_repro(pair):
    C = pair.cfg.vocab - 7
    jcand = pair.jp[pair.table]
    jcand = (jcand[0] if jcand.ndim == 3 else jcand)[:C]
    want = jrec.retrieval_topk(pair.juser(pair.jp, pair.jb, pair.jcfg),
                               jcand, K)
    candidate_topk.plain_calls = 0
    with torch.no_grad():
        user = pair.user(pair.tp, pair.tb, pair.cfg)
        got = trec.retrieval_topk(user, trec.candidates(pair.tp, C), K)
    same_topk(got, want)
    # a [B, D] user goes row by row through candidate_topk; MIND's
    # [B, K, D] interests through the one plain route
    assert candidate_topk.plain_calls == (0 if pair.arch == "mind"
                                          else BATCH)


def test_retrieval_topk_ties_go_to_the_lower_id():
    cand = np.zeros((50, 4), np.float32)
    cand[[3, 17, 40], 0] = 1.0
    for user in (np.ones((2, 4), np.float32), np.ones((2, 3, 4), np.float32)):
        s, i = trec.retrieval_topk(torch.from_numpy(user),
                                   torch.from_numpy(cand), 6)
        ws, wi = jrec.retrieval_topk(jnp.asarray(user), jnp.asarray(cand), 6)
        assert np.array_equal(i.numpy(), np.asarray(wi))
        assert i[0].tolist() == [3, 17, 40, 0, 1, 2]
        close(s, ws)
    with pytest.raises(ValueError, match="k=51"):
        trec.retrieval_topk(torch.ones(1, 4), torch.from_numpy(cand), 51)


@pytest.fixture(scope="module")
def din():
    return Pair("din")


@pytest.mark.parametrize("case", ["all-padded", "none-padded", "mixed"])
def test_din_padded_histories(din, case):
    p = din
    hist = p.np_batch["hist"].copy()
    T = p.cfg.seq_len
    if case == "all-padded":
        hist[:] = -1
    elif case == "none-padded":
        hist[:] = np.arange(BATCH * T).reshape(BATCH, T) % p.cfg.vocab
    else:
        hist[1] = -1
        hist[2, ::2] = -1          # pads inside the history, not only after
    jb = {"hist": jnp.asarray(hist), "target": p.jb["target"]}
    tb = {"hist": torch.from_numpy(hist), "target": p.tb["target"]}
    embedding_bag.plain_calls = 0
    with torch.no_grad():
        user, e_t = trec.din_user_embedding(p.tp, tb, p.cfg)
        logit = trec.din_forward(p.tp, tb, p.cfg)
    assert embedding_bag.plain_calls == 2     # the pooled history, a call
    want_user, want_t = jrec.din_user_embedding(p.jp, jb, p.jcfg)
    if case == "all-padded":
        assert not user.any() and not np.asarray(want_user).any()
    else:
        close(user, want_user)
    close(e_t, want_t)
    close(logit, jrec.din_forward(p.jp, jb, p.jcfg))


def test_padded_ids_read_the_last_row():
    table = torch.arange(12.).view(4, 3)
    assert trec.embedding_lookup(table, torch.tensor([-1, 0])).tolist() == \
        [[9.0, 10.0, 11.0], [0.0, 1.0, 2.0]]
    jt = jnp.asarray(table.numpy())
    assert np.array_equal(np.asarray(jnp.take(jt, jnp.asarray([-1, 0]),
                                              axis=0)),
                          trec.embedding_lookup(table, torch.tensor(
                              [-1, 0])).numpy())
    tables = torch.arange(24.).view(2, 4, 3)
    ids = torch.tensor([[1, -1], [3, 0]], dtype=torch.int32)
    want = jrec.stacked_embedding_lookup(jnp.asarray(tables.numpy()),
                                         jnp.asarray(ids.numpy()))
    assert np.array_equal(trec.stacked_embedding_lookup(tables, ids).numpy(),
                          np.asarray(want))


def test_bce_gradient_at_exact_ties():
    """``repro``'s ``_bce`` at logits of exactly 0 (biases start at 0, so a
    row whose last hidden layer is all zero after the ReLU gives one) and
    the ReLU at exactly 0: the port's gradients equal ``jax.grad``'s."""
    logit = np.array([0.0, 0.0, 1.5, -2.0], np.float32)
    label = np.array([1.0, 0.0, 1.0, 0.0], np.float32)
    want = jax.grad(lambda x: jrec._bce(x, jnp.asarray(label)))(
        jnp.asarray(logit))
    x = torch.from_numpy(logit).requires_grad_(True)
    trec._bce(x, torch.from_numpy(label)).backward()
    got, want = x.grad.numpy(), np.asarray(want)
    assert np.array_equal(got[:2], want[:2])       # the ties, exactly
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    h = torch.zeros(3, requires_grad=True)
    torch.relu(h).sum().backward()
    assert np.array_equal(h.grad.numpy(), np.asarray(jax.grad(
        lambda v: jax.nn.relu(v).sum())(jnp.zeros(3))))


@pytest.mark.parametrize("arch", RECSYS_ARCHS)
def test_losses_are_training(arch):
    """The arch's loss, its metrics and every gradient leaf against
    ``jax.value_and_grad`` of ``repro``'s on a launcher batch (DIN's with
    ``-1`` pads and its last item row used for real): the loss within
    1e-6 relative, each leaf within 1e-5 of its largest magnitude.  The
    DIN pads send no gradient to that row or to the attention MLP, in
    both packages, and the history's bag gives the item table its
    gradient."""
    c = Case(arch)
    b = c.batch()
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        partial(c.jloss, cfg=c.jcfg), has_aux=True),
        compiler_options=FAST)(c.jparams(), jbatch(b))
    model = c.model().requires_grad_(True)
    tl, tm = c.tloss(model, tbatch(b), c.tcfg)
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= 1e-6 * abs(float(jl))
    assert tm.keys() == jm.keys()
    for k in tm:
        leaf_close(tm[k], jm[k], 1e-6)
    got, want = leaves(grad_tree(model)), jax.tree.leaves(jg)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        leaf_close(g, w, 1e-5)
    assert all(float(np.abs(as_np(g)).max()) > 0 for g in got)
