"""The locus DP at edit budgets 1 and 2 in the port against the JAX
package: the loci and overflow counts of the plain locus DP (dense and
packed) against ``repro.kernels.ref.locus_walk_ref`` on the corpora of
``test_torch_edits.py`` (``tests/torch_edit_corpora.py``), and the edit
transitions' state packing and child windows.  Every output is an
integer, so equality is exact.  Each JAX reference is compiled once, with
XLA's cheapest optimization (``tests/torch_fast_jit.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.core.alphabet import pad_queries
from repro_torch.core.engine import locus
from repro_torch.kernels import locus_dp
from torch_edit_corpora import built_once_a_module  # noqa: F401
from torch_edit_corpora import CORPUS_OF, KINDS, built, corpus
from torch_fast_jit import fast_jax_jit, fast_jit  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

_locus_ref = fast_jit(jref.locus_walk_ref, static_argnums=1)


# -- the locus DP: loci and overflow against repro ----------------------------


@pytest.mark.parametrize("e", [1, 2])
@pytest.mark.parametrize("kind", KINDS)
def test_edit_locus_matches_repro(kind, e):
    """The plain locus DP at E = e, dense and packed, equals
    ``repro.kernels.ref.locus_walk_ref`` on ``repro``'s dense index: loci
    (node ids are shared by the layouts) and overflow counts, which the
    2,000-string cut makes nonzero at E = 2."""
    _, queries = corpus(CORPUS_OF[kind])
    jcfg, j = built("jax", CORPUS_OF[kind], kind, e)
    qa, la = pad_queries([q[:8] for q in queries], 8)
    want = _locus_ref(j.device, jcfg, jnp.asarray(qa), jnp.asarray(la))
    qt, lt = torch.from_numpy(qa), torch.from_numpy(la)
    for compression in ("none", "packed"):
        cfg, p = built("port", CORPUS_OF[kind], kind, e,
                       compression=compression)
        assert cfg.branch_width == jcfg.branch_width
        got = locus_dp.locus_dp_walk(p.tensors, cfg, qt, lt)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=compression)
    if e == 2:
        assert (got[1] > 0).any()


def test_edit_transitions_mirror_repro():
    """The state packing and the dense and packed child windows equal the
    JAX package's on every node."""
    from repro.core.engine import locus as jlocus

    _, j = built("jax", "usps", "et")
    _, p = built("port", "usps", "et")
    _, pp = built("port", "usps", "et", compression="packed")
    _, jp = built("jax", "usps", "et", compression="packed")
    n = int(p.tensors.syn_mask.shape[0])
    nodes = np.concatenate([[-1], np.arange(n)]).astype(np.int32)
    nt = torch.from_numpy(nodes)
    for jt, pt, jcfg in ((j.device, p.tensors, j.cfg),
                         (jp.device, pp.tensors, jp.cfg)):
        want = jlocus.dict_child_window(jt, jcfg, jnp.asarray(nodes))
        got = locus.dict_child_window(pt, p.cfg, nt)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for e in (0, 1, 2):
        d = torch.from_numpy((nodes % (e + 1)).astype(np.int32))
        st = locus.encode_states(nt, d, e)
        np.testing.assert_array_equal(
            np.asarray(jlocus.encode_states(jnp.asarray(nodes),
                                            jnp.asarray(d.numpy()), e)),
            st.numpy())
        back = locus.decode_states(st, e)
        assert torch.equal(back[0], nt)
        assert torch.equal(back[1], torch.where(nt < 0, 0, d))
