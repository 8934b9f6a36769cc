"""The port's training loop on the CPU: ``CheckpointManager`` (atomic
commit, CRC fallback, garbage collection, async save), checkpoints
crossing both ways with ``repro``'s, ``TrainSupervisor``'s restarts in
both packages, and the launcher for one arch of each family.

The models are smoke configs from one numpy tree
(``tests/torch_train_cases.py``).  A restored array equals the saved one
bit for bit; the two packages' runs through a restart agree with each
other within the train-step tolerances (parameters within 1e-5 of each
leaf's largest magnitude, losses within 1e-6 relative).
"""

import json
import os
from functools import partial

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.configs.cells import make_train_step as jmake
from repro.distributed.fault_tolerance import TrainSupervisor as JSupervisor
from repro.optim import apply_updates as japply
from repro.optim import init_optimizer as jinit
from repro_torch.checkpoint import CheckpointManager, restore_latest
from repro_torch.configs.cells import make_train_step as tmake
from repro_torch.distributed import TrainSupervisor
from repro_torch.launch import train
from repro_torch.optim import init_optimizer
from repro_torch.optim.optimizers import leaves
from torch_threads import one_torch_thread  # noqa: F401
from torch_train_cases import Case, as_np, jbatch, leaf_close, tbatch


@pytest.fixture(scope="module")
def din():
    return Case("din")


@pytest.fixture(scope="module")
def lm():
    return Case("arctic-480b")     # stacked layers, Adafactor's state


def port_state(case, opt=None):
    model = case.model()
    return {"params": model,
            "opt": init_optimizer(opt or case.opt, model)}


def arrays(tree):
    return [as_np(x) for x in leaves(tree)]


def state_arrays(state):
    """A {"params": model, "opt": state} tree's arrays in
    ``jax.tree.leaves``'s order (sorted keys: the state first)."""
    return arrays(state["opt"]) + arrays(state["params"].param_tree())


def test_atomic_commit_gc_and_crc_fallback(tmp_path, din):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    state = port_state(din)
    saved = {}
    for step in range(1, 6):
        with torch.no_grad():
            for p in state["params"].parameters():
                p.add_(0.5)
        mgr.save(step, state, extra={"data_step": step})
        saved[step] = state_arrays(state)
    assert mgr.list_steps() == [3, 4, 5]          # the newest 3 kept
    # a write cut mid-way leaves only its .tmp directory: never listed
    os.makedirs(tmp_path / "step_00000009.tmp")
    (tmp_path / "step_00000009.tmp" / "00000.npy").write_bytes(b"partial")
    assert mgr.list_steps() == [3, 4, 5]
    fresh = port_state(din)
    step, tree, extra = mgr.restore(fresh)
    assert (step, extra) == (5, {"data_step": 5}) and tree["params"] is \
        fresh["params"]
    for a, b in zip(state_arrays(fresh), saved[5]):
        assert np.array_equal(a, b)
    # a corrupt array in the newest: the CRC check falls back to step 4
    path = tmp_path / "step_00000005" / "00003.npy"
    raw = bytearray(path.read_bytes())
    raw[-1] ^= 0xFF
    path.write_bytes(bytes(raw))
    step, _, extra = restore_latest(str(tmp_path), fresh)
    assert (step, extra) == (4, {"data_step": 4})
    for a, b in zip(state_arrays(fresh), saved[4]):
        assert np.array_equal(a, b)
    with open(tmp_path / "step_00000004" / "manifest.json") as f:
        manifest = json.load(f)
    assert len(manifest["arrays"]) == len(saved[4])


def test_async_save_copies_before_the_step_moves_on(tmp_path, din):
    mgr = CheckpointManager(str(tmp_path))
    state = port_state(din)
    want = state_arrays(state)
    mgr.save(1, state)           # written by a thread
    with torch.no_grad():        # the next step updates in place at once
        for p in state["params"].parameters():
            p.mul_(-3.0)
    mgr.wait()
    fresh = port_state(din)
    assert mgr.restore(fresh)[0] == 1
    for a, b in zip(state_arrays(fresh), want):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("which", ["lm", "din"])
def test_checkpoints_cross_both_ways(tmp_path, which, lm, din):
    """``repro``'s checkpoint of (params, optimizer state) restores in the
    port, and the port's in ``repro``: equal arrays, equal file names and
    manifest keys."""
    case = lm if which == "lm" else din
    jp = case.jparams()
    # one update from stand-in gradients, so no state array is zero
    jp, jo, _ = jax.jit(partial(japply, case.opt))(
        jp, jax.tree.map(lambda x: 0.1 * x + 0.01, jp),
        jinit(case.opt, jp))
    jstate = {"params": jp, "opt": jo}
    JManager(str(tmp_path / "repro"), async_save=False).save(7, jstate)
    ours = port_state(case)
    step, _, _ = CheckpointManager(str(tmp_path / "repro")).restore(ours)
    assert step == 7
    want = [np.asarray(x) for x in jax.tree.leaves(jstate)]
    got = state_arrays(ours)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # and back: the port's save, repro's restore
    with torch.no_grad():
        for p in ours["params"].parameters():
            p.mul_(0.5)
    CheckpointManager(str(tmp_path / "port"), async_save=False).save(8, ours)
    step, tree, _ = JManager(str(tmp_path / "port")).restore(jstate)
    assert step == 8
    for a, b in zip(jax.tree.leaves(tree), state_arrays(ours)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    names = [sorted(os.listdir(tmp_path / d / f"step_{s:08d}"))
             for d, s in (("repro", 7), ("port", 8))]
    assert names[0] == names[1]
    keys = []
    for d, s in (("repro", 7), ("port", 8)):
        with open(tmp_path / d / f"step_{s:08d}" / "manifest.json") as f:
            keys.append(sorted(json.load(f)["arrays"]))
    assert keys[0] == keys[1]


class Failing:
    """A step function that raises once, before step ``at``."""

    def __init__(self, inner, at):
        self.inner, self.at, self.fired = inner, at, False

    def __call__(self, state, i):
        if i == self.at and not self.fired:
            self.fired = True
            raise RuntimeError("injected failure")
        return self.inner(state, i)


def run_both(tmp_path, case, n_steps, every, fail_at, donate=False):
    """The same supervised run in both packages (batches by step index);
    returns ((final port state, report), (final repro state, report))."""
    batches = [case.batch() for _ in range(n_steps)]
    tstep = tmake(case.tloss, case.tcfg, case.opt)
    jstep = jax.jit(jmake(case.jloss, case.jcfg, case.opt),
                    donate_argnums=(0, 1) if donate else ())

    def port_fn(state, i):
        p, o, _ = tstep(state["params"], state["opt"], tbatch(batches[i]))
        return {"params": p, "opt": o}

    def repro_fn(state, i):
        p, o, _ = jstep(state["params"], state["opt"], jbatch(batches[i]))
        return {"params": p, "opt": o}

    ours = TrainSupervisor(str(tmp_path / "port"), ckpt_every=every).run(
        init_state=port_state(case), step_fn=Failing(port_fn, fail_at),
        n_steps=n_steps)
    jp = case.jparams()
    theirs_sup = JSupervisor(str(tmp_path / "repro"), ckpt_every=every)
    theirs = theirs_sup.run(
        init_state={"params": jp, "opt": jinit(case.opt, jp)},
        step_fn=Failing(repro_fn, fail_at), n_steps=n_steps)
    return ours, theirs


def same_state(ours, theirs):
    for a, b in zip(state_arrays(ours), jax.tree.leaves(theirs)):
        leaf_close(a, b, 2e-5)


def test_supervisor_restarts_from_the_newest_checkpoint(tmp_path, din):
    (ours, rep), (theirs, jrep) = run_both(tmp_path, din, 6, 2, fail_at=5)
    for r in (rep, jrep):
        assert (r.restarts, r.restored_steps, r.steps_run) == (1, [4], 7)
    same_state(ours, theirs)


def test_supervisor_restart_without_a_checkpoint(tmp_path, din):
    """A failure before the first checkpoint restarts from the initial
    state: the port wrote its steps into ``init_state`` in place, so the
    supervisor's host copy of it is what it starts again from; the run
    equals ``repro``'s (undonated) run."""
    (ours, rep), (theirs, jrep) = run_both(tmp_path, din, 4, 10, fail_at=2)
    for r in (rep, jrep):
        assert (r.restarts, r.restored_steps, r.steps_run) == (1, [0], 6)
    same_state(ours, theirs)


def test_repro_restart_without_a_checkpoint_fails_when_donated(tmp_path,
                                                              din):
    """A fault of the reference (ROADMAP.md §3): ``repro``'s launcher
    donates ``init_state``'s buffers to its jitted step, and its
    supervisor restarts from that ``init_state`` when no checkpoint
    exists, so every restart meets deleted buffers until
    ``max_restarts`` is spent."""
    with pytest.raises(Exception, match="deleted or donated"):
        run_both(tmp_path, din, 4, 10, fail_at=2, donate=True)


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "din", "gin-tu"])
def test_launcher(tmp_path, arch, capsys):
    args = ["--arch", arch, "--device", "cpu", "--batch", "4", "--seq",
            "16", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
            "--log-every", "1"]
    out = train.main(args + ["--steps", "3"])
    assert set(out) == {"arch", "steps", "first_loss", "last_loss",
                        "restarts", "stragglers"}
    assert (out["arch"], out["steps"], out["restarts"]) == (arch, 3, 0)
    assert np.isfinite([out["first_loss"], out["last_loss"]]).all()
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("step     0 loss ")
    assert json.loads(lines[-1]) == out
    assert sorted(os.listdir(tmp_path / arch)) == ["step_00000002",
                                                   "step_00000003"]
    again = train.main(args + ["--steps", "5"])   # resumes at step 3
    assert again["restarts"] == 0
    assert "step     3 loss" in capsys.readouterr().out
