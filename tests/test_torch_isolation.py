"""The port stands alone: it imports neither JAX nor the JAX package (nor
do ``chip_smoke.py`` and the port's examples), runs on the CUDA device
unless told otherwise, and raises on every option outside the ported
slices (the mesh routes of training: sharded gradients, a multi-process
launch, elastic re-sharding) and on a gradient that a kernel without a
backward cannot give."""

import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch as rt
from repro_torch.core.engine.substrate import resolve_substrate
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.cells import make_train_step
from repro_torch.distributed import TrainSupervisor
from repro_torch.kernels import candidate_topk, embedding_bag
from repro_torch.launch import train
from repro_torch.models import gnn
from repro_torch.models.transformer import TransformerConfig, loss_fn
from repro_torch.optim import OptimizerConfig
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PAPER = (["andrew pavlo", "andrew parker", "william smith"], [50, 40, 20],
         [("andy", "andrew"), ("bill", "william")])
FORBIDDEN = ("jax", "jaxlib", "repro")
EXAMPLES = ("examples/torch_quickstart.py",
            "examples/torch_serve_autocomplete.py",
            "examples/torch_autocomplete_rerank.py",
            "examples/torch_train_lm.py")


def _run(args, cwd, with_src=True):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    if with_src:
        env["PYTHONPATH"] = str(ROOT / "src")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_and_chip_smoke_import_no_jax():
    pkg = ROOT / "src" / "repro_torch"
    mods = ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages([str(pkg)], "repro_torch.")]
    for mod in ("repro_torch.kernels.locus_dp", "repro_torch.kernels.ops",
                "repro_torch.api.compile_cache", "repro_torch.core.oracle",
                "repro_torch.core.api", "repro_torch.analysis.shm",
                "repro_torch.analysis.__main__", "repro_torch.models.recsys",
                "repro_torch.models.gnn", "repro_torch.data.recsys",
                "repro_torch.data.graph", "repro_torch.configs.gin_tu",
                "repro_torch.configs.dlrm_rm2"):
        assert mod in mods, mod
    code = (
        "import importlib, runpy, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "runpy.run_path('chip_smoke.py', run_name='chip_smoke')\n"
        f"for p in {EXAMPLES!r}: runpy.run_path(p, run_name='example')\n"
        "print('LOADED', sorted(m for m in sys.modules\n"
        f"      if m.split('.')[0] in {FORBIDDEN!r}))\n")
    out = _run(["-c", code], ROOT)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_chip_smoke_source_imports_only_the_port():
    for line in (ROOT / "chip_smoke.py").read_text().splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]):
            assert words[1].split(".")[0] not in FORBIDDEN, line


@pytest.mark.parametrize("path", EXAMPLES)
def test_example_source_imports_only_the_port(path):
    for line in (ROOT / path).read_text().splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]):
            assert words[1].split(".")[0] not in FORBIDDEN, line


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    out = _run(["chip_smoke.py"], ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    out = _run(["chip_smoke.py"], tmp_path, with_src=False)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("entry", ["build_index", "load_index",
                                   "CompletionIndex.load"])
def test_default_device_raises_without_cuda(monkeypatch, tmp_path, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry == "build_index":
            rt.build_index(*PAPER[:2], [])
        elif entry == "load_index":
            rt.load_index(str(tmp_path / "missing.npz"))
        else:
            rt.CompletionIndex.load(str(tmp_path / "missing.npz"))


def test_auto_substrate_follows_the_device():
    idx = rt.build_index(*PAPER[:2], [], device="cpu")
    assert idx.substrate == "torch" and idx.device.type == "cpu"
    assert rt.IndexSpec().substrate == "auto"
    assert resolve_substrate("auto", "cuda") == "cuda"
    assert resolve_substrate("cuda", "cpu") == "cuda"
    with pytest.raises(ValueError, match="unknown substrate"):
        resolve_substrate("jnp", "cpu")


def _gin_state():
    model = gnn.init_gin(torch.Generator().manual_seed(0), gnn.GINConfig(
        n_layers=1, d_feat=4, d_hidden=4, n_classes=2), device="cpu")
    return {"params": model}


def _world_of_two(tmp, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    train.main(["--arch", "din", "--steps", "1", "--device", "cpu",
                "--ckpt-dir", str(tmp)])


SURFACES = [   # (id, call(tmp_path, monkeypatch), error, message)
    # the LM's train step with gradients constrained to a mesh sharding
    ("lm_training", lambda t, m: make_train_step(
        loss_fn, TransformerConfig(), OptimizerConfig(),
        param_axes={"embed": ("vocab", "fsdp")}),
     NotImplementedError, "ROADMAP"),
    # a recsys arch's launch over a torch.distributed world of two
    ("recsys_training", _world_of_two, NotImplementedError, "ROADMAP"),
    # GIN's supervisor restoring onto a mesh sharding
    ("gnn_training", lambda t, m: TrainSupervisor(str(t)).run(
        init_state=_gin_state(), step_fn=lambda s, i: s, n_steps=1,
        state_shardings={}), NotImplementedError, "ROADMAP"),
    ("checkpoint_shardings", lambda t, m: CheckpointManager(str(t)).restore(
        _gin_state(), shardings={}), NotImplementedError, "ROADMAP"),
    ("ragged_bag_gradient", lambda t, m: embedding_bag.embedding_bag_ragged(
        torch.ones(4, 2, requires_grad=True), torch.tensor([0, 3]),
        torch.tensor([0, 2])), RuntimeError, "no gradient"),
    ("candidate_topk_gradient", lambda t, m: candidate_topk.candidate_topk(
        torch.ones(2, requires_grad=True), torch.ones(5, 2), 3),
     RuntimeError, "no gradient"),
]


@pytest.mark.parametrize("name,call,error,match", SURFACES,
                         ids=[s[0] for s in SURFACES])
def test_out_of_slice_surfaces_raise(name, call, error, match, tmp_path,
                                     monkeypatch):
    with pytest.raises(error, match=match):
        call(tmp_path, monkeypatch)


def test_gradient_refusals_only_in_grad_mode():
    """Without grad mode (or on inputs that need no gradient) the two
    kernels without a backward answer as before."""
    t = torch.ones(4, 2, requires_grad=True)
    with torch.no_grad():
        out = embedding_bag.embedding_bag_ragged(t, torch.tensor([0, 3]),
                                                 torch.tensor([0, 2]))
        assert out.tolist() == [[2.0, 2.0]]
        ids = candidate_topk.candidate_topk(
            torch.ones(2, requires_grad=True), torch.ones(5, 2), 3)[1]
        assert ids.tolist() == [0, 1, 2]
    assert candidate_topk.candidate_topk(torch.ones(2), torch.ones(5, 2),
                                         3)[1].tolist() == [0, 1, 2]


def test_no_fallback_between_kernel_and_plain_version():
    """No try/except on the query path: a kernel that cannot run raises."""
    for mod in ("kernels/trie_walk.py", "kernels/locus_dp.py",
                "kernels/beam_topk.py", "kernels/topk_select.py",
                "kernels/locus_merge.py", "kernels/candidate_topk.py",
                "kernels/embedding_bag.py", "kernels/ops.py",
                "kernels/__init__.py", "core/engine/substrate.py",
                "core/engine/__init__.py",
                "core/engine/locus.py", "core/engine/beam.py",
                "core/engine/packed.py", "core/engine/cached.py",
                "core/engine/incremental.py", "core/engine/overlay.py",
                "api/index.py", "api/compile_cache.py", "api/session.py",
                "serving/scheduler.py", "core/distributed.py",
                "core/__init__.py", "core/api.py", "core/oracle.py",
                "launch/serve.py", "models/recsys.py", "models/gnn.py",
                "models/transformer.py", "models/layers.py",
                "optim/optimizers.py", "configs/cells.py",
                "launch/train.py"):
        text = (ROOT / "src" / "repro_torch" / mod).read_text()
        assert "try:" not in text, mod
    for path in EXAMPLES:
        assert "try:" not in (ROOT / path).read_text(), path
