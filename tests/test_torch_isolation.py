"""The port stands alone: it imports neither JAX nor the JAX package (nor
do ``chip_smoke.py`` and the port's examples), runs on the CUDA device
unless told otherwise, and raises on every option outside the ported
slices (training: the LM's, recsys and GNN losses)."""

import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch as rt
from repro_torch.core.engine.substrate import resolve_substrate
from repro_torch.core.trie_build import make_rules
from repro_torch.models import gnn, recsys
from repro_torch.models.transformer import TransformerConfig, loss_fn
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PAPER = (["andrew pavlo", "andrew parker", "william smith"], [50, 40, 20],
         [("andy", "andrew"), ("bill", "william")])
FORBIDDEN = ("jax", "jaxlib", "repro")
EXAMPLES = ("examples/torch_quickstart.py",
            "examples/torch_serve_autocomplete.py",
            "examples/torch_autocomplete_rerank.py")


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


SURFACES = [
    ("lm_training", lambda i: loss_fn(None, {}, TransformerConfig())),
    ("recsys_training",
     lambda i: recsys.sasrec_loss(None, {}, recsys.SASRecConfig())),
    ("gnn_training",
     lambda i: gnn.loss_batched_graphs(None, {}, gnn.GINConfig())),
]


@pytest.mark.parametrize("name,call", SURFACES, ids=[s[0] for s in SURFACES])
def test_out_of_slice_surfaces_raise(name, call):
    idx = rt.build_index(PAPER[0], PAPER[1], make_rules(PAPER[2]),
                         kind="tt", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        call(idx)


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
                "launch/serve.py", "models/recsys.py", "models/gnn.py"):
        text = (ROOT / "src" / "repro_torch" / mod).read_text()
        assert "try:" not in text, mod
    for path in EXAMPLES:
        assert "try:" not in (ROOT / path).read_text(), path
