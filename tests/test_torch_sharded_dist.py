"""The sharded index's mesh path on ``torch.distributed``: gloo on the CPU,
one process a rank.

Each rank builds its own shard of the corpus, answers its slice of the
batch, and the all-gathers over the model and data axes give every rank
the global top-k: equal, in scores, strings and order, to the port's
local mode and to ``repro``'s local mode (``repro``'s own mesh path needs
a jax with ``shard_map``).  The ranks also save over the mesh, load the
directory back over the mesh, and refuse a directory of another shard
count with ``repro``'s ``ValueError``.  A case with a small ``max_steps``
(shard answers cut short) holds ``ShardedCompletionIndex.inexact``, summed
over every rank, against the local mode's count after the same queries.
Each test joins its ranks within its own timeout.
"""

import json
import os
import socket
import subprocess
import sys
from functools import lru_cache
from pathlib import Path

import pytest

import repro_torch as rt
from repro.core import distributed as jax_dist
from repro.core import make_rules as jax_rules
from repro_torch.core.trie_build import make_rules
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
JOIN_TIMEOUT_S = 90
STRINGS = ([f"record {i:03d} entry" for i in range(64)]
           + ["andrew pavlo", "william smith", "bill of rights", "andy x"])
SCORES = [(i * 7) % 23 + 1 for i in range(68)]
RULES = [("andy", "andrew"), ("bill", "william"), ("rec", "record")]
QUERIES = ["andy", "bill s", "rec 00", "record 0", "zzz", "entry", "r", "",
           "andy pa", "bill", "w", "a"]
CACHE_K = 4

RANK = """
import json, sys
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
import repro_torch as rt
from repro_torch.core.trie_build import make_rules

a = json.loads(sys.argv[1])
rank = int(sys.argv[2])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{a['port']}",
                        world_size=a["world"], rank=rank)
mesh = init_device_mesh("cpu", tuple(a["shape"]),
                        mesh_dim_names=tuple(a["names"]))
kw = dict(mesh=mesh, data_axes=tuple(a["data_axes"]), device="cpu")
idx = rt.ShardedCompletionIndex(a["strings"], a["scores"],
                                make_rules(a["rules"]), kind="et",
                                cache_k=a["cache_k"],
                                max_steps=a["max_steps"], **kw)
out = {"k_small": idx.complete(a["queries"], k=3),
       "k_big": idx.complete(a["queries"], k=6), "inexact": idx.inexact,
       "stride": idx.stride, "held": [s is not None for s in idx.shards]}
idx.save(a["saved"])
out["loaded"] = rt.ShardedCompletionIndex.load(a["saved"], **kw).complete(
    a["queries"], k=3)
try:
    rt.ShardedCompletionIndex.load(a["other"], **kw)
    out["count_error"] = None
except ValueError as err:
    out["count_error"] = str(err)
with open(f"{a['out']}/rank{rank}.json", "w") as f:
    json.dump(out, f)
dist.barrier()
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_ranks(tmp_path, shape, names, data_axes, max_steps):
    """Start one process a rank, join them all within JOIN_TIMEOUT_S, and
    return each rank's results."""
    other = tmp_path / "other"
    rt.ShardedCompletionIndex(STRINGS, SCORES, make_rules(RULES),
                              n_shards=3, kind="et",
                              device="cpu").save(str(other))
    world = 1
    for n in shape:
        world *= n
    a = dict(port=_free_port(), world=world, shape=shape, names=names,
             data_axes=data_axes, strings=STRINGS, scores=SCORES,
             rules=RULES, queries=QUERIES, cache_k=CACHE_K,
             max_steps=max_steps,
             saved=str(tmp_path / "saved"), other=str(other),
             out=str(tmp_path))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", RANK, json.dumps(a),
                               str(r)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=JOIN_TIMEOUT_S)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"ranks not joined within {JOIN_TIMEOUT_S} s")
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(world)]


@lru_cache(maxsize=None)
def _local(n_shards, max_steps):
    """The port's local mode, its answers at k = 3 and 6 held against
    repro's local mode, and its ``inexact`` count after them."""
    local = rt.ShardedCompletionIndex(STRINGS, SCORES, make_rules(RULES),
                                      n_shards=n_shards, kind="et",
                                      cache_k=CACHE_K, max_steps=max_steps,
                                      device="cpu")
    jx = jax_dist.ShardedCompletionIndex(STRINGS, SCORES, jax_rules(RULES),
                                         n_shards=n_shards, kind="et",
                                         cache_k=CACHE_K,
                                         max_steps=max_steps,
                                         substrate="jnp")
    want_small = local.complete(QUERIES, k=3)
    want_big = local.complete(QUERIES, k=6)
    assert want_small == jx.complete(QUERIES, k=3)
    assert want_big == jx.complete(QUERIES, k=6)
    return local, want_small, want_big, local.inexact


def _as_rows(rows):
    return [[tuple(x) for x in r] for r in rows]


@pytest.mark.parametrize("shape,names,data_axes,max_steps", [
    ((2,), ("model",), (), 512),
    ((2, 2), ("data", "model"), ("data",), 512),
    ((2, 2), ("data", "model"), ("data",), 2),
], ids=["model2", "data2-model2", "data2-model2-inexact"])
def test_mesh_path_equals_local_modes(tmp_path, shape, names, data_axes,
                                      max_steps):
    n_shards = shape[-1]
    results = _run_ranks(tmp_path, shape, names, data_axes, max_steps)
    local, want_small, want_big, inexact = _local(n_shards, max_steps)
    # the beam's answers at k = 6 > cache_k are cut short at max_steps=2
    assert (inexact > 0) == (max_steps == 2)
    for rank, res in enumerate(results):
        assert _as_rows(res["k_small"]) == want_small, rank
        assert _as_rows(res["k_big"]) == want_big, rank
        assert res["inexact"] == inexact, rank
        assert _as_rows(res["loaded"]) == want_small, rank
        assert res["stride"] == local.stride
        assert sum(res["held"]) == 1   # each rank holds its own shard only
        assert res["count_error"] is not None
        assert "saved index has 3 shards but mesh axis 'model' has " \
               f"{n_shards} devices" in res["count_error"]
    # the directory saved over the mesh loads in one process, both packages
    saved = str(tmp_path / "saved")
    assert rt.ShardedCompletionIndex.load(saved, device="cpu").complete(
        QUERIES, k=3) == want_small
    assert jax_dist.ShardedCompletionIndex.load(saved).complete(
        QUERIES, k=3) == want_small
