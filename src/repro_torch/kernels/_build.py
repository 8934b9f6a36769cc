"""Build and bind the port's hand-written CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``: tensor
pointers and the CUDA stream go in as ``c_void_p``, every launch function
returns ``cudaGetLastError()``, and :func:`check_launch` raises when that
is not 0.  Builds happen at first use, from the sources in this checkout
only, into ``build/repro_torch_kernels/`` at the repository root (one
``nvcc`` per source, all started together).  A library is named by a hash
of its source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source is rebuilt and a built one is reused.  There is no fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("trie_walk", "locus_dp", "beam_topk", "topk_select",
           "locus_merge", "candidate_topk", "embedding_bag")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: per source, what ``nvcc -Xptxas -v`` reported (registers, shared memory,
#: spills) when this process built it
ptxas_log: dict[str, str] = {}
#: wall seconds of the last :func:`build_all` that compiled anything
build_seconds: float | None = None

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are compiled from "
        "src/repro_torch/kernels/csrc at first use (set NVCC or put the "
        "CUDA toolkit's bin/ on PATH)")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all() -> None:
    """Compile every kernel source that has no library yet, one ``nvcc``
    process per source, all running at once; raise if any fails."""
    global build_seconds
    todo = [n for n in SOURCES if not _target(n).exists()]
    if not todo:
        return
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = []
    for name in todo:
        out = _target(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        ptxas_log[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError("\n".join(failed))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name`` (built if needed)."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(_target(name)))
        getattr(lib, f"{name}_error_string").restype = ctypes.c_char_p
        getattr(lib, f"{name}_error_string").argtypes = [ctypes.c_int]
        _libs[name] = lib
    return lib


def check_launch(name: str, err: int) -> None:
    if err != 0:
        msg = getattr(library(name), f"{name}_error_string")(err)
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({msg.decode()})")


#: the element types a kernel reads: int32 tables and bool flags, and in
#: the packed layout u8 planes and u16 tiers
DENSE_DTYPES = (torch.int32, torch.bool)
PACKED_DTYPES = DENSE_DTYPES + (torch.uint8, torch.uint16)


def check_tensors(name: str, device: torch.device, dtypes=DENSE_DTYPES,
                  **tensors) -> None:
    """Every tensor on ``device`` (a CUDA device), contiguous, and of one
    of ``dtypes`` (int32 or bool unless the wrapper reads narrow tiers,
    whose per-table types it checks itself)."""
    if device.type != "cuda":
        raise ValueError(f"{name}: tensors on {device} have no kernel")
    for arg, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected "
                             f"{device}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype}, expected "
                            f"one of {dtypes}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")


def wants_grad(*tensors) -> bool:
    """Grad mode is on and one of ``tensors`` requires a gradient."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def refuse_grad(name: str, hint: str, **tensors) -> None:
    """Raise when grad mode is on and one of ``tensors`` requires a
    gradient: ``name``'s kernel has no backward, and an output without
    one would leave its inputs' gradients silently missing."""
    needs = [arg for arg, t in tensors.items() if wants_grad(t)]
    if needs:
        raise RuntimeError(
            f"{name} has no gradient, but {', '.join(needs)} require"
            f"{'s' if len(needs) == 1 else ''} one: call it under "
            f"torch.no_grad() or on detached tensors; {hint}")


def check_dtype(name: str, arg: str, t: torch.Tensor, *dtypes) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: {arg} has dtype {t.dtype}, expected one "
                        f"of {dtypes}")


def is_u16(name: str, arg: str, t: torch.Tensor) -> int:
    """The dtype tier of a tier-variable packed table as the kernels take
    it: 1 for u16, 0 for int32; any other type raises."""
    check_dtype(name, arg, t, torch.uint16, torch.int32)
    return int(t.dtype == torch.uint16)


@functools.lru_cache(maxsize=None)
def lanes_per_row(dim: int, elem_bytes: int, vec: bool) -> int:
    """Lanes of a warp that read one row of ``dim`` values of
    ``elem_bytes`` each: its 16-byte vectors when ``vec`` (else its
    values), rounded down to a power of two, at most 32."""
    per_row = dim * elem_bytes // 16 if vec else dim
    lanes = 1
    while lanes * 2 <= min(per_row, 32):
        lanes *= 2
    return lanes


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> int:
    """The raw handle of ``device``'s current CUDA stream (the capturing
    stream inside ``torch.cuda.graph``).  ``torch.cuda.current_stream``
    builds a Stream object per call, several microseconds of host time on
    every launch; this accessor, the one PyTorch's generated code calls,
    does not."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    return raw_stream(index)


def raw_stream(index: int) -> int:
    """:func:`stream` of the CUDA device with this index."""
    return torch._C._cuda_getCurrentRawStream(index)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of the CUDA device with this index."""
    return torch.cuda.get_device_properties(index).multi_processor_count


#: the per-block dynamic shared memory a kernel may ask for on Hopper
MAX_SHARED_BYTES = 232_448
