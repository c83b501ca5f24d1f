"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled with ``nvcc`` for ``sm_90a`` (all compilers started
together), the objects are linked into one shared library with a plain C
interface, and the library is loaded with ``ctypes``. Pointers and the CUDA
stream cross as ``c_void_p``; every C entry returns ``cudaGetLastError()``
and :func:`check` raises when it is not 0, so a refused launch never passes
unseen.

The library lands in ``kernels/_build/`` inside the checkout, named by a
hash of the sources and flags, so a changed source is rebuilt and an
unchanged one is built once per checkout. Nothing is built or loaded at
import time: the first kernel launch (or an explicit :func:`load`) does it.

The module also holds the launch counts: each wrapper adds one to its
kernel's entry where it launches it, and nowhere else.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("ell_gather.cu", "cheb_dia.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Launches per kernel since the last :func:`reset_launches`.
launches: dict[str, int] = {"ell_gather": 0, "ell_gather_cheb": 0,
                            "cheb_dia": 0}

_VP = ctypes.c_void_p
_I64 = ctypes.c_longlong
_F64 = ctypes.c_double
_INT = ctypes.c_int
_ELL_ARGS = [_VP, _VP, _VP, _I64, _I64, _I64, _VP, _VP, _VP, _I64, _I64, _I64,
             _I64, _I64, _I64, _I64, _VP]
_ELL_CHEB_ARGS = [_VP, _VP, _VP, _I64, _I64, _I64, _VP, _VP, _VP, _VP, _VP,
                  _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _F64,
                  _F64, _VP]
_DIA_ARGS = [_VP, _INT, _VP, _VP, _VP, _VP, _VP, _INT, _VP, _INT, _I64, _I64,
             _I64, _VP, _VP, _VP, _VP, _I64, _I64, _I64, _I64, _F64, _F64, _VP]
_SIGNATURES = {
    # rowptr, cols, vals, tile_rows, tile_max, max_row, x, y0, y, P, R, nb,
    # c, the shard strides sx, sy0, sy, stream
    **{f"ell_gather_{t}": _ELL_ARGS for t in ("f64", "f32", "c128", "c64")},
    # the same, then x, y0, w1, w2, y, P, R, nb, c, sx, sy0, sw1, sw2, sy,
    # alpha, beta, stream
    **{f"ell_gather_cheb_{t}": _ELL_CHEB_ARGS
       for t in ("f64", "f32", "c128", "c64")},
    # offsets, n_diag, rowptr, ids, vals, vidx, table, n_table, diag,
    # diag_id, tile_rows, tile_max, max_row, x, w1, w2, y, R, Rx, nb, c,
    # alpha, beta, stream
    **{f"cheb_dia_{t}": _DIA_ARGS for t in ("f64", "f32", "c128", "c64")},
}

#: The suffix of each dtype's C entry (``ell_gather_f64``, ``cheb_dia_c128``...).
ENTRY_SUFFIX = {torch.float64: "f64", torch.float32: "f32",
                torch.complex128: "c128", torch.complex64: "c64"}

_lib: ctypes.CDLL | None = None
#: What the last build printed (ptxas registers/spills per kernel), and
#: how long it took; empty when the library was already built.
build_log = ""
build_seconds = 0.0


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _build(target: Path) -> str:
    nvcc = _nvcc()
    objs, procs = [], []
    for src in SOURCES:
        obj = target.with_name(f"{target.stem}.{src}.o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    for src, p in zip(SOURCES, procs):
        out, _ = p.communicate()
        logs.append(f"[{src}]\n{out}")
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{out}")
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, "-shared", *map(str, objs), "-o", str(tmp)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, target)
    for obj in objs:
        obj.unlink(missing_ok=True)
    return "\n".join(logs)


def load() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib, build_log, build_seconds
    if _lib is not None:
        return _lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = BUILD_DIR / f"librepro_torch_kernels-{_digest()}.so"
    t0 = time.perf_counter()
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # one builder per checkout
        if not target.exists():
            build_log = _build(target)
    build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(target))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
