"""Build and load the CUDA kernels at first use.

``nvcc`` compiles every source of ``csrc/`` for ``sm_90a`` — one
process per source, all started together — and links the objects into
one shared library with a plain C interface, which ``ctypes`` loads.
The library lands in ``build/repro_torch_kernels/`` at the root of the
checkout, named by a hash of the sources, their headers and the flags,
so an edited source is rebuilt and a stale library is never loaded; nvcc's
report (ptxas's registers and spills of every kernel) is kept beside it.
Nothing is built when the module is imported: the CPU tests import it on
machines without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (_CSRC / "hamming.cu", _CSRC / "arena.cu", _CSRC / "rerank.cu",
           _CSRC / "flash_attn.cu", _CSRC / "flash_attn_bwd.cu")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIB = None
BUILD_INFO: dict = {}   # seconds, library path and nvcc's report of the last load

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "hamming_distances_batched_launch": [_P, _P, _P, _LL, _I, _I, _I, _I,
                                         _LL, _LL, _LL, _I, _I, _P],
    "sparse_verify_batch_batched_launch": [_P, _P, _P, _P, _P, _LL, _I, _I,
                                           _I, _I, _I, _LL, _LL, _LL, _LL,
                                           _I, _I, _P],
    "hamming_distances_gather_launch": [_P, _P, _P, _P, _P, _LL, _I, _I, _I,
                                        _I, _LL, _P],
    "sparse_verify_arena_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _LL, _I,
                                   _LL, _I, _I, _I, _I, _P],
    "sparse_verify_arena_packed_launch": [_P, _P, _P, _P, _P, _P, _P, _P,
                                          _LL, _I, _LL, _I, _I, _I, _I, _P],
    "exact_rerank_launch": [_P, _P, _P, _P, _LL, _I, _I, _I, _P],
    "flash_attention_fwd_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   *[_LL] * 12, _I, _I, _F, _F, _I, _P, _I,
                                   _I, _P],
    "flash_attention_bwd_launch": [*[_P] * 10, _I, _I, _I, _I, _I,
                                   *[_LL] * 24, _I, _I, _F, _F, _I, _I, _I,
                                   _I, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _run(procs) -> str:
    """Wait for every nvcc process; raise with the first failure's report."""
    outs = [(p, *p.communicate()) for p in procs]
    for p, out, err in outs:
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{err}")
    return "".join(out + err for _, out, err in outs)


def _compile(out: Path) -> str:
    """One nvcc per source, all at once, then one link into ``out``."""
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [out.parent / f"{tag}.{src.stem}.o" for src in SOURCES]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        report = _run([subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for src, obj in zip(SOURCES, objs)])
        report += _run([subprocess.Popen(
            [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)])
        os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    return report


def load_library() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in (*SOURCES, *sorted(_CSRC.glob("*.cuh"))):
            digest.update(src.read_bytes())
        path = BUILD_DIR / f"libkernels_{digest.hexdigest()[:16]}.so"
        t0 = time.perf_counter()
        notes = path.with_suffix(".ptxas.txt")   # nvcc's report, kept beside
        if path.exists():
            report = notes.read_text() if notes.exists() else ""
        else:
            report = _compile(path)
            notes.write_text(report)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.hamming_error_string.argtypes = [ctypes.c_int]
        lib.hamming_error_string.restype = ctypes.c_char_p
        BUILD_INFO.update(seconds=time.perf_counter() - t0, path=str(path),
                          report=report)
        _LIB = lib
        return lib


def check(lib: ctypes.CDLL, code: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        msg = lib.hamming_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({code}: {msg})")


def ptxas_kernels(report: str) -> dict:
    """Each kernel's (registers, spill store bytes, spill load bytes) from
    nvcc's ``-Xptxas -v`` report, by mangled name."""
    out, name, spills = {}, None, (0, 0)
    for line in report.splitlines():
        if "Function properties for " in line:
            name = line.split("Function properties for ", 1)[1].strip()
            spills = (0, 0)
        elif name and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            spills = (nums[1], nums[2])
        elif name and "Used " in line and " registers" in line:
            regs = int(line.split("Used ", 1)[1].split()[0])
            out[name] = (regs, *spills)
            name = None
    return out
