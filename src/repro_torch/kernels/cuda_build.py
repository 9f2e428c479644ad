"""Build and load the hand-written CUDA kernels (``nvcc`` + ``ctypes``).

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its
own into ``build/repro_torch/lib<name>.so`` at the repository root
(``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared``); a variant
(:data:`VARIANTS`) is the same source built again with a compile-time
switch into a library of its own name.  The build
happens at first use and again whenever a source, or a ``csrc/*.cuh``
header it includes, is newer than its library; :func:`build` compiles every stale source with one ``nvcc``
process per source, all started together.  Nothing here runs at import
time: the CPU tests import every module of the port on a machine
without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import os
import pathlib
import re
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch"
SOURCES = ("block_matmul", "flash_attention", "flash_attention_paged",
           "ssd_scan")
# name -> (source, extra nvcc flags): the SSD scan with per-phase clock
# stamps (``ssd_scan.phase_clocks``), never on the serving path
VARIANTS = {"ssd_scan_phases": ("ssd_scan", ("-DSSD_PHASE_CLOCKS",))}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / \
        "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA "
                           "kernels of repro_torch build at first use")
    return found


def lib_path(name: str) -> pathlib.Path:
    return BUILD_DIR / f"lib{name}.so"


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _source(name: str) -> tuple[str, tuple[str, ...]]:
    return VARIANTS.get(name, (name, ()))


def sources_of(name: str) -> list[pathlib.Path]:
    """The source of ``name`` and every header it includes by a quoted
    ``#include`` from beside it, transitively."""
    deps = [CSRC / f"{_source(name)[0]}.cu"]
    for path in deps:                       # grows while it is walked
        for inc in _INCLUDE.findall(path.read_text()):
            dep = path.parent / inc
            if dep.exists() and dep not in deps:
                deps.append(dep)
    return deps


def _stale(name: str) -> bool:
    lib = lib_path(name)
    if not lib.exists():
        return True
    built = lib.stat().st_mtime
    return any(built < dep.stat().st_mtime for dep in sources_of(name))


def build(names: tuple[str, ...] = SOURCES + tuple(VARIANTS)
          ) -> dict[str, str]:
    """Compile every stale library in ``names`` in parallel.  Returns
    name -> compiler output (``-Xptxas -v``: registers, shared memory
    and spills per kernel) for the sources it compiled; raises
    ``RuntimeError`` with the output of every source that failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs: dict[str, tuple[pathlib.Path, subprocess.Popen]] = {}
    for name in names:
        if not _stale(name):
            continue
        nvcc = nvcc or nvcc_path()
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        src, flags = _source(name)
        cmd = [nvcc, *NVCC_FLAGS, *flags, "-o", str(tmp),
               str(CSRC / f"{src}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs: dict[str, str] = {}
    failed: list[str] = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name} (exit {proc.returncode})\n"
                          f"{out}")
        else:
            os.replace(tmp, lib_path(name))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if stale."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(lib_path(name)))
            lib.cuda_error_name.argtypes = [ctypes.c_int]
            lib.cuda_error_name.restype = ctypes.c_char_p
            _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a C entry point returned a non-zero ``cudaError_t``
    (a launch the card refused never runs, and a later synchronize does
    not report it)."""
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({lib.cuda_error_name(err).decode()})")
