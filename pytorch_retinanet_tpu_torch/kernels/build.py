"""Build the CUDA sources under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc`` for
``sm_90a`` into ``build/lib<name>-<hash>.so`` at the root of the checkout. The
hash covers the sources and the flags, so an edited source builds anew. One
``nvcc`` process runs per source, and :func:`build` starts them all together.
Nothing here runs at import time: the CPU tests import this module on machines
that have no ``nvcc``.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"

_COMMON_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# The NMS and match IoUs (and the match encode) must round exactly like the
# reference, and the focal loss like its plain version: no contraction into
# FMA and IEEE division.
_EXACT = ["-fmad=false", "-prec-div=true"]
_EXTRA_FLAGS: Dict[str, List[str]] = {"nms": _EXACT, "match": _EXACT, "focal": _EXACT}

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return path


def _flags(name: str) -> List[str]:
    return _COMMON_FLAGS + _EXTRA_FLAGS.get(name, [])


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lands for the current sources."""
    digest = hashlib.sha256()
    for src in sorted(CSRC_DIR.glob("*.cuh")) + [CSRC_DIR / f"{name}.cu"]:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile the named sources that are not built yet, all in parallel.

    Returns the library path of every name. The compiler's output (register
    and shared-memory use from ``-Xptxas -v``) is kept beside each library as
    ``.log``. Raises with the compiler's messages if any build fails.
    """
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *_flags(name), "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, proc, tmp, out))
    failures = []
    for name, proc, tmp, out in running:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return {name: library_path(name) for name in names}


def bind(name: str, symbol: str, argtypes: List, restype=ctypes.c_int):
    """The C function ``symbol`` of ``csrc/<name>.cu``, its argument types
    set once (a ctypes function keeps them between calls)."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = argtypes, restype
    return fn


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _loaded[name] = lib
    return lib


def on_device(dev: torch.device):
    """`dev` as the current CUDA device for a launch (a no-op where it is
    already: the wrappers sit on the step's host path)."""
    if torch.cuda.current_device() == dev.index:
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def stream_handle(dev: torch.device) -> int:
    """The raw handle of `dev`'s current stream, for a launch."""
    return torch.cuda.current_stream(dev).cuda_stream
