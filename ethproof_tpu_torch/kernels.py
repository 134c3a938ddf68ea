"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` compiles with `nvcc` for `sm_90a` into a shared
library with a plain C interface, loaded with `ctypes`. The library goes
into `ethproof_tpu_torch/build/` (listed in .gitignore) under a name keyed
by the content hash of the source and of every local header it includes
(`csrc/goldilocks.cuh`), so an edited source or header rebuilds and an
unchanged one loads at once. Nothing builds at import time: a kernel builds on its
first launch, or all at once through `build_all` (one `nvcc` per source,
started together).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Tuple

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = ("base_dft", "base_dft_bf16", "poseidon")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(path: Path, seen: List[Path]) -> List[Path]:
    """`path` and every local header it includes, transitively, in order."""
    if path in seen:
        return seen
    seen.append(path)
    for inc in _LOCAL_INCLUDE.findall(path.read_bytes()):
        _sources(path.parent / inc.decode(), seen)
    return seen


def library_path(name: str) -> Path:
    """The library's path, keyed by the source and the headers it includes."""
    digest = hashlib.sha256()
    for src in _sources(CSRC / f"{name}.cu", []):
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def _start(name: str) -> Tuple[subprocess.Popen, Path, Path]:
    so = library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, so


def build_all(names=SOURCES) -> List[Tuple[str, float, str]]:
    """Build every named source not yet built, one nvcc each, in parallel.

    -> [(name, seconds, compiler log)]; raises if any build fails."""
    t0 = time.perf_counter()
    started = []
    for name in names:
        if not library_path(name).exists():
            started.append((name, *_start(name)))
    out, failed = [], []
    for name, proc, tmp, so in started:
        log, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, so)
        out.append((name, time.perf_counter() - t0, log))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library for `name` (building it first if needed)."""
    lib = _loaded.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
