"""Build the port's CUDA sources and load them with ``ctypes``.

Each source in ``src/repro_torch/csrc/`` exposes a plain C interface and is
compiled with ``nvcc`` for ``sm_90a`` at first use into ``build/repro_torch/``
(the file name carries a hash of the source, the shared headers
``csrc/*.cuh`` and the flags, so an edit to any of them rebuilds).
Nothing here runs when a module is imported: the CPU tests import every
module on a host without ``nvcc``.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# --fmad=false: round every multiply and add on its own, as the plain versions'
# separate torch ops do (FMA contraction would differ from them in the last
# bit, which FedAdam's division by sqrt(v) can amplify where v is small). A
# kernel that wants fused multiply-adds writes fmaf() itself.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def sources() -> Tuple[Path, ...]:
    """Every CUDA source of the port."""
    return tuple(sorted(CSRC.glob("*.cu")))


def headers() -> Tuple[Path, ...]:
    """The headers the CUDA sources share (part of every build's tag)."""
    return tuple(sorted(CSRC.glob("*.cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the port's kernels")


def tag(source: Path) -> str:
    """What a build's file name carries: a hash of the source, every shared
    header and the flags (a header is hashed into every source's tag, since
    nothing here reads which source includes it)."""
    src = source.read_bytes() + b"".join(h.read_bytes() for h in headers())
    return hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]


def build(source: Path) -> Tuple[Path, str]:
    """Compile one kernel library if this source/flags pair has not been built.
    Returns ``(path, compiler_log)``; the log is empty when it was cached."""
    out = BUILD_DIR / f"lib{source.stem}-{tag(source)}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    return out, proc.stderr


def build_all() -> Dict[str, Tuple[Path, str]]:
    """Build every kernel source at once, one ``nvcc`` each, in parallel."""
    srcs = sources()
    with ThreadPoolExecutor(len(srcs)) as pool:
        return dict(zip((s.name for s in srcs), pool.map(build, srcs)))
