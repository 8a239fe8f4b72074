"""Build the package's CUDA sources into one shared library and load it.

The sources in ``nerf_tpu_torch/csrc/`` are compiled with ``nvcc`` for
Hopper (``sm_90a``) into ``build/nerf_tpu_torch/`` at the root of the
checkout, at first use, under a name keyed by a hash of the sources and the
flags: one ``nvcc -c`` per ``.cu`` file, all started together, then one
link. The library has a plain C interface and is loaded with ``ctypes``;
nothing here includes PyTorch's headers, so a build takes seconds.

Fast math is never on: the encoding's sinusoids take arguments up to
|x| * 2^9 and must be the accurate ``sincosf``.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nerf_tpu_torch"
NVCC_FALLBACK = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """``nvcc`` on PATH, else the CUDA toolkit's default location."""
    found = shutil.which("nvcc")
    if found:
        return found
    if os.access(NVCC_FALLBACK, os.X_OK):
        return NVCC_FALLBACK
    raise RuntimeError(
        f"nvcc not found: looked for 'nvcc' on PATH and at {NVCC_FALLBACK}"
    )


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"libnerf_tpu_torch_{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile the sources unless a library for them exists; return its path.

    The compiler's output (``-Xptxas -v``: registers, shared memory and
    spills of each kernel) is kept beside the library as ``<name>.log``.
    Processes that start cold at once (the ranks of a process group) take a
    file lock beside the library in turn, and each looks for the library
    again once it holds the lock, so one of them runs ``nvcc``.
    """
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            _compile(out)
    return out


def _compile(out: Path) -> None:
    """One ``nvcc -c`` per source, all started together, then the link."""
    nvcc = find_nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(_sources(), objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs = [proc.communicate()[0] for proc in procs]
    tmp = out.with_name(f"{tag}.tmp")
    link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)]
    failed = [(cmd, log) for cmd, log, proc in zip(cmds, logs, procs) if proc.returncode != 0]
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed = [(link, proc.stderr)]
    out.with_suffix(".log").write_text("".join(logs))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        cmd, log = failed[0]
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{log}")
    os.replace(tmp, out)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    return ctypes.CDLL(str(build_library()))
