"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled for
Hopper (``sm_90a``) into ``build/kernels/<name>-<hash>.so`` at the repo root,
keyed on a hash of the source, the ``csrc/`` headers it includes and the
flags, so the first call builds it and later calls load the cached library.
No PyTorch headers are included, which keeps a build to seconds.
``--use_fast_math`` is deliberately absent: it swaps sinf/cosf/atanf for
approximations.  ``-fmad=false`` keeps every multiply and add separately
rounded, as the op-by-op torch versions the kernels are held against round
them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent.parent
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "--ptxas-options=-v",
)


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda``, PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build on a CUDA machine")
    return found


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(path: pathlib.Path, seen: set) -> list[bytes]:
    """The bytes of ``path`` and of every header in its directory that it
    includes with quotes, recursively, each once."""
    seen.add(path)
    text = path.read_bytes()
    out = [text]
    for name in _LOCAL_INCLUDE.findall(text):
        header = path.parent / name.decode()
        if header not in seen and header.is_file():
            out += _sources(header, seen)
    return out


def library_path(name: str, source_dir=None, build_dir=None) -> pathlib.Path:
    """``build/kernels/<name>-<hash>.so``: the hash covers the source, the
    headers of ``csrc/`` it includes, and the flags.  ``source_dir`` and
    ``build_dir`` default to ``csrc/`` and ``build/kernels/``."""
    parts = _sources(pathlib.Path(source_dir or SOURCE_DIR) / f"{name}.cu", set())
    key = hashlib.sha256(b"\0".join(parts) + " ".join(NVCC_FLAGS).encode())
    return pathlib.Path(build_dir or BUILD_DIR) / f"{name}-{key.hexdigest()[:16]}.so"


def build(names, source_dir=None, build_dir=None) -> dict[str, pathlib.Path]:
    """Compile every named source of ``source_dir`` (default ``csrc/``)
    whose library is missing from ``build_dir`` (default ``build/kernels/``),
    all nvcc processes started together.  The compiler's output (ptxas
    register and spill report) is kept beside each library as ``.log``."""
    source_dir = pathlib.Path(source_dir or SOURCE_DIR)
    build_dir = pathlib.Path(build_dir or BUILD_DIR)
    build_dir.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name, source_dir, build_dir) for name in names}
    procs = {}
    for name, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs[name] = (
            subprocess.Popen(
                [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                 str(source_dir / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ),
            tmp,
        )
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        out = paths[name]
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{log}")
        os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
    return paths


def load_kernel_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it."""
    return ctypes.CDLL(str(build([name])[name]))
