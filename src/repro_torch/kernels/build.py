"""Build the CUDA sources in ``csrc/`` and load them with ``ctypes``.

Each source has a plain C interface and is compiled by ``nvcc`` into its
own shared library at first use, under ``$REPRO_TORCH_BUILD/repro_torch``
(``build/repro_torch`` of the working directory when the variable is
unset), keyed by a hash of the source and the flags; a later call with the
same source loads the library already built.  Nothing here runs at import
time.

Flags: ``sm_90a`` (Hopper), ``--fmad=false`` so no ``a*b+c`` is contracted
into an FMA, and no ``--use_fast_math``, so division and square root stay
IEEE: with them a kernel that repeats the plain version's operation order
agrees with it bit for bit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).with_name("csrc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (set CUDA_HOME)")


def build_dir() -> Path:
    return Path(os.environ.get("REPRO_TORCH_BUILD", "build")) / "repro_torch"


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, for its current source."""
    src = CSRC / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir().resolve() / f"lib{name}_{key}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless this source is already built.

    ``nvcc``'s report (registers, shared memory, spills per kernel, from
    ``-Xptxas -v``) is kept beside the library as ``<library>.log``.
    """
    out = library_path(name)
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        capture_output=True, text=True, check=False)
    out.with_name(out.name + ".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{proc.stderr}")
    os.replace(tmp, out)          # atomic: a reader never sees half a file
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if need be."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(build(name)))
    return _LOADED[name]
