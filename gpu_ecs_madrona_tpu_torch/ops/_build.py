"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with
a plain C interface, ``build/torch_kernels/<name>-<hash>.so`` at the root
of the checkout, where the hash covers the source, the sources of csrc/
it includes, and the flags: a changed
source builds anew, an unchanged one loads what is there.  ``build`` starts
one ``nvcc`` per source, all at once, and waits for them.  Nothing is
compiled or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"

# -fmad=false: products and sums rounded separately, in the plain versions'
# order (see the source notes).  -Xptxas -v: registers, shared memory and
# spills per kernel, kept in the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Builds of a source with extra flags, by name: (the source, its flags).
# Not among sources(): built only where named (chip_smoke.py and
# tools/substep_ab.py --phases build the substep kernels with their phase
# markers, csrc/substep_kernels.cu's SUBSTEP_PHASES).
VARIANTS = {"substep_phases": ("substep_kernels", ("-DSUBSTEP_PHASES",))}

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else the
    toolkit's default install location."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def sources() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _source_bytes(name: str) -> bytes:
    """``csrc/<name>.cu`` with the sources of csrc/ that it includes."""
    src = (CSRC / f"{name}.cu").read_bytes()
    for inc in re.findall(rb'^#include "([^"]+)"', src, re.M):
        src += (CSRC / inc.decode()).read_bytes()
    return src


def _source_flags(name: str):
    """(the source a build of ``name`` compiles, its nvcc flags)."""
    src, extra = VARIANTS.get(name, (name, ()))
    return src, NVCC_FLAGS + tuple(extra)


def library_path(name: str) -> Path:
    src, flags = _source_flags(name)
    digest = hashlib.sha256(_source_bytes(src) + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str] = None) -> Dict[str, str]:
    """Compile the named sources (default: all; a name of VARIANTS builds
    its source with its flags) that are not built yet, in
    parallel.  Returns {name: the nvcc log of its build} (the saved log
    when it was built before).  Raises if any build fails."""
    names = list(sources() if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        src, flags = _source_flags(name)
        cmd = [nvcc(), *flags, "-o", str(tmp), str(CSRC / f"{src}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: library_path(name).with_suffix(".log").read_text()
            for name in names}


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
