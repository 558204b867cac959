#!/usr/bin/env python3
"""Compares the device code of two checkouts' CUDA sources, kernel by
kernel: whether a change left a kernel's machine code (SASS) as it was.

    python3 gpu_ecs_madrona_tpu_torch/tools/sass_diff.py PARENT CHANGE [SOURCE ...]

PARENT and CHANGE are roots of checkouts of this repository; SOURCE names
a ``csrc/<SOURCE>.cu`` (default: substep_kernels and simple_jobs_kernels).
Each source of each checkout is compiled to a cubin with this checkout's
``ops/_build.py`` flags for device code (all at once), disassembled with
``cuobjdump -sass``, and split by kernel; the anonymous namespace's name,
which hashes the file, is normalised.  Prints one JSON line a source: the
kernels of each side, how many are identical, and the names of those
that differ or are on one side only; a kernel on one side only whose SASS
is that of a kernel on the other side only (a kernel renamed, say by a
template argument taken out) is listed under "renamed" instead.  A kernel whose SASS is identical
runs the same instructions: its time can differ from the parent's only by
the card's noise.  Needs the CUDA toolkit (nvcc, cuobjdump), not a card.
"""

import json
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from gpu_ecs_madrona_tpu_torch.ops import _build  # noqa: E402

# the build's flags that shape device code (not the shared library's)
DEVICE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false")
ANON = re.compile(r"\d*_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}")


def kernels_sass(cubin: str, objdump: str) -> dict:
    """{kernel's mangled name: its SASS} of a cubin, each run of blanks made
    one space (cuobjdump pads every line of a file to the widest
    instruction in it, so a kernel added beside another moves the other's
    columns)."""
    sass = subprocess.run([objdump, "-sass", cubin], capture_output=True, text=True,
                          check=True).stdout
    sass = re.sub(r"[ \t]+", " ", ANON.sub("ANON", sass))
    parts = re.split(r"\n\s*Function : (\S+)\n", sass)
    return {parts[i]: parts[i + 1] for i in range(1, len(parts) - 1, 2)}


def main(argv):
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    parent, change, sources = argv[0], argv[1], argv[2:] or ["substep_kernels",
                                                             "simple_jobs_kernels"]
    nvcc = _build.nvcc()
    objdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    with tempfile.TemporaryDirectory() as out:
        procs = {}
        for side, root in (("parent", parent), ("change", change)):
            for src in sources:
                path = os.path.join(root, "gpu_ecs_madrona_tpu_torch", "csrc", src + ".cu")
                cubin = os.path.join(out, f"{side}_{src}.cubin")
                procs[(side, src)] = (
                    subprocess.Popen([nvcc, *DEVICE_FLAGS, "-cubin", "-o", cubin, path]), cubin)
        funcs = {}
        for key, (proc, cubin) in procs.items():
            if proc.wait() != 0:
                raise RuntimeError(f"nvcc failed for {key}")
            funcs[key] = kernels_sass(cubin, objdump)
    for src in sources:
        a, b = funcs[("parent", src)], funcs[("change", src)]
        both = sorted(set(a) & set(b))
        only_a, only_b = sorted(set(a) - set(b)), sorted(set(b) - set(a))
        renamed = {}
        for k in only_a:
            same = [n for n in only_b if b[n] == a[k] and n not in renamed.values()]
            if same:
                renamed[k] = same[0]
        print(json.dumps({"source": src, "kernels_parent": len(a), "kernels_change": len(b),
                          "identical": sum(a[k] == b[k] for k in both),
                          "differ": [k for k in both if a[k] != b[k]],
                          "renamed": renamed,
                          "only_change": [k for k in only_b if k not in renamed.values()],
                          "only_parent": [k for k in only_a if k not in renamed]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
