"""Count the SASS instructions of each kernel in built kernel libraries, to
hold a kernel's machine code against another tree's.

    python3 -m rayaccel_tpu_torch.tools.sass_counts [LIB.so ...]

With no argument it reads this tree's library (``ops/_kernels.py`` builds
it on first use, on a machine with nvcc). Prints one JSON line a kernel:
its mangled name with the anonymous namespace's hash taken out (the hash
differs between builds of two trees) and its instruction count in each
library given, in order (null where a library lacks it). Needs the CUDA
toolkit's ``cuobjdump``.
"""

import json
import os
import re
import shutil
import subprocess
import sys

_FUNCTION = re.compile(r"\s*Function : (\S+)")
_INSTRUCTION = re.compile(r"/\*[0-9a-f]{4}\*/")
_NAMESPACE = re.compile(r"_GLOBAL__N__[0-9a-f]+_")


def counts(so: str) -> dict:
    """{kernel: SASS instructions} of one shared library."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", so], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    out, name = {}, None
    for line in sass.splitlines():
        m = _FUNCTION.match(line)
        if m:
            name = _NAMESPACE.sub("", m.group(1))
            out[name] = 0
        elif name is not None and _INSTRUCTION.search(line):
            out[name] += 1
    return out


def main(argv) -> int:
    if not argv:
        from rayaccel_tpu_torch.ops import _kernels
        argv = [_kernels.library()._name]
    libs = [counts(os.path.abspath(so)) for so in argv]
    for name in sorted(set().union(*libs)):
        print(json.dumps({"kernel": name,
                          "instructions": [c.get(name) for c in libs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
