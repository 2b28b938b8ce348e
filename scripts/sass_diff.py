#!/usr/bin/env python3
"""Compare the machine code (SASS) of the kernels in two builds of a library.

  python3 scripts/sass_diff.py LIB_A.so LIB_B.so

Run where the CUDA toolkit's ``cuobjdump`` is (``$CUDA_HOME/bin``, default
``/usr/local/cuda``) and binutils' ``c++filt``. Each library is a build of one ``csrc/<name>.cu``
(``build/kernels/lib<name>-<hash>.so``), for example of two checkouts of
the repository. Kernels are paired by their demangled names with a
trailing ``bool`` template argument of ``false`` dropped (and ``<false>``
alone), so a kernel that gained such a parameter is compared with its
earlier self. For each pair
it prints the instruction counts of both and how many instructions differ
(opcodes and operands, addresses and encodings aside), and ``only in`` for
a kernel that has no partner.
"""
from __future__ import annotations

import difflib
import os
import re
import subprocess
import sys
from pathlib import Path

_FUNC = re.compile(r"^\s*Function : (\S+)")
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;")


def _cuobjdump() -> str:
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump")


def kernels(lib: str) -> dict:
    """{paired name: [instruction text]} of every kernel in ``lib``."""
    out = subprocess.run([_cuobjdump(), "-sass", lib], capture_output=True, text=True,
                         check=True).stdout
    mangled = [m.group(1) for m in map(_FUNC.match, out.splitlines()) if m]
    names = subprocess.run(["c++filt"], input="\n".join(mangled), capture_output=True,
                           text=True, check=True).stdout.splitlines()
    found, current, order = {}, None, iter(names)
    for line in out.splitlines():
        if _FUNC.match(line):
            name = re.sub(r"<false>", "", re.sub(r", false>", ">", next(order)))
            current = name.removeprefix("void ")   # a template's name carries its type
            found[current] = []
        elif current is not None:
            m = _INSN.search(line)
            if m:
                found[current].append(re.sub(r"\s+", " ", m.group(1)))
    return found


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = kernels(argv[0]), kernels(argv[1])
    for name in sorted(set(a) | set(b)):
        if name not in a or name not in b:
            print(f"only in {'B' if name not in a else 'A'}: {name}")
            continue
        sm = difflib.SequenceMatcher(a=a[name], b=b[name], autojunk=False)
        differ = sum(max(i2 - i1, j2 - j1) for tag, i1, i2, j1, j2 in sm.get_opcodes()
                     if tag != "equal")
        print(f"{name}: {len(a[name])} vs {len(b[name])} instructions, {differ} differ")
    return 0


if __name__ == "__main__":
    sys.exit(main())
