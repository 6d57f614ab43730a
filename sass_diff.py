#!/usr/bin/env python3
"""Whether two builds of a kernel library compiled the same functions to
the same SASS.

    python3 sass_diff.py LIB_A LIB_B PATTERN

Runs ``cuobjdump -sass`` (the CUDA toolkit's) on both shared libraries,
takes every function whose mangled name matches PATTERN (a regular
expression), and compares its instructions with their addresses and
encodings dropped and the anonymous namespace's tag left out of the name
(``<n>_GLOBAL__N__<hash>_<file>_cu_<hash>``, which follows the source
file's contents).  Prints a line per function (its instructions in each
build, and whether they are the same) and, last, a JSON record; exits 1
where a function differs or is missing from one build.  It shows that a
change to a shared body left an instantiation's code as it was.
"""
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ANON = re.compile(r"\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}")
COMMENT = re.compile(r"/\*.*?\*/")


def functions(so_path: str) -> dict:
    """{normalised mangled name: [instructions]} of a library."""
    tool = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin"
        / "cuobjdump")
    out = subprocess.run([tool, "-sass", so_path], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    fns, body = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            body = fns.setdefault(ANON.sub("<anon>", m.group(1)), [])
        elif body is not None:
            text = " ".join(COMMENT.sub("", line).split())
            if text and not text.startswith("."):
                body.append(text)
    return fns


def main(argv=None) -> int:
    a_path, b_path, pattern = (argv or sys.argv[1:])[:3]
    a, b = functions(a_path), functions(b_path)
    names = sorted(n for n in set(a) | set(b) if re.search(pattern, n))
    rows = []
    for n in names:
        same = n in a and n in b and a[n] == b[n]
        rows.append(dict(function=n, instructions=[len(a.get(n, [])),
                                                   len(b.get(n, []))],
                         same=same))
        print(f"{'same' if same else 'DIFFERS'} {rows[-1]['instructions']} "
              f"{n}")
    print(json.dumps(dict(a=a_path, b=b_path, pattern=pattern,
                          functions=rows)))
    return 0 if rows and all(r["same"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
