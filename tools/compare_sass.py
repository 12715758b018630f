#!/usr/bin/env python3
"""Compare the SASS of the port's CUDA kernels built from two checkouts.

    python3 tools/compare_sass.py [--ops] [--forms] OLD_CHECKOUT NEW_CHECKOUT [SOURCE ...]

Builds each named ``gowebp_tpu_torch/ops/kernels`` source (default: every
``*.cu`` both checkouts have) in each checkout with that checkout's own
``cuda_build`` (nvcc, ``sm_90a``), disassembles both libraries with
``cuobjdump -sass`` and compares them kernel by kernel, instruction by
instruction (a kernel's name is taken without its anonymous namespace's
per-build hash).  Identical SASS means identical work on the card, so a
change that only moves device code between files can show it changed
nothing.  Prints one line per kernel, the start of a diff of each kernel
that differs, and exits 1 when any kernel differs or exists on one side
only.  With ``--ops`` it also prints each kernel's count of every SASS
opcode (e.g. LDG, SHFL, IDP, the I2F/MUFU/F2I of an integer division).
With ``--forms`` a kernel is named by its form: its name up to its
template flags, trailing false flags dropped, and without its parameter
list; so a kernel that gained a template flag whose default (false) form
is the old kernel, and parameters after the old ones, is compared with
its old self, and its new forms show as new.
Needs nvcc and cuobjdump (the CUDA toolkit:
$CUDA_HOME/bin, PATH or /usr/local/cuda/bin), not a card.
"""

from __future__ import annotations

import collections
import difflib
import re
import shutil
import subprocess
import sys
from pathlib import Path

KERNELS = Path("gowebp_tpu_torch/ops/kernels")
DIFF_LINES = 60  # diff lines printed per kernel that differs


def cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    return found or "/usr/local/cuda/bin/cuobjdump"


def build(checkout: Path, sources) -> dict:
    """Build ``sources`` in ``checkout``; returns {source: library path}."""
    code = (
        "import sys\n"
        "sys.path.insert(0, '.')\n"
        "from gowebp_tpu_torch.ops.kernels.cuda_build import (CudaLibrary,\n"
        "                                                      build_all)\n"
        "libs = [CudaLibrary(s, lambda lib: None) for s in sys.argv[1:]]\n"
        "build_all(libs)\n"
        "print('\\n'.join(str(lib._so_path()) for lib in libs))\n")
    out = subprocess.run([sys.executable, "-c", code, *sources], cwd=checkout,
                         capture_output=True, text=True, check=True).stdout
    return dict(zip(sources, (checkout / p for p in out.split())))


def sass(library: Path) -> dict:
    """{kernel name without the per-build hash: [instructions]}."""
    text = subprocess.run([cuobjdump(), "-sass", str(library)],
                          capture_output=True, text=True, check=True).stdout
    kernels, current = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            current = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "", m.group(1))
            kernels[current] = []
        elif current is not None and "/*" in line:
            # (cuobjdump pads an instruction to a column that depends on
            # the function, so the whitespace is not compared)
            kernels[current].append(" ".join(re.sub(
                r"/\*[0-9a-f]{4}\*/", "", line).split()))
    return kernels


def form(name: str) -> str:
    """A kernel's mangled name up to its bool template flags, trailing
    false flags dropped (the form a later default flag leaves as it
    was), without its parameter list."""
    m = re.match(r"(.*?_kernel)((?:I(?:Lb[01]E)+E)?)", name)
    if not m:
        return name
    flags = re.findall(r"Lb([01])E", m.group(2))
    while flags and flags[-1] == "0":
        flags.pop()
    return m.group(1) + "".join(f"<{f}>" for f in flags)


def by_form(kernels: dict) -> dict:
    return {form(name): code for name, code in kernels.items()}


def opcodes(instructions) -> str:
    """'OP count' pairs of a kernel's SASS lines, most frequent first
    (the predicate and the modifiers dropped; each instruction once)."""
    ops = collections.Counter(
        re.sub(r"^@!?U?P\w+\s+", "", i).split()[0].split(".")[0].rstrip(";")
        for i in instructions if not i.startswith("/*"))  # not encodings
    return ", ".join(f"{op} {n}" for op, n in ops.most_common())


def main(argv) -> int:
    show_ops = "--ops" in argv
    forms = "--forms" in argv
    argv = [a for a in argv if a not in ("--ops", "--forms")]
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    old, new = (Path(a).resolve() for a in argv[:2])
    sources = argv[2:] or sorted(
        {p.name for p in (old / KERNELS).glob("*.cu")}
        & {p.name for p in (new / KERNELS).glob("*.cu")})
    libs_old, libs_new = build(old, sources), build(new, sources)
    same_all = True
    for source in sources:
        a, b = sass(libs_old[source]), sass(libs_new[source])
        if forms:
            a, b = by_form(a), by_form(b)
        for name in sorted(set(a) | set(b)):
            same = a.get(name) == b.get(name)
            same_all &= same
            print(f"{source} {name}: {len(a.get(name, []))} / "
                  f"{len(b.get(name, []))} SASS lines, "
                  f"{'identical' if same else 'DIFFERENT'}")
            if show_ops:
                for side, k in (("old", a), ("new", b)):
                    if name in k:
                        print(f"  {side} opcodes: {opcodes(k[name])}")
            if not same:
                diff = list(difflib.unified_diff(
                    a.get(name, []), b.get(name, []), "old", "new", n=2,
                    lineterm=""))
                print("\n".join(diff[:DIFF_LINES]))
                if len(diff) > DIFF_LINES:
                    print(f"... {len(diff) - DIFF_LINES} more diff lines")
    print("all kernels identical" if same_all else "kernels differ")
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
