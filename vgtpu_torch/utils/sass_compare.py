"""Compare two builds of the port's CUDA libraries kernel by kernel.

    python3 -m vgtpu_torch.utils.sass_compare BUILD_A BUILD_B [NAME ...]

BUILD_A and BUILD_B are the build/cuda directories of two checkouts, each
holding lib<NAME>-<hash>.so as utils/cuda_build.CudaKernel builds it.  For
every library NAME (by default every one both hold) and every pair of
kernels of the same name (template arguments aside), prints each build's
instruction count and registers and whether the SASS is the same (the
instructions of `cuobjdump -sass` without their addresses and encodings),
and if not, how many instructions differ and whether the opcodes do.
Needs the CUDA toolkit's cuobjdump (found beside nvcc); a machine without
it raises.
"""

from __future__ import annotations

import difflib
import glob
import os
import re
import subprocess
import sys

from vgtpu_torch.utils.cuda_build import nvcc_path

_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?;)")


def base_name(mangled: str) -> str:
    """The unqualified name of an Itanium-mangled function, template
    arguments and parameters dropped (`_ZN12_GLOBAL__N_13fooILb0EEvPf` ->
    `foo`); a name that is not mangled comes back as it is."""
    if not mangled.startswith("_Z"):
        return mangled
    s, i, last = mangled, 2 + (mangled[2:3] == "N"), mangled
    while i < len(s) and s[i].isdigit():
        j = i
        while s[j].isdigit():
            j += 1
        n = int(s[i:j])
        last, i = s[j:j + n], j + n
    return last


def library(build_dir: str, name: str) -> str:
    """The newest lib<name>-<hash>.so in build_dir."""
    found = glob.glob(os.path.join(build_dir, f"lib{name}-*.so"))
    if not found:
        raise FileNotFoundError(f"no lib{name}-*.so in {build_dir}")
    return max(found, key=os.path.getmtime)


def kernels(lib: str) -> dict:
    """{mangled name: (instructions, registers)} of every kernel in lib."""
    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    res = subprocess.run([tool, "-res-usage", lib], capture_output=True,
                         text=True, check=True).stdout
    return parse(sass, res)


def parse(sass: str, res: str) -> dict:
    """{mangled name: (instructions, registers)} from the text of
    `cuobjdump -sass` and `cuobjdump -res-usage`; an instruction is its
    text without address or encoding, registers -1 where res lacks them."""
    out, fn = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = []
        elif fn is not None:
            m = _INSN.search(line)
            if m:
                out[fn].append(" ".join(m.group(1).split()))
    regs = dict(re.findall(r"Function (\S+):\s*\n?\s*REG:(\d+)", res))
    return {f: (insns, int(regs.get(f, -1))) for f, insns in out.items()}


def delta(ia: list, ib: list) -> str:
    """How two instruction lists differ: the instructions of the longer
    that an alignment (difflib) does not match, and whether the opcode
    sequences (the first word past any predicate) are the same."""
    sm = difflib.SequenceMatcher(a=ia, b=ib, autojunk=False)
    changed = sum(max(i2 - i1, j2 - j1)
                  for tag, i1, i2, j1, j2 in sm.get_opcodes() if tag != "equal")

    def ops(insns):
        return [w[1] if w[0].startswith("@") and len(w) > 1 else w[0]
                for w in (i.split() for i in insns)]

    same = "the same" if ops(ia) == ops(ib) else "different"
    return f"{changed} of {max(len(ia), len(ib))} instructions, opcodes {same}"


def compare(dir_a: str, dir_b: str, names: list) -> list:
    """One line per pair of same-named kernels of each library in names."""
    lines = []
    for name in names:
        ka = kernels(library(dir_a, name))
        kb = kernels(library(dir_b, name))
        for fa, (ia, ra) in sorted(ka.items()):
            for fb, (ib, rb) in sorted(kb.items()):
                if base_name(fa) != base_name(fb):
                    continue
                verdict = "same SASS" if ia == ib else f"SASS differs: {delta(ia, ib)}"
                lines.append(f"{name} {fa} | {fb}: {len(ia)} instructions, "
                             f"{ra} registers | {len(ib)} instructions, {rb} "
                             f"registers: {verdict}")
    return lines


def main(argv: list) -> int:
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    dir_a, dir_b, names = argv[0], argv[1], argv[2:]
    if not names:
        libs = [{re.sub(r"^lib(.*)-[0-9a-f]+\.so$", r"\1", os.path.basename(p))
                 for p in glob.glob(os.path.join(d, "lib*-*.so"))}
                for d in (dir_a, dir_b)]
        names = sorted(libs[0] & libs[1])
    for line in compare(dir_a, dir_b, names):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
