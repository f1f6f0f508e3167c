#!/usr/bin/env python3
"""The loops of the port's kernels, instruction by instruction, from their SASS.

Builds the named sources of a checkout (``evox_tpu_torch/csrc/<name>.cu``),
disassembles each library with ``cuobjdump -sass`` and, for every kernel
function, finds its loops (a branch back to an earlier address) and counts
each loop's instructions by kind:

- ``integer``: the integer pipe's instructions (``IMAD``, ``IADD3``,
  ``LOP3``, ``SHF``, ``ISETP``, ``IMNMX``, ``SEL``, ``PRMT``, ``LEA``,
  ``POPC``, ``MOV``, ...);
- ``float_compare``: ``FSETP``, ``FSEL``, ``FMNMX``, ``DSETP``;
- ``float``: ``FADD``, ``FMUL``, ``FFMA`` (the FMA pipe);
- ``predicate``: ``PLOP3``, ``P2R``, ``R2P``;
- ``memory``, ``shuffle``, ``control``, ``uniform`` (the ``U``-prefixed
  uniform datapath) and ``other``.

A loop with ``LDG.E.128`` loads reports ``words`` (four a load) and
``issue_per_word``: its integer, compare and predicate instructions over
the words one pass of the loop takes, lane by lane. These are the
instructions a word that D1's bound counts at the card's integer issue
rate (64 a clock an SM). Run from a checkout, on the machine with the
card (``nvcc`` and ``cuobjdump`` from the CUDA toolkit)::

    python3 tools/torch_sass_loops.py DIR [--libs digest,dominance] [--out-dir PATH]

The listings go to ``--out-dir`` (a directory that ``.gitignore`` lists);
the last line of standard output is one JSON object with the counts.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

KINDS = {
    "float_compare": {"FSETP", "FSEL", "FMNMX", "DSETP"},
    "float": {"FADD", "FMUL", "FFMA"},
    "predicate": {"PLOP3", "P2R", "R2P"},
    "memory": {"LDG", "STG", "LDS", "STS", "LD", "ST", "ATOM", "ATOMG", "ATOMS", "RED", "REDG",
               "LDC", "LDGSTS", "LDSM", "LDL", "STL"},
    "shuffle": {"SHFL"},
    "control": {"BRA", "EXIT", "BAR", "BSSY", "BSYNC", "WARPSYNC", "NOP", "CALL", "RET", "YIELD",
                "DEPBAR", "BPT", "MEMBAR", "ERRBAR", "CCTL", "VOTEU", "ENDCOLLECTIVE"},
    "integer": {"IMAD", "IADD3", "LOP3", "SHF", "ISETP", "IMNMX", "SEL", "PRMT", "LEA", "POPC",
                "FLO", "BMSK", "IABS", "VIMNMX", "VIMNMX3", "IMNMX3", "SGXT", "BREV", "MOV",
                "IADD", "IMUL", "ISCADD", "LOP", "SHL", "SHR", "I2F", "F2I", "VOTE", "S2R",
                "CS2R", "IDP", "VIADD"},
}
ISSUE_KINDS = ("integer", "float_compare", "predicate")


def kind_of(opcode: str) -> str:
    base = opcode.split(".")[0]
    for kind, names in KINDS.items():
        if base in names:
            return kind
    if base.startswith("U"):
        return "uniform"
    return "other"


def functions(text: str) -> dict:
    """``cuobjdump -sass`` text -> {function: [(address, opcode, line)]}."""
    out, name = {}, None
    for line in text.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = found.group(1)
            out[name] = []
            continue
        found = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*)", line)
        if found and name:
            out[name].append((int(found.group(1), 16), found.group(3), found.group(4)))
    return out


def loops(instrs: list) -> list:
    """Each backward branch's loop: its first and last address and its
    instructions' counts by kind."""
    out = []
    for addr, op, rest in instrs:
        if not op.startswith("BRA"):
            continue
        target = re.search(r"0x([0-9a-f]+)", rest)
        if not target or int(target.group(1), 16) >= addr:
            continue
        lo = int(target.group(1), 16)
        body = [o for a, o, _ in instrs if lo <= a <= addr]
        kinds = Counter(kind_of(o) for o in body)
        ldg128 = sum(1 for o in body if o.startswith("LDG") and ".128" in o)
        loop = {"from": hex(lo), "to": hex(addr), "instructions": len(body), "kinds": dict(kinds),
                "opcodes": dict(Counter(o.split(".")[0] for o in body).most_common()),
                "ldg128": ldg128}
        if ldg128:
            loop["words"] = 4 * ldg128
            loop["issue_per_word"] = sum(kinds.get(k, 0) for k in ISSUE_KINDS) / loop["words"]
        out.append(loop)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("tree", type=Path)
    parser.add_argument("--libs", default="digest,dominance")
    parser.add_argument("--out-dir", type=Path, default=None)
    args = parser.parse_args()
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree))
    from evox_tpu_torch.kernels import _build

    names = args.libs.split(",")
    libs = _build.build(names)
    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    result = {"tree": str(tree)}
    for name in names:
        text = subprocess.run([str(tool), "-sass", str(libs[name])], capture_output=True,
                              text=True, check=True).stdout
        if args.out_dir is not None:
            args.out_dir.mkdir(parents=True, exist_ok=True)
            (args.out_dir / f"{name}.sass").write_text(text)
        result[name] = {fn: {"instructions": len(body),
                             "kinds": dict(Counter(kind_of(o) for _, o, _ in body)),
                             "loops": loops(body)}
                        for fn, body in functions(text).items()}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
