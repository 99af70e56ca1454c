#!/usr/bin/env python3
"""Compare the SASS of the fused codec's kernels between two sources.

    python3 scripts/codec_sass_diff.py --parent <dir>/src/repro_torch/csrc/varco_pack_quant.cu

Builds the given (older) ``varco_pack_quant.cu`` and the repository's
with the same ``nvcc`` flags as ``repro_torch.kernels._build``, dumps
both libraries' SASS with ``cuobjdump -sass`` and prints, for every
kernel of the two (matched by kind and width: the pack kernels' round-
half-even instantiation, the stochastic one, the unpack kernels), one
JSON line: the instruction counts, whether the opcode sequences are
identical, and how many instructions differ once constant-bank offsets
(kernel parameter addresses) are masked out.  The last line summarises.
Needs the CUDA toolkit (run it on the machine with the card).
"""

from __future__ import annotations

import argparse
import difflib
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?);")
CBANK = re.compile(r"c\[0x[0-9a-f]+\]\[0x[0-9a-f]+\]")


def build(src: Path, out: Path) -> None:
    from repro_torch.kernels import _build

    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
           "-o", str(out), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode:
        raise SystemExit(f"nvcc failed for {src}:\n{res.stdout}{res.stderr}")


def kernels(lib: Path) -> dict:
    """``{kind: [instruction text]}`` of every kernel in ``lib``, keyed
    ``pack_w<W>_rint`` / ``pack_w<W>_stoch`` / ``unpack_w<W>``."""
    from repro_torch.kernels import _build

    tool = Path(_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            sym = m.group(1)
            w = re.search(r"_kernelILi(\d)E", sym)
            if "unpack_quant_kernel" in sym:
                name = f"unpack_w{w.group(1)}"
            elif "pack_quant_kernel" in sym:
                stoch = "Lb1E" in sym
                name = f"pack_w{w.group(1)}_" + ("stoch" if stoch else "rint")
            else:
                name = None
            if name:
                out[name] = []
            continue
        m = INSTR.search(line)
        if m and name:
            out[name].append(" ".join(m.group(1).split()))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="the older varco_pack_quant.cu to compare against")
    args = ap.parse_args(argv)
    from repro_torch.kernels import _build

    with tempfile.TemporaryDirectory() as tmp:
        libs = {}
        for tag, src in (("parent", args.parent.resolve()),
                         ("change", _build.CSRC / "varco_pack_quant.cu")):
            libs[tag] = Path(tmp) / f"lib{tag}.so"
            build(src, libs[tag])
        old, new = kernels(libs["parent"]), kernels(libs["change"])
    same = {}
    for name in sorted(set(old) | set(new)):
        a, b = old.get(name), new.get(name)
        rec = {"kernel": name, "parent_instructions": None if a is None
               else len(a), "change_instructions": None if b is None
               else len(b)}
        if a is not None and b is not None:
            ops_a = [i.split()[0] for i in a]
            ops_b = [i.split()[0] for i in b]
            masked_a = [CBANK.sub("c[*]", i) for i in a]
            masked_b = [CBANK.sub("c[*]", i) for i in b]
            diff = sum(1 for d in difflib.ndiff(masked_a, masked_b)
                       if d[:1] in "+-")
            rec.update(opcodes_identical=ops_a == ops_b,
                       text_identical=a == b,
                       differing_lines_masked=diff)
            same[name] = ops_a == ops_b
        print(json.dumps(rec), flush=True)
    print(json.dumps({"summary": "codec_sass_diff",
                      "opcodes_identical": same}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
