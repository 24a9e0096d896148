#!/usr/bin/env python3
"""Instruction mix of the port's built kernels, from their SASS.

    python3 tools/sass_mix.py [out_dir]

Builds every kernel library (as ``chip_smoke.py`` does), disassembles each
with ``cuobjdump -sass`` from the CUDA toolkit, writes the full listing to
``out_dir/<library>.sass`` (default ``build/sass``) and prints one JSON
line per kernel function: its SASS instruction count and the count of each
opcode class that tells the kernels' designs apart — tensor-core products
(``HMMA``/``HGMMA``), ``LDSM`` (ldmatrix), global loads and stores,
shared-memory loads, ``MUFU`` (ex2 and friends), shuffles, fused
multiply-adds, and local-memory traffic (``LDL``/``STL``, i.e. spills).
Needs no card, only ``nvcc`` and ``cuobjdump``.
"""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

CLASSES = ("HMMA", "HGMMA", "LDSM", "LDGSTS", "LDG", "STG", "LDS", "STS", "MUFU", "SHFL", "FFMA",
           "LDL", "STL")


def main() -> None:
    from repro_torch import kernels
    from repro_torch.kernels import _build

    out_dir = Path(sys.argv[1]) if len(sys.argv) > 1 else ROOT / "build" / "sass"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = Path(_build.find_nvcc())
    cuobjdump = shutil.which("cuobjdump") or str(nvcc.with_name("cuobjdump"))
    kernels.build_all()
    for lib in dict.fromkeys(k.library for k in kernels.KERNELS):
        sass = subprocess.run([cuobjdump, "-sass", str(lib.path)], check=True,
                              capture_output=True, text=True).stdout
        (out_dir / f"{lib.source.stem}.sass").write_text(sass)
        for name, body in re.findall(r"Function : (\S+)\n(.*?)(?=\n\s*Function : |\Z)", sass, re.S):
            ops = Counter(m.split(".")[0] for m in
                          re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", body))
            print(json.dumps({"library": lib.source.name, "function": name,
                              "instructions": sum(ops.values()),
                              **{c: ops.get(c, 0) for c in CLASSES}}))


if __name__ == "__main__":
    main()
