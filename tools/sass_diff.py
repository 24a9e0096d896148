#!/usr/bin/env python3
"""Compare one kernel function's SASS between two listings.

    python3 tools/sass_diff.py A.sass NAME_A B.sass NAME_B

The listings are ``tools/sass_mix.py``'s ``<library>.sass`` files of two
builds (two checkouts, or two ``-D`` variants). NAME_A and NAME_B pick a
function in each by a substring of its mangled name (for example
``flash_attention_mmaILi64ELi32ELi2EE`` and
``flash_attention_mmaILi64ELi32ELi2ELb0EE``). Instructions are compared with
addresses, encodings and immediates (constant-bank offsets included) masked,
so a function that differs only in where its parameters sit compares equal.
Prints each function's name and instruction count and the differing lines.
"""
from __future__ import annotations

import difflib
import re
import sys


def function(path: str, key: str) -> tuple[str | None, list[str]]:
    for part in re.split(r"\n\s*Function : ", open(path).read()):
        name = part.split("\n", 1)[0]
        if key in name:
            body = [re.sub(r"0x[0-9a-f]+", "IMM", m.group(1))
                    for m in (re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
                              for line in part.splitlines()[1:]) if m]
            return name, body
    return None, []


def main() -> None:
    (na, a), (nb, b) = function(sys.argv[1], sys.argv[2]), function(sys.argv[3], sys.argv[4])
    if na is None or nb is None:
        raise SystemExit(f"function not found: {sys.argv[2] if na is None else sys.argv[4]}")
    print(f"{na}: {len(a)} instructions")
    print(f"{nb}: {len(b)} instructions")
    diff = list(difflib.unified_diff(a, b, lineterm="", n=0))
    print(f"{len(diff)} differing lines")
    print("\n".join(diff))


if __name__ == "__main__":
    main()
