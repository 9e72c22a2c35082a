"""Instruction counts of the kernels' SASS, by kernel and opcode.

    python -m spatialcore_tpu_torch.kernels.sass [--source FILE.cu]
        [--match TEXT] [--dump PATH]

Reads the kernel library that :func:`build.build` makes from ``csrc/``
(or, with ``--source``, one ``.cu`` file compiled alone with the same nvcc
flags) with ``cuobjdump -sass`` and prints, for every kernel whose
demangled name contains ``--match``, its instruction count by opcode
(modifiers dropped: ``IMAD.WIDE`` counts as ``IMAD``). ``--dump`` writes
the whole listing, for reading a loop body. Needs the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import collections
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

from . import build

_INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)")


def _tool(name: str) -> str:
    cand = Path(build._nvcc()).parent / name
    return str(cand) if cand.exists() else (shutil.which(name) or name)


def _listing(source: str | None) -> str:
    if source is None:
        target = str(build.build())
        return subprocess.run([_tool("cuobjdump"), "-sass", target], check=True,
                              capture_output=True, text=True).stdout
    flags = [f for f in build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        cubin = str(Path(tmp) / "k.cubin")
        subprocess.run([build._nvcc(), *flags, "-cubin", "-o", cubin, source],
                       check=True, capture_output=True, text=True)
        return subprocess.run([_tool("cuobjdump"), "-sass", cubin], check=True,
                              capture_output=True, text=True).stdout


def _demangle(names):
    try:
        out = subprocess.run([_tool("cu++filt")], input="\n".join(names),
                             check=True, capture_output=True,
                             text=True).stdout.splitlines()
        return out if len(out) == len(names) else names
    except (OSError, RuntimeError, subprocess.CalledProcessError):
        return names


def opcode_counts(listing: str) -> dict:
    """{kernel name: Counter(opcode)} of a ``cuobjdump -sass`` listing."""
    funcs, cur = {}, None
    for line in listing.splitlines():
        if "Function : " in line:
            cur = line.split("Function : ", 1)[1].strip()
            funcs[cur] = collections.Counter()
        elif cur is not None:
            m = _INSTR.search(line)
            if m:
                funcs[cur][m.group(1)] += 1
    names = list(funcs)
    return dict(zip(_demangle(names), funcs.values()))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", help="compile this .cu alone instead")
    ap.add_argument("--match", default="", help="kernel name filter")
    ap.add_argument("--dump", help="write the whole listing here")
    args = ap.parse_args(argv)
    listing = _listing(args.source)
    if args.dump:
        Path(args.dump).write_text(listing)
    for name, counts in opcode_counts(listing).items():
        if args.match in name:
            total = sum(counts.values())
            top = ", ".join(f"{op} {n}" for op, n in counts.most_common())
            print(f"[sass] {name}: {total} instructions: {top}")
    sys.stdout.flush()


if __name__ == "__main__":
    main()
