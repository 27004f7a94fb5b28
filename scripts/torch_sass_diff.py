#!/usr/bin/env python3
"""Compare this tree's CUDA kernels with another tree's, kernel by kernel.

    python3 scripts/torch_sass_diff.py OTHER_TREE [SOURCE ...]

Builds each source of ``surfh_tpu_torch/csrc/`` (default: every ``*.cu``)
from both trees with the package's nvcc flags (`core/_build.py`, ptxas
verbose) into a temporary directory, disassembles both with
``cuobjdump -sass``, and prints, for every kernel the two builds share,
whether its instructions are the same one for one (addresses and encodings
set aside) and its ptxas line from each build; then the kernels only one
build has.  Needs nvcc (a machine with the CUDA toolkit); imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HERE = Path(__file__).resolve().parents[1]
CSRC = Path("surfh_tpu_torch") / "csrc"


def kernel_name(mangled: str) -> str:
    """A kernel's name without the hash nvcc gives each build's anonymous
    namespace, so that one kernel has one name in both builds."""
    return re.sub(r"\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+", "_GLOBAL__N_", mangled)


def build(tree: Path, source: str, out: Path):
    """(SASS instructions by kernel, ptxas lines by kernel) of one source."""
    from surfh_tpu_torch.core import _build

    nvcc = _build.find_nvcc()
    so = out / f"{tree.name}-{source}.so"
    proc = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-o", str(so), str(tree / CSRC / source)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on {tree / CSRC / source}:\n{proc.stderr[-4000:]}")
    ptxas, name = {}, None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = kernel_name(m.group(1))
        elif name and ("registers" in line or "spill" in line):
            ptxas[name] = (ptxas.get(name, "") + " " + line.split(":", 1)[-1].strip()).strip()
    tool = shutil.which("cuobjdump") or os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass, name = {}, None
    for line in subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True,
                               check=True).stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = kernel_name(m.group(1))
            sass[name] = []
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if m and name:
            sass[name].append(m.group(1))
    return sass, ptxas


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path, help="root of the other tree (e.g. a git archive of the parent)")
    ap.add_argument("sources", nargs="*", help="files of csrc/ (default: every *.cu)")
    args = ap.parse_args(argv)
    sources = args.sources or sorted(p.name for p in (HERE / CSRC).glob("*.cu"))
    with tempfile.TemporaryDirectory() as tmp:
        for source in sources:
            mine, mine_ptx = build(HERE, source, Path(tmp))
            theirs, theirs_ptx = build(args.other.resolve(), source, Path(tmp))
            same = sum(mine[k] == theirs[k] for k in mine.keys() & theirs.keys())
            print(f"[sass] {source}: {len(mine.keys() & theirs.keys())} kernels in both, "
                  f"{same} instruction for instruction the same", flush=True)
            for k in sorted(mine.keys() & theirs.keys()):
                print(f"[sass]   {'same' if mine[k] == theirs[k] else 'DIFFERENT'} {k} "
                      f"({len(mine[k])} / {len(theirs[k])} instructions); ptxas here: "
                      f"{mine_ptx.get(k, '?')}; there: {theirs_ptx.get(k, '?')}", flush=True)
            for k in sorted(mine.keys() ^ theirs.keys()):
                print(f"[sass]   only {'here' if k in mine else 'there'}: {k}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
