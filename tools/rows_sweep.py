"""Time K1's many-rows kernel for variants of its matvec constants above 8
offsets, on one card in one call. The constants are those of
firefoam_torch/csrc/dia_krylov.cu: kRowsStencilChunk (the offsets a lane
takes at once in rows_run) and kRowsMvCells (the cells of a lane whose
stencils run together, for float32 and float64).

    python tools/rows_sweep.py --out DIR CHUNK:F32CELLS:F64CELLS [...]

Each variant is a copy of this checkout's firefoam_torch under
DIR/v<CHUNK>_<F32CELLS>_<F64CELLS> with the two constants replaced. All are
built at once (one nvcc each), then `tools/kernel_ab.py --rows-only` runs on
each in turns, forward and back. Prints one JSON line: by variant, ptxas's
spill stores for each bicgstab_rows_kernel instantiation and the two runs'
"rows" (ms, iterations, SHA-256 of x, W and window=0; the sums do not depend
on the constants, so every variant prints the same SHA-256). Needs a CUDA
card; imports no JAX.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = r"constexpr int kRowsStencilChunk = \d+;"
CELLS = r"constexpr int kRowsMvCells = sizeof\(T\) == 4 \? \d+ : \d+;"


def variant(out, chunk, f32, f64):
    """A copy of firefoam_torch with the two constants replaced; its root."""
    root = os.path.join(out, f"v{chunk}_{f32}_{f64}")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, "firefoam_torch"), os.path.join(root, "firefoam_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = os.path.join(root, "firefoam_torch", "csrc", "dia_krylov.cu")
    with open(src) as f:
        text = f.read()
    for pattern, new in ((CHUNK, f"constexpr int kRowsStencilChunk = {chunk};"),
                         (CELLS, f"constexpr int kRowsMvCells = sizeof(T) == 4 ? {f32} : {f64};")):
        text, n = re.subn(pattern, new, text)
        if n != 1:
            raise SystemExit(f"rows_sweep: {pattern!r} found {n} times in {src}")
    with open(src, "w") as f:
        f.write(text)
    return root


def spills(root):
    """{"f<K>" or "d<K>": spill stores in bytes} of bicgstab_rows_kernel<T, K>."""
    out = {}
    for log in glob.glob(os.path.join(root, "firefoam_torch", "_build", "ptxas_*.log")):
        with open(log) as f:
            text = f.read()
        for m in re.finditer(r"bicgstab_rows_kernelI([fd])Li(\d+)E.*?\n.*?(\d+) bytes spill stores",
                             text):
            out[f"{m.group(1)}{m.group(2)}"] = int(m.group(3))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True, help="directory for the variants' copies")
    ap.add_argument("variants", nargs="+", help="CHUNK:F32CELLS:F64CELLS")
    args = ap.parse_args()
    roots = [variant(args.out, *(int(v) for v in spec.split(":"))) for spec in args.variants]
    build = "import sys; sys.path.insert(0, sys.argv[1]); " \
            "from firefoam_torch.solvers import dia_krylov as dk; dk.build_seconds()"
    procs = [subprocess.Popen([sys.executable, "-c", build, root]) for root in roots]
    if any(p.wait() != 0 for p in procs):
        raise SystemExit("rows_sweep: a variant did not build")
    result = {os.path.basename(r): {"spill_stores": spills(r), "runs": []} for r in roots}
    ab = os.path.join(REPO, "tools", "kernel_ab.py")
    with tempfile.TemporaryDirectory(prefix="rows_sweep_") as tmp:
        for root in roots + roots[::-1]:
            path = os.path.join(tmp, "ab.json")
            subprocess.run([sys.executable, ab, "--root", root, "--rows-only", "--out", path],
                           check=True, stdout=subprocess.DEVNULL)
            with open(path) as f:
                run = json.load(f)
            result["card"] = run["card"]
            result[os.path.basename(root)]["runs"].append(run["rows"])
    print(json.dumps(result))


if __name__ == "__main__":
    main()
