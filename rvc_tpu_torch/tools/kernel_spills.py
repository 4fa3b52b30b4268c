"""Where a CUDA kernel of the PyTorch port spills registers.

    python3 -m rvc_tpu_torch.tools.kernel_spills [resblock|resblock_chain|resblock_narrow|knn]

Builds the named source of ``rvc_tpu_torch/csrc`` (``nvcc``, as the port
does at first use), prints ``ptxas -v``'s account of it, disassembles the
library (``cuobjdump -xelf`` + ``nvdisasm -g``) and counts the local-memory
stores and loads (STL / LDL) of every kernel by the source line they were
compiled from. Needs the CUDA toolkit; no card.
"""

from __future__ import annotations

import collections
import glob
import os
import re
import subprocess
import sys
import tempfile

from ..ops import _build


def main(argv) -> int:
    name = argv[1] if len(argv) > 1 else "resblock"
    print(_build.build_log(name))
    lib = _build.lib_path(name)
    bin_dir = os.path.dirname(_build.nvcc_path())
    with tempfile.TemporaryDirectory() as tmp:
        subprocess.run([os.path.join(bin_dir, "cuobjdump"), "-xelf", "all", lib],
                       cwd=tmp, check=True, capture_output=True)
        for cubin in sorted(glob.glob(os.path.join(tmp, "*.cubin"))):
            sass = subprocess.run([os.path.join(bin_dir, "nvdisasm"), "-g", "-c", cubin],
                                  capture_output=True, text=True, errors="replace").stdout
            counts = collections.Counter()
            kernel, line = "?", ("?", 0)
            for ln in sass.splitlines():
                m = re.search(r'//## File ".*?([^/"]+)", line (\d+)', ln)
                if m:
                    line = (m.group(1), int(m.group(2)))
                    continue
                m = re.match(r"\s*\.text\.(\S+):", ln)
                if m:
                    kernel = m.group(1)[-40:]
                m = re.search(r"\b(STL|LDL)\b", ln)
                if m:
                    counts[(kernel, *line, m.group(1))] += 1
            print(f"{os.path.basename(cubin)}: {len(sass.splitlines())} lines of SASS, "
                  f"{sum(counts.values())} local-memory instructions")
            for key, n in sorted(counts.items()):
                print(" ", *key, n)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
