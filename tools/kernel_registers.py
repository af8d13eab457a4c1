#!/usr/bin/env python3
"""Print the registers of K1, K2 and K3, kernel by kernel, as ptxas reports
them for another tree's build.

``chip_smoke.py`` prints them for this tree; this reads them for a tree
whose ``chip_smoke.py`` does not, e.g. a parent unpacked with ``git archive``
into ``build/``.  Run from the repository root on a machine with the CUDA
toolkit: ``python3 tools/kernel_registers.py [TREE]`` (default: this
tree).  It builds TREE's kernels with TREE's own
``xcube_resampling_tpu_torch._build`` into a fresh directory under TREE's
``build/`` (removed after), so that ptxas reports every kernel, and prints
one line a kernel of ``srw_vertical.cu``, ``srw_horizontal.cu`` and
``fused_reproject.cu`` (parsed by ``chip_smoke.ptxas_kernels``): its mangled
name (template arguments ``Li<method>`` and, where the tree has band forms,
``Lb<band>``), registers, spill store bytes and stack frame bytes.
"""

from __future__ import annotations

import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    tree = Path(sys.argv[1] if len(sys.argv) > 1 else ROOT).resolve()
    sys.path.insert(0, str(ROOT))
    from chip_smoke import ptxas_kernels

    sys.path.insert(0, str(tree))
    from xcube_resampling_tpu_torch import _build

    if not Path(_build.__file__).resolve().is_relative_to(tree):
        raise SystemExit(f"imported {_build.__file__}, not {tree}'s")
    (tree / "build").mkdir(exist_ok=True)
    _build.BUILD_DIR = Path(tempfile.mkdtemp(prefix="kernel_registers.", dir=tree / "build"))
    try:
        log = _build.build().log
    finally:
        shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    for pattern in ("srw_vertical_kernel", "srw_horizontal_kernel", "fused_reproject_kernel"):
        for name, regs, spill, stack in ptxas_kernels(log, pattern):
            print(f"{tree}: {name}: {regs} registers, {spill} bytes spilled, "
                  f"{stack} bytes of stack frame")
    return 0


if __name__ == "__main__":
    sys.exit(main())
