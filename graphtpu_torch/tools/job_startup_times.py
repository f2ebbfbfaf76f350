#!/usr/bin/env python3
"""Where a subprocess job's start-up goes: each stage that a suite job's
child process (``python -m graphtpu_torch.cli run``) passes through, timed
in a fresh interpreter, each stage adding one step to the one before.

Run from the root of a checkout (builds the kernels first if needed):

    python3 graphtpu_torch/tools/job_startup_times.py [--reps 3] [--device cuda]

Prints, per stage, the wall seconds of each run and their median: the
interpreter alone, then torch imported, a tensor made on the device (its
context), the port's CLI and algorithms imported, the kernel library
loaded (on a CUDA device), and a whole ``run`` job (PageRank on
example-directed, validated).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FIXTURES = ROOT / "tests" / "fixtures" / "graphs"

STAGES = [
    ("interpreter", "pass"),
    ("+ import torch", "import torch"),
    ("+ context on the device", "import torch; torch.zeros(1, device='{device}')"),
    ("+ the port's CLI and algorithms",
     "import torch; torch.zeros(1, device='{device}'); import graphtpu_torch.cli; "
     "import graphtpu_torch.harness.platform; import graphtpu_torch.algorithms.pr"),
    ("+ the kernel library loaded",
     "import torch; torch.zeros(1, device='{device}'); import graphtpu_torch.cli; "
     "import graphtpu_torch.harness.platform; import graphtpu_torch.algorithms.pr; "
     "from graphtpu_torch.ops import kernels; kernels.library()"),
]


def _timed(argv, env) -> float:
    t0 = time.perf_counter()
    subprocess.run(argv, env=env, check=True, capture_output=True, text=True, timeout=600)
    return time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    if args.device.startswith("cuda"):
        sys.path.insert(0, str(ROOT))
        from graphtpu_torch.ops import kernels

        kernels.build()  # as the suite does before it starts a child
    stages = [(name, [sys.executable, "-c", code.format(device=args.device)])
              for name, code in STAGES]
    if not args.device.startswith("cuda"):
        stages.pop()  # the CPU runs the kernels' plain versions: no library
    stages.append(("a whole run job", [
        sys.executable, "-m", "graphtpu_torch.cli", "run",
        "--graph-properties", str(FIXTURES / "example-directed.properties"),
        "--algorithm", "pr", "--device", args.device,
        "--intermediate-dir", str(ROOT / "intermediate"),
        "--validation-file", str(FIXTURES / "example-directed-PR"),
    ]))
    for name, argv in stages:
        secs = sorted(_timed(argv, env) for _ in range(args.reps))
        print(f"{name}: median {secs[len(secs) // 2]:.3f} s (runs "
              + ", ".join(f"{s:.3f}" for s in secs) + ")", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
