#!/usr/bin/env python3
"""Where the bf16 LSTM forward's step goes, on one NVIDIA card.

    python3 chip_phase_profile.py    # about a minute on an H100

Copies `deeplearning4j_tpu_torch/` into a temporary directory, plants
`clock64()` readings around the phases of `lstm_fwd_cluster_kernel`'s
consumer warpgroups in the copy's `csrc/lstm.cu` (the checkout is never
changed), builds it, and runs the forward at main path 4's shape (T=8,
B=2048, H=1024) and main path 4b's window (B=8192, H=256, unmasked and
masked). Block (0, 0)'s two consumer warpgroups print their SM cycles per
step, averaged over the steps: the product (first chunk wait included),
the wait for the xw tile, the cell phase, the output stores (thread 0's
warpgroup issues them and waits for h_t) and the cluster barrier. The
instrumented kernel is slower than the real one by the readings' cost;
the shares, not the sums, are what it shows. Exits non-zero without a
CUDA device.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "deeplearning4j_tpu_torch"
# (text, replacement): each replaces the one occurrence of `text`
EDITS = [
    ("""  uint32_t q = 0;  // chunks consumed before this step
  for (int s = 0; s < a.T; ++s) {
    const int t = a.reverse ? a.T - 1 - s : s;
    const bool last = s == a.T - 1;
""", """  uint32_t q = 0;  // chunks consumed before this step
  long long tp = 0, tx = 0, tc = 0, ts = 0, tb = 0;
  for (int s = 0; s < a.T; ++s) {
    const int t = a.reverse ? a.T - 1 - s : s;
    const bool last = s == a.T - 1;
    const long long t0 = clock64();
"""),
    ("""    sm90::mbar_wait(&sm.x_full, s & 1);
    // ---- cell phase""", """    const long long t1 = clock64();
    sm90::mbar_wait(&sm.x_full, s & 1);
    const long long t2 = clock64();
    // ---- cell phase"""),
    ("""    sm90::fence_proxy_async_smem();
    asm volatile("bar.sync 1, %0;\\n" ::"n"(kConsumers) : "memory");
    if (tid == 0) {""", """    const long long t3 = clock64();
    sm90::fence_proxy_async_smem();
    asm volatile("bar.sync 1, %0;\\n" ::"n"(kConsumers) : "memory");
    if (tid == 0) {"""),
    ("""    sm90::cluster_sync();
  }
  if (tid == 0) sm90::bulk_wait<0>();  // the last step's stash is stored
}""", """    const long long t4 = clock64();
    sm90::cluster_sync();
    tp += t1 - t0, tx += t2 - t1, tc += t3 - t2, ts += t4 - t3;
    tb += clock64() - t4;
  }
  if (tid == 0) sm90::bulk_wait<0>();  // the last step's stash is stored
  if (blockIdx.x == 0 && blockIdx.y == 0 && tid % 128 == 0)
    printf("PHASES rows=%d H=%d masked=%d wg=%d: product %lld, xw wait "
           "%lld, cell %lld, stores %lld, barrier %lld cycles per step\\n",
           ROWS, a.H, (int)MASKED, wg, tp / a.T, tx / a.T, tc / a.T,
           ts / a.T, tb / a.T);
}"""),
    ("#include <stdint.h>\n", "#include <stdint.h>\n#include <cstdio>\n"),
]


def instrumented(src: str) -> str:
    for text, new in EDITS:
        if src.count(text) != 1:
            raise RuntimeError(f"instrumentation anchor not found once: "
                               f"{text[:60]!r}")
        src = src.replace(text, new)
    return src


def run(root: str) -> None:
    """In the copy's process: the three forward launches."""
    import torch

    sys.path[:0] = [root, REPO]
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.ops import lstm as L

    if not L.__file__.startswith(root):
        raise RuntimeError(f"ran {L.__file__}")
    for T, B, H, masked in ((8, 2048, 1024, False), (8, 8192, 256, False),
                            (8, 8192, 256, True)):
        inp = cs.lstm_inputs(torch, T, B, H, torch.bfloat16, 77, masked)
        L.lstm_fwd(inp["xw"], inp["rw"], inp["peep"], inp["h0"], inp["c0"],
                   inp["mask"])
        torch.cuda.synchronize()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_phase_profile: no CUDA device available", file=sys.stderr)
        return 2
    root = tempfile.mkdtemp(prefix="lstm_phases_")
    try:
        shutil.copytree(os.path.join(REPO, PKG), os.path.join(root, PKG),
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        path = os.path.join(root, PKG, "csrc", "lstm.cu")
        with open(path) as f:
            src = f.read()
        with open(path, "w") as f:
            f.write(instrumented(src))
        code = (f"import sys; sys.path[:0] = [{root!r}, {REPO!r}]; "
                f"import chip_phase_profile as p; p.run({root!r})")
        p = subprocess.run([sys.executable, "-c", code], cwd=root,
                           capture_output=True, text=True, timeout=600)
        print(p.stdout, end="")
        if p.returncode != 0:
            print(p.stderr[-2000:], file=sys.stderr)
        return p.returncode
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
