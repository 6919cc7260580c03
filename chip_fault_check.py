#!/usr/bin/env python3
"""Mutation check of the flash-attention kernels' correctness check on one
NVIDIA card: does `chip_smoke.py`'s comparison against the plain versions
catch a kernel that is wrong?

    python3 chip_fault_check.py      # about 2 minutes on an H100

For the unchanged source and for each planted fault below, the script
copies `deeplearning4j_tpu_torch/` into a temporary directory, plants the
fault in the copy's `csrc/flash_attention.cu` (the checkout is never
changed), builds every copy with nvcc in parallel, and then runs, in one
process per copy, the bf16 forward, dQ and dK/dV kernels on the cases
below and holds them to the plain versions in f32 with
`flash_attention.error_in_tolerances` (O, dQ, dK, dV row by row; L
absolute), as `chip_smoke.py` does. Beside it, each case is also read
against the earlier bound (the largest absolute error within 2e-2 of the
reference's largest magnitude), to show what that bound let through.

Prints a table and, as the last line, one JSON object
`{"control_ok": ..., "mutants": [{"name", "caught", "caught_by_old_bound",
"worst": ...}]}`. Exits 0 when the unchanged kernels pass every case and
every planted fault fails at least one; non-zero otherwise, or without a
CUDA device.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "deeplearning4j_tpu_torch"
SOURCE = os.path.join(PKG, "csrc", "flash_attention.cu")
# (B, T, H, D, causal), bf16: the training path's kernels at D = 128 and
# the same templates at D = 256
CASES = [(2, 512, 2, 128, False), (2, 512, 2, 128, True),
         (1, 4096, 2, 128, True), (2, 512, 2, 256, True),
         (1, 4096, 2, 256, False)]
OLD_BOUND = 2e-2
# (name, anchor, text, replacement): the first `text` after `anchor`
FWD = "flash_fwd_mma_kernel(const Args a) {"
DQ = "flash_bwd_dq_mma_kernel(const Args a) {"
DKV = "flash_bwd_dkv_mma_kernel(const Args a) {"
MUTATIONS = [
    ("forward skips the last K/V tile", FWD,
     "const int nk = a.causal ? qi + 1 : a.Tk / BLK;",
     "const int nk = a.causal ? qi : a.Tk / BLK - 1;"),
    ("forward drops P.V of the last K/V tile (L intact)", FWD,
     "warp_pb<NO, 4, LD>(o, s, V);",
     "if (kj + 1 < nk) warp_pb<NO, 4, LD>(o, s, V);"),
    ("forward drops P.V of the second-to-last K/V tile (L intact)", FWD,
     "warp_pb<NO, 4, LD>(o, s, V);",
     "if (kj + 2 != nk) warp_pb<NO, 4, LD>(o, s, V);"),
    # far from the diagonal: only rows that see more than 2560 keys (the
    # T=4096 cases) lose 64 of them, a small change to rows of small values
    ("forward drops P.V of K/V tile 40 (L intact)", FWD,
     "warp_pb<NO, 4, LD>(o, s, V);",
     "if (kj != 40) warp_pb<NO, 4, LD>(o, s, V);"),
    ("dQ drops dS.K of K/V tile 40", DQ,
     "warp_pb<NO, 4, LD>(dq, s, K + c0);",
     "if (kj != 40) warp_pb<NO, 4, LD>(dq, s, K + c0);"),
    ("dV drops P^T.dO of Q tile 40", DKV,
     "warp_pb<NO, 4, LD>(dv, s, dO + c0);",
     "if (qi != 40) warp_pb<NO, 4, LD>(dv, s, dO + c0);"),
    ("dQ skips the last K/V tile", DQ,
     "const int nk = a.causal ? qi + 1 : a.Tk / BLK;",
     "const int nk = a.causal ? qi : a.Tk / BLK - 1;"),
    ("dK/dV skips the last Q tile", DKV,
     "const int nq = a.Tq / BLK;",
     "const int nq = a.Tq / BLK - 1;"),
    ("dK drops the dsum term", DKV,
     "s[j][e] *= dp[j][e] - Ds[8 * j + 2 * t + (e & 1)];",
     "s[j][e] *= dp[j][e];"),
]


def log(*a):
    print(*a, flush=True)


def mutate(src: str, anchor: str, text: str, new: str) -> str:
    at = src.index(anchor)
    i = src.index(text, at)
    return src[:i] + new + src[i + len(text):]


def make_copy(root: str, mutation) -> str:
    """A copy of the package under `root`, with `mutation` planted."""
    shutil.copytree(os.path.join(REPO, PKG), os.path.join(root, PKG),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    if mutation is not None:
        path = os.path.join(root, SOURCE)
        with open(path) as f:
            src = f.read()
        with open(path, "w") as f:
            f.write(mutate(src, *mutation[1:]))
    return root


def child_cmd(root: str, what: str):
    code = (f"import sys; sys.path[:0] = [{root!r}, {REPO!r}]; "
            f"import chip_fault_check as c; c.{what}()")
    return [sys.executable, "-c", code]


def build() -> None:
    from deeplearning4j_tpu_torch.ops import cuda_build

    cuda_build.build(["flash_attention"])


def check() -> None:
    """In a copy's process: run the cases, print one JSON line."""
    import torch

    import chip_smoke as cs
    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    cases = []
    for i, (B, T, H, D, causal) in enumerate(CASES):
        q, k, v, do = cs.flash_inputs(torch, B, T, H, D, torch.bfloat16,
                                      seed=60 + i)
        got = cs.flash_run(fa, q, k, v, do, causal)
        ref = cs.flash_plain_f32(fa, q, k, v, do, causal, got)
        errs = cs.flash_errors(fa, got, ref, torch.bfloat16)
        old = []
        for g, r in zip(got, ref):
            e = (g.float() - r).abs().max().item()
            old.append(e / (OLD_BOUND * r.abs().max().item())
                       if e == e and abs(e) != float("inf")
                       else float("inf"))
        cases.append({"case": f"B={B} T={T} H={H} D={D} "
                              f"{'causal' if causal else 'full'}",
                      "units": {n: u for n, _, u in errs},
                      "old_units": max(old)})
    print(json.dumps({"package": fa.__file__, "cases": cases}), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_fault_check: no CUDA device available", file=sys.stderr)
        return 2
    runs = [("unchanged", None)] + [(m[0], m) for m in MUTATIONS]
    base = tempfile.mkdtemp(prefix="flash_fault_")
    try:
        roots = [make_copy(os.path.join(base, str(i)), m)
                 for i, (_, m) in enumerate(runs)]
        builds = [subprocess.Popen(child_cmd(r, "build"), cwd=r,
                                   stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True)
                  for r in roots]
        for (name, _), p in zip(runs, builds):
            out, _ = p.communicate()
            if p.returncode != 0:
                raise RuntimeError(f"build of '{name}' failed:\n{out}")
        results = []
        for (name, _), root in zip(runs, roots):
            p = subprocess.run(child_cmd(root, "check"), cwd=root,
                               capture_output=True, text=True, timeout=600)
            if p.returncode != 0:
                log(f"{name}: the check process failed (exit "
                    f"{p.returncode}): {p.stderr.strip()[-400:]}")
                results.append((name, None))
                continue
            res = json.loads(p.stdout.strip().splitlines()[-1])
            if not res["package"].startswith(root):
                raise RuntimeError(f"'{name}' ran {res['package']}")
            results.append((name, res["cases"]))
    finally:
        shutil.rmtree(base, ignore_errors=True)

    summary = []
    for name, cases in results:
        log(f"{name}:")
        if cases is None:  # a crash is caught too, but says nothing of the check
            summary.append({"name": name, "caught": True,
                            "caught_by_old_bound": True, "worst": None})
            continue
        for c in cases:
            log(f"  {c['case']:<28} " + " ".join(
                f"{n} {u:.3g}" for n, u in c["units"].items())
                + f" | old bound {c['old_units']:.3g}")
        worst = max(max(c["units"].values()) for c in cases)
        summary.append({"name": name, "caught": worst > 1.0,
                        "caught_by_old_bound": any(
                            c["old_units"] > 1.0 for c in cases),
                        "worst": worst})
    control = summary[0]
    ok = not control["caught"] and all(m["caught"] for m in summary[1:])
    log("unchanged kernels pass" if not control["caught"]
        else "the UNCHANGED kernels fail the check")
    for m in summary[1:]:
        log(f"  {m['name']}: {'caught' if m['caught'] else 'MISSED'} "
            f"(old bound: {'caught' if m['caught_by_old_bound'] else 'missed'})")
    print(json.dumps({"control_ok": not control["caught"],
                      "mutants": summary[1:]}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
