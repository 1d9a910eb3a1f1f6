"""Where the generic trunk kernel's time goes (csrc/trunk_any.cu, K2 on
coords), on the card:

    python tests/trunk_any_breakdown.py [--reps 5]

It builds four variants of the kernel's source, all at once, and times
K2 through ``fused_trunk_cn`` with each, beside the plain trunk:

- ``base``: the source as it is;
- ``no_mma``: the mma instructions emptied (their operands are still
  loaded and split, the partial sums still added and stored);
- ``no_weight_reads``: every weight slice zero-filled by its cp.async
  instead of read from L2 (the streamed features are still read);
- ``neither``: both.

So base - no_weight_reads is what the weights' L2 reads cost beyond what
overlaps them, base - no_mma what the tensor cores' products cost, and
``neither`` the rest (staging of the features, the splits, the barriers,
the stores, the packing of the blob). The variants' logits are wrong by
design; only ``base`` is held against the plain trunk (1e-4). One JSON
line per widths case, the card's name and power limit on the line
before the last, and everything in chiprun_out/trunk_any_breakdown.json.
It imports torch and the port only.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as S  # noqa: E402
from vtaco_tpu_torch.ops import fast_trunk as FT  # noqa: E402
from vtaco_tpu_torch.ops.cuda import build, decode as K  # noqa: E402

MMA = ('"mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "\n'
       '      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"')
WEIGHT_READ = "cp_async16(dst, from, valid);"
PATCHES = {"base": (), "no_mma": ((MMA, '""'),),
           "no_weight_reads": ((WEIGHT_READ, "cp_async16(dst, from, false);"),),
           "neither": ((MMA, '""'), (WEIGHT_READ, "cp_async16(dst, from, false);"))}
# (hidden, C, n_blocks), points: chip_smoke.py's 64-wide path and its
# widths phase's widest cases
CASES = [((64, 64, 5), 1 << 21), ((256, 512, 5), 1 << 18), ((512, 1024, 3), 1 << 18),
         ((1024, 32, 5), 1 << 18)]


def build_variants(out_dir):
    """Compile every variant with the package's nvcc flags, one nvcc each,
    all started together; returns {name: loaded library}."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(build.CSRC, "trunk_any.cu")) as f:
        src = f.read()
    procs = {}
    for name, patches in PATCHES.items():
        text = src
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the source no longer holds {old!r} once")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", so, cu],
                                        stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(so)
    return libs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    libs = build_variants(os.path.join(build.BUILD_DIR, "breakdown"))
    _, peak = S.peaks(torch.cuda.get_device_name(0))
    rows = []
    for (H, C, NB), N in CASES:
        tp = S.random_tp(dev, H, C, NB)
        g = torch.Generator(device=dev).manual_seed(1)
        p = torch.rand((3, N), generator=g, device=dev) * 1.1 - 0.55
        f = torch.randn((C, N), generator=g, device=dev)
        row = {"widths": f"{H}x{C}x{NB}", "N": N, "tile": K.any_tile(H)}
        with torch.no_grad():
            want = FT.trunk_cn(tp, p, f)
            row["plain_ms"] = S.cuda_ms(lambda: FT.trunk_cn(tp, p, f), [()], args.reps)
            for name, lib in libs.items():
                build._loaded["trunk_any"] = lib
                K._any_lib.cache_clear()
                got = K.fused_trunk_cn(tp, p, f)
                torch.cuda.synchronize()
                if name == "base":
                    row["max_abs_err"] = float((got - want).abs().max())
                    if not row["max_abs_err"] < 1e-4:
                        raise SystemExit(f"base disagrees with plain: {row}")
                row[f"{name}_ms"] = S.cuda_ms(lambda: K.fused_trunk_cn(tp, p, f), [()],
                                              args.reps)
        bound = S.any_row(0.0, 0.0, 0.0, S.any_work(N, H, C, NB), peak)
        row.update(bound_ms=bound["bound_ms"], bound_f32_ms=bound["bound_f32_ms"],
                   weight_reads_ms=row["base_ms"] - row["no_weight_reads_ms"],
                   mma_ms=row["base_ms"] - row["no_mma_ms"])
        print(json.dumps(row), flush=True)
        rows.append(row)
    build._loaded.pop("trunk_any", None)
    K._any_lib.cache_clear()
    smi = S.smi_line()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "trunk_any_breakdown.json"), "w") as f:
        json.dump({"card": smi, "reps": args.reps, "rows": rows}, f, indent=1)
    print(smi)
    print(json.dumps({"ok": True}))


if __name__ == "__main__":
    main()
