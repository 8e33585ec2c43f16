#!/usr/bin/env python3
"""Where ``flash_attention_bwd``'s bf16 time goes, on one card.

Compiles copies of ``csrc/flash_attention_bwd.cu`` with parts of the
consumer warpgroups' work taken out, and times each beside the real
one at qwen1.5-0.5b's training shape [128, 512, 64] and at head dim 128
[64, 512, 128] (device time from a CUDA graph, and each kernel's time
under ``torch.profiler``):

- ``full``: the kernels as they are;
- ``no_softmax``: P = S and dS = dP (no exponent, mask, lse or delta);
- ``no_rs``: without the dV, dK and dQ products;
- ``no_ss``: without the S and dP products;
- ``no_products``: without any product;
- ``idle``: consumers that only wait for each tile and release it, so
  that what is left is the data's way in (TMA, the ring, the prep
  kernel) and the stores.

The copies compute wrong gradients by design; only ``full`` is the
kernel. Builds into ``build/bwd_ablate/``; needs ``nvcc`` and a card.

    python3 scripts/bwd_ablate.py
"""
import ctypes
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
import chip_smoke as C  # noqa: E402

SOFTMAX = [("float p0 = ex2(fmaf(s[jj], sl2, -l2.x));", "float p0 = s[jj];"),
           ("float p1 = ex2(fmaf(s[jj + 1], sl2, -l2.y));",
            "float p1 = s[jj + 1];"),
           ("pack(p0 * (dp[jj] - dl.x), p1 * (dp[jj + 1] - dl.y))",
            "pack(dp[jj], dp[jj + 1])"),
           ("float p0 = ex2(fmaf(s[jj], sl2, -lse2[h]));", "float p0 = s[jj];"),
           ("float p1 = ex2(fmaf(s[jj + 1], sl2, -lse2[h]));",
            "float p1 = s[jj + 1];"),
           ("pack(p0 * (dp[jj] - del[h]), p1 * (dp[jj + 1] - del[h]))",
            "pack(dp[jj], dp[jj + 1])"),
           ("if (edge) {", "if (false) {")]
RS = [("accumulate<D>(dv, pa, gs);", ""), ("accumulate<D>(dk, da, qs);", ""),
      ("accumulate<D>(dq, da, ks);", "")]
SS = [("scores<D>(s, ka, OWN, qs, TILE);", ""),
      ("scores<D>(dp, va, OWN, gs, TILE);", ""),
      ("scores<D>(s, qa, OWN, ks, TILE);", ""),
      ("scores<D>(dp, ga, OWN, vs, TILE);", "")]
IDLE = [("if (kw0 <= q0 + TILE - 1 && kw0 < S) {", "if (false) {"),
        ("if (t0 <= qw0 + 63 && qw0 < S) {", "if (false) {")]
VARIANTS = {"full": [], "no_softmax": SOFTMAX, "no_rs": RS, "no_ss": SS,
            "no_products": RS + SS, "idle": IDLE}


def build_variants(out_dir: str) -> None:
    from repro_torch.kernels import build
    src = open(os.path.join(str(build.CSRC), "flash_attention_bwd.cu")).read()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} is not in the source")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o",
             os.path.join(out_dir, f"{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{out}")


def main() -> int:
    import torch
    from repro_torch.kernels import ops
    if not torch.cuda.is_available():
        print("bwd_ablate: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    out_dir = os.path.join(ROOT, "build", "bwd_ablate")
    build_variants(out_dir)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for bh, s, d in ((128, 512, 64), (64, 512, 128)):
        gen = torch.Generator(device=dev).manual_seed(1)
        q, k, v, do = (torch.randn(bh, s, d, generator=gen, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        out, lse = ops.flash_attention_lse(q, k, v)
        delta = torch.empty(bh, s, device=dev)
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        for name in VARIANTS:
            fn = ctypes.CDLL(os.path.join(out_dir, f"{name}.so")) \
                .flash_attention_bwd_launch
            fn.argtypes = [vp] * 10 + [i32, i32, i32, f32, i32, vp]
            fn.restype = i32

            def call():
                rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), do.data_ptr(), lse.data_ptr(),
                        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                        dv.data_ptr(), bh, s, d, 1 / math.sqrt(d), 1,
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")

            call()
            torch.cuda.synchronize()
            tr = C.trace_window(
                lambda: [call() for _ in range(10)] and torch.cuda.synchronize(),
                10)
            kernels = {n.split("::")[-1].split("<")[0]: t
                       for n, t in tr["top"][:3]}
            print(f"[bwd_ablate] [{bh},{s},{d}] {name}: device_ms "
                  f"{C.graph_ms(call, 10):.4f}, per kernel {kernels}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
