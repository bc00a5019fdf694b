"""Kernel K3 (vit_reranking_tpu_torch/csrc/kv_attention.cu) against variants
of itself on one NVIDIA card, with the card's mma.sync TF32 ceiling.

Each variant is the kept source with a few lines replaced (``VARIANTS``): the
design choices of the 3xTF32 kernel, each undone on its own.  All variants
are built at once with the port's nvcc flags into build/k3_variants/, checked
against the plain version at CvT-13 stage 0 (BH=112, T=3136, Tkv=784, D=64:
forward max abs error, dq/dk/dv max error over their largest magnitude, and
the backward's bits on a second run), and timed there by CUDA events in turns
(kept, variants, variants reversed, kept), with each kernel's device time from
torch.profiler.  A microbenchmark then measures how many TF32 mma.sync
m16n8k8 instructions the card completes a second with every warp issuing
independent ones, the ceiling of K3's products.

    python3 chip_k3_variants.py
"""

import ctypes
import subprocess
import sys
from pathlib import Path

from vit_reranking_tpu_torch.ops import native

OUT = native.BUILD_DIR.parent / "k3_variants"
KEPT = "kept"
VARIANTS = {
    "cvt.rna split": [(
        "  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
        "  lo = __float_as_uint(x - __uint_as_float(hi));",
        '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));\n'
        '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));',
    )],
    "one chain a tile": [
        ("mma_tf32(small, a.lo,", "mma_tf32(big, a.lo,"),
        ("mma_tf32(small, a.hi,", "mma_tf32(big, a.hi,"),
    ],
    "expf forward": [
        ("const float scale2 = scale * kLog2e;", "const float scale2 = scale;"),
        ("corr[h] = exp2f(", "corr[h] = expf("),
        ("s[j][e] = exp2f(", "s[j][e] = expf("),
        ("m[h] * kLn2 + logf(l[h])", "m[h] + logf(l[h])"),
    ],
    "dQ kv tile 64": [("constexpr int kDqStreamRows = 32;", "constexpr int kDqStreamRows = 64;")],
}

MMA_PEAK_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>
// Every warp issues 8 independent chains of TF32 mma.sync m16n8k8.
__global__ void mma_peak(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = (0x3f800000u + threadIdx.x * 8192u + i * 8192u) & 0xffffe000u;
  b[0] = a[1]; b[1] = a[2];
  float d[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < 8; ++c)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                   "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                   : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.0f;
  for (int c = 0; c < 8; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_peak_launch(float* out, int blocks, int threads, int iters, void* stream) {
  mma_peak<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(out, iters);
  return cudaGetLastError();
}
"""


def build_all():
    """One nvcc per source, all started together; returns {name: CDLL} and
    prints each K3 kernel's registers and spills at D = 64."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = (native.CSRC / "kv_attention.cu").read_text()
    texts = {KEPT: src}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name!r}: {old!r} is not in kv_attention.cu")
            text = text.replace(old, new)
        texts[name] = text
    texts["mma_peak"] = MMA_PEAK_CU
    procs = {}
    for i, (name, text) in enumerate(texts.items()):
        cu = OUT / f"v{i}.cu"
        cu.write_text(text)
        procs[name] = (cu.with_suffix(".so"), subprocess.Popen(
            [native.nvcc_path(), *native.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
        regs, kernel = [], None
        for line in log.splitlines():
            if "Compiling entry" in line:
                kernel = next((k for k in ("fwd_kernel", "dkdv_kernel", "dq_kernel")
                               if k in line and "ILi64E" in line), None)
            elif kernel and "spill" in line:
                spill = line.split(",")[1].strip()
            elif kernel and "registers" in line:
                regs.append(f"{kernel} {line.split('Used ')[1].split(' ')[0]} regs, {spill}")
                kernel = None
        if regs:
            print(f"[build] {name}: " + "; ".join(regs), flush=True)
    return libs


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vit_reranking_tpu_torch.ops.attention import kv_resident_attention_plain

    if not torch.cuda.is_available():
        print("chip_k3_variants: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build_all()
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def fwd(lib, q, k, v, scale):
        BH, T, D = q.shape
        o, lse = torch.empty_like(q), torch.empty(BH, T, device="cuda")
        lib.kv_attention_fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p]
        native.check(lib.kv_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                          lse.data_ptr(), BH, T, k.shape[1], D, scale, stream()),
                     "kv_attention_fwd")
        return o, lse

    def bwd(lib, q, k, v, o, lse, do, scale):
        BH, T, D = q.shape
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        delta = torch.empty_like(lse)
        lib.kv_attention_bwd.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p]
        native.check(lib.kv_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), BH, T, k.shape[1], D,
            scale, stream()), "kv_attention_bwd")
        return dq, dk, dv

    def ms(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    BH, T, Tkv, D = 112, 3136, 784, 64
    scale = D ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, do = (torch.randn(BH, T, D, device="cuda", generator=gen) for _ in range(2))
    k, v = (torch.randn(BH, Tkv, D, device="cuda", generator=gen) for _ in range(2))
    rq, rk, rv = (t.clone().requires_grad_() for t in (q, k, v))
    ref = kv_resident_attention_plain(rq, rk, rv, scale)
    ref_grads = torch.autograd.grad(ref, (rq, rk, rv), do)
    ref = ref.detach()
    del rq, rk, rv
    k3 = [name for name in libs if name != "mma_peak"]
    for name in k3:
        o, lse = fwd(libs[name], q, k, v, scale)
        grads = bwd(libs[name], q, k, v, o, lse, do, scale)
        again = bwd(libs[name], q, k, v, o, lse, do, scale)
        torch.cuda.synchronize()
        rel = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(grads, ref_grads))
        same = all(torch.equal(a, b) for a, b in zip(grads, again))
        print(f"[check] {name}: fwd max_abs_err={float((o - ref).abs().max()):.3e} "
              f"grad rel_err={rel:.3e} same_bits_twice={same}", flush=True)
    del ref, ref_grads

    times = {name: [] for name in k3}
    for name in k3 + k3[::-1]:
        lib = libs[name]
        o, lse = fwd(lib, q, k, v, scale)
        times[name].append((ms(lambda: fwd(lib, q, k, v, scale)),
                            ms(lambda: bwd(lib, q, k, v, o, lse, do, scale))))
    # the tensor cores' work: 3 TF32 products for each f32 product, 2 flop a multiply-add
    macs = T * Tkv * D * BH
    products = {"fwd_kernel": 2, "dkdv_kernel": 4, "dq_kernel": 3}
    for name in k3:
        lib = libs[name]
        o, lse = fwd(lib, q, k, v, scale)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fwd(lib, q, k, v, scale)
                bwd(lib, q, k, v, o, lse, do, scale)
            torch.cuda.synchronize()
        per = {}
        for e in prof.key_averages():
            for kern in ("fwd_kernel", "delta_kernel", "dkdv_kernel", "dq_kernel"):
                if kern in e.key:
                    per[kern] = e.device_time_total / 3 / 1e3
        rates = " ".join(f"{kern} {per[kern]:.4f} ms = {3 * 2 * n * macs / per[kern] / 1e9:.1f} "
                         f"TF32 TFLOP/s" for kern, n in products.items() if kern in per)
        print(f"[time] {name}: fwd ms " + " ".join(f"{f:.4f}" for f, _ in times[name])
              + "; bwd ms " + " ".join(f"{b:.4f}" for _, b in times[name]) + f"; {rates}",
              flush=True)

    lib = libs["mma_peak"]
    lib.mma_peak_launch.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for warps in (4, 8, 16):
        blocks, iters = sms * 4, 2048
        out = torch.empty(blocks * 32 * warps, device="cuda")
        t = ms(lambda: native.check(lib.mma_peak_launch(out.data_ptr(), blocks, 32 * warps, iters,
                                                        stream()), "mma_peak"), reps=5)
        flop = blocks * warps * iters * 8 * 2 * 16 * 8 * 8
        print(f"[mma.sync tf32 m16n8k8] {warps} warps a block, {blocks} blocks: "
              f"{flop / t / 1e9:.1f} TFLOP/s", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
