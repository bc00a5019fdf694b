"""Kernel K4 (vit_reranking_tpu_torch/csrc/swin_attention.cu) against variants
of itself on one NVIDIA card; then its bf16 form
(vit_reranking_tpu_torch/csrc/swin_attention_bf16.cu) against its variants
and the earlier bf16 design.

Each variant is the kept source with a few lines replaced (``VARIANTS``): one
design choice undone.  With ``--earlier DIR`` (the root of another checkout of
the repository, e.g. an earlier commit unpacked with ``git archive``), that
tree's swin_attention.cu is built too, as "earlier"; its C entries take
contiguous (G, nW, T, D) operands and no strides.  Everything is built at once
with the port's nvcc flags into build/k4_variants/, checked against the plain
versions (forward max abs error and gradients relative to their largest
magnitude, printed for every library; the kept one and the earlier one must
meet 1e-5 and 1e-4) and timed by CUDA events in turns (kept, the others, the
others reversed, kept) at Swin-T's stage-0 and stage-2 shapes at batch 112
(T=49, D=32, the shifted-window masks): the batched contract's forward and
backward on contiguous operands, every library; the model's layout (q, k, v
read from one (B nW, T, 3C) projection, o written as (B nW, T, C)), the kept
library and its variants; and the kept library with other numbers of images a
block (``TARGET_BLOCKS``).

The bf16 section does the same for the bf16 form (``BF16_VARIANTS``, each a
design choice undone: cp.async tile loads by every thread against TMA, a
stage of images' tiles in flight fewer and one more than 2 forward and 3
backward, a block (warpgroup) fewer
and one more an SM than 3 forward and 2 backward, a block a unit against the
persistent grid, 4-byte stores from registers against staged TMA stores,
units with the window fastest against the head fastest) and, with ``--earlier DIR``, DIR's
bf16 core (the bf16 section of its swin_attention.cu: the earlier mma.sync
m16n8k16 design, a block per (window, head, run) with ``TARGET_BLOCKS``).
Each library gets the runs of images its wrapper would pick
(``_persistent_runs`` with the library's own slots, or ``_runs``).  Checked
in bf16 against the bf16 plain version (forward within 1e-2 and gradients
within 2e-2 of their largest magnitude; the kept and the earlier core must
meet them) and timed in turns at stages 0 and 2, contiguous and qkv layouts.
The routes that lost (cp.async loads, register stores, a block a unit) are
not in the kept source: ``BF16_VARIANTS`` holds them as edits of its text.

The entry section times what the model calls, ops/swin_attention.py's
``swin_attention_qkv`` with the packed contract (K4a, the default), forward
and backward, f32 and bf16, at stages 0 and 2: the call's CUDA-event time
over back-to-back calls (the host's work included) in a fresh process for
this tree and, with ``--earlier DIR``, for DIR's package, in the turns
earlier, this, this, earlier (each tree builds its own kernels first).

    python3 chip_k4_variants.py [--section f32|bf16|entry|all] [--earlier DIR]
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs
from chip_k1k2_variants import in_turns
from vit_reranking_tpu_torch.ops import native

OUT = native.BUILD_DIR.parent / "k4_variants"
KEPT = "kept"
EARLIER = "earlier"
VARIANTS = {
    "one TF32 product": [(
        "  mma_tf32(small, a.lo, b.hi[0], b.hi[1]);\n  mma_tf32(small, a.hi, b.lo[0], b.lo[1]);\n",
        "")],
    "one accumulator chain": [(
        "  mma_tf32(small, a.lo, b.hi[0], b.hi[1]);\n  mma_tf32(small, a.hi, b.lo[0], b.lo[1]);\n",
        "  mma_tf32(big, a.lo, b.hi[0], b.hi[1]);\n  mma_tf32(big, a.hi, b.lo[0], b.lo[1]);\n")],
    "64 x 64 tiles": [(
        "if (T <= 56) return by_dp(std::integral_constant<int, 7>{});",
        "if (T <= 56) return by_dp(std::integral_constant<int, 8>{});")],
    "forward, one image at a time": [
        ("constexpr int kFwdStages = 2;", "constexpr int kFwdStages = 1;")],
    "forward 3 stages": [("constexpr int kFwdStages = 2;", "constexpr int kFwdStages = 3;")],
    "copies with a 256-byte L2 prefetch": [(
        "cp.async.cg.shared.global [%0], [%1], 16, %2;",
        "cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;")],
    "backward, 2 stages, 2 blocks an SM": [
        ("constexpr int kBwdStages = 1;", "constexpr int kBwdStages = 2;"),
        ("__launch_bounds__(32 * kWarpsOf<NC>, DP <= 32 ? 3 : 1)",
         "__launch_bounds__(32 * kWarpsOf<NC>, DP <= 32 ? 2 : 1)")],
    "forward at 3 blocks an SM": [(
        "__launch_bounds__(32 * kWarpsOf<NC>, DP <= 32 ? 4 : 2)",
        "__launch_bounds__(32 * kWarpsOf<NC>, DP <= 32 ? 3 : 2)")],
}
TARGETS = (528, 1056, 2112, 4224)  # blocks a launch aims for

# The routes that lost, kept here as edits of the kept bf16 source (which
# has only the winning ones): the kernels reach the operands through
# pointers and strides in Maps, set by the host beside the tensor maps.
_POINTERS = [
    ("  CUtensorMap out[3];  // o (or dq, dk, dv)\n};",
     "  CUtensorMap out[3];  // o (or dq, dk, dv)\n"
     "  const bf16* ptr[4];  // q, k, v, dO with their strides\n  Layout lay[4];\n"
     "  bf16* optr[3];  // o (or dq, dk, dv) with their strides\n  Layout olay;\n  int T, D;\n};"),
    ("  const Order oin = order_of(in), oout = order_of(out);\n",
     "  const Order oin = order_of(in), oout = order_of(out);\n"
     "  maps.ptr[0] = q, maps.ptr[1] = k, maps.ptr[2] = v, maps.lay[0] = maps.lay[1] =\n"
     "      maps.lay[2] = in, maps.optr[0] = o, maps.olay = out, maps.T = g.T, maps.D = g.D;\n"),
    ("  const Order oin = order_of(in), odo = order_of(dol), ograd = order_of(gl);\n",
     "  const Order oin = order_of(in), odo = order_of(dol), ograd = order_of(gl);\n"
     "  maps.ptr[0] = q, maps.ptr[1] = k, maps.ptr[2] = v, maps.ptr[3] = dout;\n"
     "  maps.lay[0] = maps.lay[1] = maps.lay[2] = in, maps.lay[3] = dol;\n"
     "  maps.optr[0] = dq, maps.optr[1] = dk, maps.optr[2] = dv, maps.olay = gl;\n"
     "  maps.T = g.T, maps.D = g.D;\n"),
]
# Every thread copies (h, w, b)'s rows into the stage's swizzled tiles in
# 16-byte cp.async pieces (zeros past row T and dim D) and arrives on the
# stage's barrier when its copies land; the async proxy then reads them.
_CP_ASYNC = [
    ("// ---- wgmma ----", r"""template <int DP>
__device__ __forceinline__ void cp_tile(uint8_t* dst, const bf16* __restrict__ g, const Layout& l,
                                        int h, int w, int b, int T, int D) {
  constexpr int C = DP / 8;
  const bf16* base = g + b * l.b + w * l.w + h * l.h;
  for (int e = threadIdx.x; e < kRows * C; e += kThreads) {
    const int r = e / C, c = e % C;
    const bool ok = r < T && 8 * c < D;
    const bf16* src = ok ? base + r * l.t + 8 * c : g;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                     smem_u32(dst + swz<Tile<DP>::kMask>(r * Tile<DP>::kRowBytes + 16 * c))),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// ---- wgmma ----"""),
    ("""    if (threadIdx.x == 0) {
      mbar_expect_tx(full, kIn * kTile);
      for (int x = 0; x < kIn; ++x)
        tma_load(st + x * kTile, &maps.in[x], x == 3 ? odo : oin, full, h, w, b);
    }
""", """    for (int x = 0; x < kIn; ++x)
      cp_tile<DP>(st + x * kTile, maps.ptr[x], maps.lay[x], h, w, b, maps.T, maps.D);
    cp_arrive(full);
"""),
    ("mbar_init(full + s, 1);", "mbar_init(full + s, kThreads);"),
    ("      mbar_wait(full + s, (i / S) & 1);\n",
     "      mbar_wait(full + s, (i / S) & 1);\n      fence_async();\n"),
]
# 4-byte stores of the accumulators' bf16 pairs to the rows < T and dims <
# D, straight from registers (the staging tiles stay allocated, unused).
_REGISTER_STORES = [
    ("// ---- the block ----", r"""template <int DP>
__device__ __forceinline__ void store_rows(bf16* __restrict__ out, long long st,
                                           const float (&acc)[DP / 2], float mul, int row, int T,
                                           int D, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row + 8 * h >= T) continue;
    bf16* p = out + (row + 8 * h) * st + 2 * t;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      if (8 * j < D)
        *reinterpret_cast<uint32_t*>(p + 8 * j) =
            pack(acc[4 * j + 2 * h] * mul, acc[4 * j + 2 * h + 1] * mul);
  }
}

// ---- the block ----"""),
    ("      if (threadIdx.x == 0) bulk_wait_read<1>();  // this tile's store two images ago\n", ""),
    ("""      uint8_t* tile = staging + (i & 1) * kTile;
      stage<DP>(tile, acc, 1.0f, row, t);
      fence_async();
      __syncthreads();
      if (threadIdx.x == 0) {
        tma_store(&maps.out[0], oout, tile, h, w, b);
        bulk_commit();
      }
""", """      store_rows<DP>(maps.optr[0] + b * maps.olay.b + w * maps.olay.w + h * maps.olay.h,
                     maps.olay.t, acc, 1.0f, row, geo.T, geo.D, t);
"""),
    ("      if (threadIdx.x == 0) bulk_wait_read<1>();  // these staging tiles' stores\n", ""),
    ("""      uint8_t* tiles = staging + (i & 1) * 3 * kTile;
      stage<DP>(tiles, gq, geo.scale, row, t);
      stage<DP>(tiles + kTile, gk, geo.scale, row, t);
      stage<DP>(tiles + 2 * kTile, gv, 1.0f, row, t);
      fence_async();
      __syncthreads();  // the stage is read (and the staging tiles written)
      loads.issue(ring + s * 4 * kTile, full + s);
      if (threadIdx.x == 0) {
        for (int x = 0; x < 3; ++x) tma_store(&maps.out[x], ograd, tiles + x * kTile, h, w, b);
        bulk_commit();
      }
""", """      __syncthreads();  // the stage is read
      loads.issue(ring + s * 4 * kTile, full + s);
      const Layout& l = maps.olay;
      const long long at = b * l.b + w * l.w + h * l.h;
      store_rows<DP>(maps.optr[0] + at, l.t, gq, geo.scale, row, geo.T, geo.D, t);
      store_rows<DP>(maps.optr[1] + at, l.t, gk, geo.scale, row, geo.T, geo.D, t);
      store_rows<DP>(maps.optr[2] + at, l.t, gv, 1.0f, row, geo.T, geo.D, t);
"""),
]
BF16_VARIANTS = {
    "cp.async tile loads": _POINTERS + _CP_ASYNC,
    "a stage fewer (1, 2)": [("constexpr int kFwdStages = 2;", "constexpr int kFwdStages = 1;"),
                             ("constexpr int kBwdStages = 3;", "constexpr int kBwdStages = 2;")],
    "a stage more (3, 4)": [("constexpr int kFwdStages = 2;", "constexpr int kFwdStages = 3;"),
                            ("constexpr int kBwdStages = 3;", "constexpr int kBwdStages = 4;")],
    "a block fewer an SM (2, 1)": [
        ("constexpr int kFwdBlocksPerSm = 3;", "constexpr int kFwdBlocksPerSm = 2;"),
        ("constexpr int kBwdBlocksPerSm = 2;", "constexpr int kBwdBlocksPerSm = 1;")],
    "a block more an SM (4, 3; 2 stages)": [
        ("constexpr int kFwdBlocksPerSm = 3;", "constexpr int kFwdBlocksPerSm = 4;"),
        ("constexpr int kBwdBlocksPerSm = 2;", "constexpr int kBwdBlocksPerSm = 3;"),
        ("constexpr int kBwdStages = 3;", "constexpr int kBwdStages = 2;")],
    "a block a unit": [("return (unsigned)std::min(units, slots);", "return (unsigned)units;")],
    "register stores": _POINTERS + _REGISTER_STORES,
    "units window fastest": [("    h = u % H;\n    w = (u / H) % nW;",
                              "    w = u % nW;\n    h = (u / nW) % H;")],
}


def build_all(earlier, source="swin_attention", variants=VARIANTS, prefix="v"):
    """One nvcc per library (``source``.cu, it with each of ``variants``,
    and the earlier tree's swin_attention.cu), all started together; returns
    {name: CDLL}."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = (native.CSRC / f"{source}.cu").read_text()
    texts = {KEPT: src}
    for name, edits in variants.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name!r}: {old!r} is not in {source}.cu")
            text = text.replace(old, new)
        texts[name] = text
    if earlier is not None:
        texts[EARLIER] = (
            Path(earlier) / "vit_reranking_tpu_torch" / "csrc" / "swin_attention.cu").read_text()
    procs = {}
    for i, (name, text) in enumerate(texts.items()):
        cu = OUT / f"{prefix}{i}.cu"
        cu.write_text(text)
        procs[name] = (cu.with_suffix(".so"), subprocess.Popen(
            [native.nvcc_path(), *native.NVCC_FLAGS, "-I", str(native.CSRC), "-o",
             str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        res = [line.split("Used ")[1].split(",")[0] for line in log.splitlines()
               if "Used" in line and "registers" in line]
        res += [line.strip()[:200] for line in log.splitlines() if "Performance Loss" in line]
        spills = sorted({line.split(",", 1)[1].strip() for line in log.splitlines()
                         if "spill" in line and " 0 bytes spill stores" not in line})
        print(f"[build] {name}: registers of each kernel instance {res}; spills {spills}",
              flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def entries(lib, strided, suffix=""):
    """The library's forward and backward C entries (``suffix`` "_bf16" for
    the bf16 ones) with their argument types: with strides (this tree's) or
    without (the earlier f32 design)."""
    fwd = getattr(lib, "swin_attention_fwd" + suffix)
    bwd = getattr(lib, "swin_attention_bwd" + suffix)
    tail = [*[ctypes.c_int] * 6, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    s = [ctypes.c_void_p] if strided else []
    fwd.argtypes = [*[ctypes.c_void_p] * 6, *s, *tail]
    bwd.argtypes = [*[ctypes.c_void_p] * 11, ctypes.c_int, *s, *tail]
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


class Problem:
    """A batched-contract call at one stage: bias (H, T, T) and mask, the
    operands in one of two layouts, buffers for the outputs, and calls of a
    library's forward and backward on them."""

    def __init__(self, torch, B, nW, H, T, D, res, layout, gen, dtype=None):
        from vit_reranking_tpu_torch.models.swin import _shift_attn_mask
        from vit_reranking_tpu_torch.ops import swin_attention as swa

        self.torch, self.swa = torch, swa
        self.B, self.nW, self.H, self.T, self.D = B, nW, H, T, D
        self.scale = D ** -0.5
        self.bias = torch.randn(H, T, T, device="cuda", generator=gen)
        self.mask = torch.from_numpy(_shift_attn_mask(res, res, 7, 3)).cuda()
        G, Bw, C = H * B, B * nW, H * D
        self.layout = layout
        dtype = dtype or torch.float32
        if layout == "contiguous":
            self.q, self.k, self.v, self.do = (
                torch.randn(G, nW, T, D, device="cuda", generator=gen).to(dtype)
                for _ in range(4))
            self.o, self.dq, self.dk, self.dv = (torch.empty_like(self.q) for _ in range(4))
            views = lambda *ts: [swa._heads_slowest(t, H) for t in ts]
            self.vq, self.vk, self.vv, self.vdo = views(self.q, self.k, self.v, self.do)
            self.vo, self.vdq, self.vdk, self.vdv = views(self.o, self.dq, self.dk, self.dv)
        else:  # the model's qkv projection and proj's input
            self.qkv = torch.randn(Bw, T, 3 * C, device="cuda", generator=gen).to(dtype)
            self.do = torch.randn(Bw, T, C, device="cuda", generator=gen).to(dtype)
            self.o = torch.empty(Bw, T, C, device="cuda", dtype=dtype)
            self.dqkv = torch.empty_like(self.qkv)
            self.vq, self.vk, self.vv = swa._qkv_views(self.qkv, nW, H)
            self.vdq, self.vdk, self.vdv = swa._qkv_views(self.dqkv, nW, H)
            self.vo, self.vdo = swa._tokens_view(self.o, nW, H), swa._tokens_view(self.do, nW, H)
        self.dbias = torch.empty(H, T, T, device="cuda")
        self.part = torch.empty(B * H * nW * T * T, device="cuda")  # room for one image a run

    def target_runs(self, target):
        """(chunk, runs) as _runs picks them for ``target`` blocks."""
        saved = self.swa.TARGET_BLOCKS
        self.swa.TARGET_BLOCKS = target
        runs = self.swa._runs(self.B, self.H, self.nW)
        self.swa.TARGET_BLOCKS = saved
        return runs

    def dims(self, runs):
        return [self.B, self.H, self.nW, self.T, self.D, 1, self.T * self.T, 0, self.T, *runs,
                self.scale]

    def calls(self, lib, strided, target=None, suffix="", runs=None):
        """Forward and backward calls of ``lib``'s entries on this problem,
        with the (chunk, runs) of ``target`` blocks or ``runs`` (forward,
        backward)."""
        fwd, bwd = entries(lib, strided, suffix)
        fwd_runs, bwd_runs = runs or (self.target_runs(target),) * 2
        dims, bdims = self.dims(fwd_runs), self.dims(bwd_runs)
        stream = self.torch.cuda.current_stream().cuda_stream
        p = lambda t: t.data_ptr()
        fs = [self.swa._strides((self.vq, self.vk, self.vv), (self.vo,))] if strided else []
        bs = ([self.swa._strides((self.vq, self.vk, self.vv), (self.vdo,),
                                 (self.vdq, self.vdk, self.vdv))] if strided else [])

        def run_fwd():
            native.check(fwd(p(self.vq), p(self.vk), p(self.vv), p(self.bias), p(self.mask),
                             p(self.vo), *fs, *dims, stream), "fwd")

        def run_bwd():
            native.check(bwd(p(self.vq), p(self.vk), p(self.vv), p(self.bias), p(self.mask),
                             p(self.vdo), p(self.vdq), p(self.vdk), p(self.vdv), p(self.part),
                             p(self.dbias), 0, *bs, *bdims, stream), "bwd")

        return run_fwd, run_bwd

    def errors(self, run_fwd, run_bwd):
        """Forward max abs error and each gradient's error relative to its
        largest magnitude, against autograd through the plain version."""
        torch, swa = self.torch, self.swa
        q, k, v, do = (t.permute(2, 0, 1, 3, 4).reshape(self.H * self.B, self.nW, self.T,
                                                         self.D)
                       for t in (self.vq, self.vk, self.vv, self.vdo))
        leaves = [t.clone().requires_grad_() for t in (q, k, v, self.bias)]
        ref = swa.swin_window_attention_plain(*leaves, self.mask, self.scale)
        ref_grads = torch.autograd.grad(ref, leaves, do)
        ref = ref.detach()
        run_fwd()
        run_bwd()
        torch.cuda.synchronize()
        back = lambda t: t.permute(2, 0, 1, 3, 4).reshape(ref.shape)
        got = (back(self.vdq), back(self.vdk), back(self.vdv), self.dbias)
        rel = [cs.rel_err(a, b) for a, b in zip(got, ref_grads)]
        if ref.dtype == torch.bfloat16:  # of the largest magnitude, as chip_smoke.py
            return cs.rel_err(back(self.vo), ref), max(rel)
        return float((back(self.vo) - ref).abs().max()), max(rel)


def f32_section(torch, earlier):
    libs = build_all(earlier)
    from vit_reranking_tpu_torch.ops import swin_attention as swa

    kept_target = swa.TARGET_BLOCKS
    gen = torch.Generator(device="cuda").manual_seed(4)
    for stage, nW, H, res in (("stage 0", 64, 3, 56), ("stage 2", 4, 12, 14)):
        for layout in ("contiguous", "qkv"):
            prob = Problem(torch, 112, nW, H, 49, 32, res, layout, gen)
            tag = f"K4 {stage} {layout}"
            calls = {}
            for name, lib in libs.items():
                if name == EARLIER and layout != "contiguous":
                    continue
                calls[name] = prob.calls(lib, name != EARLIER, kept_target)
            if layout == "qkv":
                for target in TARGETS:
                    if target != kept_target:
                        calls[f"kept, {target} target blocks"] = prob.calls(libs[KEPT], True,
                                                                            target)
            for name, (f, b) in calls.items():
                err, rel = prob.errors(f, b)
                print(f"[{tag}] {name:32s} fwd max_abs_err={err:.3e} grad rel_err={rel:.3e}",
                      flush=True)
                if name in (KEPT, EARLIER) and not (err <= cs.K4_FWD_TOL
                                                    and rel <= cs.K4_GRAD_RTOL):
                    raise SystemExit(f"{tag} {name} disagrees with the plain version")
            in_turns(torch, f"{tag} fwd", {n: f for n, (f, _) in calls.items()}, reps=10)
            in_turns(torch, f"{tag} bwd", {n: b for n, (_, b) in calls.items()}, reps=10)
            del prob, calls
            torch.cuda.empty_cache()


def slots(lib, D, backward):
    """The blocks a bf16 library's kernel runs at once (its C query)."""
    fn = lib.swin_attention_bf16_slots
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    out = ctypes.c_int(0)
    native.check(fn(D, int(backward), ctypes.addressof(out)), "swin_attention_bf16_slots")
    return out.value


def bf16_section(torch, earlier):
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    libs = build_all(earlier, "swin_attention_bf16", BF16_VARIANTS, "b")
    from vit_reranking_tpu_torch.ops import swin_attention as swa

    gen = torch.Generator(device="cuda").manual_seed(14)
    for stage, nW, H, res in (("stage 0", 64, 3, 56), ("stage 2", 4, 12, 14)):
        B, T, D = 112, 49, 32
        for layout in ("contiguous", "qkv"):
            prob = Problem(torch, B, nW, H, T, D, res, layout, gen, torch.bfloat16)
            tag = f"K4 bf16 {stage} {layout}"
            calls = {}
            for name, lib in libs.items():
                if name == EARLIER:
                    runs = (swa._runs(B, H, nW),) * 2
                else:
                    runs = tuple(swa._persistent_runs(B, H, nW, slots(lib, D, bwd))
                                 for bwd in (False, True))
                calls[name] = prob.calls(lib, True, suffix="_bf16", runs=runs)
                if name in (KEPT, EARLIER):
                    print(f"[{tag}] {name}: (chunk, runs) forward {runs[0]}, backward {runs[1]}",
                          flush=True)
            for name, (f, b) in calls.items():
                err, rel = prob.errors(f, b)
                print(f"[{tag}] {name:32s} fwd rel_err={err:.3e} grad rel_err={rel:.3e}",
                      flush=True)
                if name in (KEPT, EARLIER) and not (err <= cs.BF16_FWD_TOL
                                                    and rel <= cs.BF16_GRAD_TOL):
                    raise SystemExit(f"{tag} {name} disagrees with the plain version")
            if layout == "contiguous":  # the yardstick, on the same windows
                G = H * B
                q4, k4, v4, do4 = (t.view(G * nW, 1, T, D) for t in (prob.q, prob.k, prob.v,
                                                                      prob.do))
                full = (prob.bias.repeat_interleave(B, dim=0)[:, None] + prob.mask[None]).view(
                    G * nW, 1, T, T).bfloat16()
                backend = cs.sdpa_backend(q4[:8], k4[:8], v4[:8], attn_mask=full[:8])
                leaves = [t.clone().requires_grad_() for t in (q4, k4, v4)]
                with sdpa_kernel([backend]):
                    o4 = F.scaled_dot_product_attention(*leaves, attn_mask=full,
                                                        scale=prob.scale)
                    sdpa = (lambda: F.scaled_dot_product_attention(
                                q4, k4, v4, attn_mask=full, scale=prob.scale),
                            lambda: torch.autograd.grad(o4, leaves, do4, retain_graph=True))
                    sdpa_f = cs.cuda_ms(torch, sdpa[0], reps=10)
                    sdpa_b = cs.cuda_ms(torch, sdpa[1], reps=10)
                print(f"[{tag}] sdpa ({backend.name}, float mask) fwd {sdpa_f:.4f} ms, "
                      f"bwd {sdpa_b:.4f} ms", flush=True)
                del leaves, o4, full
            in_turns(torch, f"{tag} fwd", {n: f for n, (f, _) in calls.items()}, reps=10)
            in_turns(torch, f"{tag} bwd", {n: b for n, (_, b) in calls.items()}, reps=10)
            del prob, calls
            torch.cuda.empty_cache()


# Run in the root of a tree: its qkv entry's call times, as one JSON line.
ENTRY_TIMES = r"""
import json, sys, torch
sys.path.insert(0, ".")
from vit_reranking_tpu_torch.models.swin import _shift_attn_mask
from vit_reranking_tpu_torch.ops import swin_attention as swa

swa.SWIN_KERNEL_PACKED = True
torch.backends.cuda.matmul.allow_tf32 = False

def ms(fn, reps=50):
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps

gen = torch.Generator(device="cuda").manual_seed(0)
B, T, D, out = 112, 49, 32, {}
for stage, nW, H, res in (("stage 0", 64, 3, 56), ("stage 2", 4, 12, 14)):
    for dtype in (torch.float32, torch.bfloat16):
        Bw, C, scale = B * nW, H * D, D ** -0.5
        qkv = torch.randn(Bw, T, 3 * C, device="cuda", generator=gen).to(dtype)
        dout = torch.randn(Bw, T, C, device="cuda", generator=gen).to(dtype)
        bias = torch.randn(H, T, T, device="cuda", generator=gen)
        mask = torch.from_numpy(_shift_attn_mask(res, res, 7, 3)).cuda()
        leaves = [qkv.clone().requires_grad_(), bias.clone().requires_grad_()]
        o = swa.swin_attention_qkv(*leaves, mask, scale, H, n_windows=nW)
        with torch.no_grad():
            fwd = ms(lambda: swa.swin_attention_qkv(qkv, bias, mask, scale, H, n_windows=nW))
        bwd = ms(lambda: torch.autograd.grad(o, leaves, dout, retain_graph=True))
        out[f"{stage} {str(dtype)[6:]}"] = [fwd, bwd]
print(json.dumps(out))
"""


def entry_section(earlier):
    """The qkv entry's call times, this tree's and ``earlier``'s, in turns
    of fresh processes."""
    trees = {"this": Path(__file__).resolve().parent}
    if earlier is not None:
        trees[EARLIER] = Path(earlier).resolve()
    order = ([EARLIER, "this", "this", EARLIER] if earlier is not None else ["this", "this"])
    times = {name: [] for name in trees}
    for name in order:
        run = subprocess.run([sys.executable, "-c", ENTRY_TIMES], cwd=trees[name],
                             capture_output=True, text=True)
        if run.returncode != 0:
            raise SystemExit(f"entry times failed for {name}:\n{run.stderr[-3000:]}")
        got = json.loads(run.stdout.strip().splitlines()[-1])
        times[name].append(got)
        print(f"[K4 qkv entry, {name}] call ms forward / backward: "
              + ", ".join(f"{k} {f:.4f} / {b:.4f}" for k, (f, b) in got.items()), flush=True)
    for name, runs in times.items():
        print(f"[K4 qkv entry, {name}, mean of {len(runs)} turns] call ms forward / backward: "
              + ", ".join(f"{k} {sum(r[k][0] for r in runs) / len(runs):.4f} / "
                          f"{sum(r[k][1] for r in runs) / len(runs):.4f}" for k in runs[0]),
              flush=True)


def main():
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--section", choices=("all", "f32", "bf16", "entry"), default="all")
    parser.add_argument("--earlier", default=None,
                        help="root of another checkout whose swin_attention.cu (and, in the "
                        "entry section, whose package) is timed too")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_k4_variants: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[host] card: {cs.gpu_name_and_limit()}", flush=True)
    if args.section in ("all", "f32"):
        f32_section(torch, args.earlier)
    if args.section in ("all", "bf16"):
        bf16_section(torch, args.earlier)
    if args.section in ("all", "entry"):
        entry_section(args.earlier)
    print(cs.gpu_name_and_limit(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
