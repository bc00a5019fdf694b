"""Kernel K4 (vit_reranking_tpu_torch/csrc/swin_attention.cu) against variants
of itself on one NVIDIA card.

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

    python3 chip_k4_variants.py [--earlier DIR]
"""

import argparse
import ctypes
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


def build_all(earlier):
    """One nvcc per library, all started together; returns {name: CDLL}."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = (native.CSRC / "swin_attention.cu").read_text()
    texts = {KEPT: src}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name!r}: {old!r} is not in swin_attention.cu")
            text = text.replace(old, new)
        texts[name] = text
    if earlier is not None:
        texts[EARLIER] = (
            Path(earlier) / "vit_reranking_tpu_torch" / "csrc" / "swin_attention.cu").read_text()
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
        res = [line.split("Used ")[1].split(",")[0] for line in log.splitlines()
               if "Used" in line and "registers" in line]
        spills = sorted({line.split(",", 1)[1].strip() for line in log.splitlines()
                         if "spill" in line and " 0 bytes spill stores" not in line})
        print(f"[build] {name}: registers of each kernel instance {res}; spills {spills}",
              flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def entries(lib, strided):
    """The library's forward and backward C entries with their argument
    types: with strides (this tree's) or without (the earlier design)."""
    fwd, bwd = lib.swin_attention_fwd, lib.swin_attention_bwd
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

    def __init__(self, torch, B, nW, H, T, D, res, layout, gen):
        from vit_reranking_tpu_torch.models.swin import _shift_attn_mask
        from vit_reranking_tpu_torch.ops import swin_attention as swa

        self.torch, self.swa = torch, swa
        self.B, self.nW, self.H, self.T, self.D = B, nW, H, T, D
        self.scale = D ** -0.5
        self.bias = torch.randn(H, T, T, device="cuda", generator=gen)
        self.mask = torch.from_numpy(_shift_attn_mask(res, res, 7, 3)).cuda()
        G, Bw, C = H * B, B * nW, H * D
        self.layout = layout
        if layout == "contiguous":
            self.q, self.k, self.v, self.do = (
                torch.randn(G, nW, T, D, device="cuda", generator=gen) for _ in range(4))
            self.o, self.dq, self.dk, self.dv = (torch.empty_like(self.q) for _ in range(4))
            views = lambda *ts: [swa._heads_slowest(t, H) for t in ts]
            self.vq, self.vk, self.vv, self.vdo = views(self.q, self.k, self.v, self.do)
            self.vo, self.vdq, self.vdk, self.vdv = views(self.o, self.dq, self.dk, self.dv)
        else:  # the model's qkv projection and proj's input
            self.qkv = torch.randn(Bw, T, 3 * C, device="cuda", generator=gen)
            self.do = torch.randn(Bw, T, C, device="cuda", generator=gen)
            self.o = torch.empty(Bw, T, C, device="cuda")
            self.dqkv = torch.empty_like(self.qkv)
            self.vq, self.vk, self.vv = swa._qkv_views(self.qkv, nW, H)
            self.vdq, self.vdk, self.vdv = swa._qkv_views(self.dqkv, nW, H)
            self.vo, self.vdo = swa._tokens_view(self.o, nW, H), swa._tokens_view(self.do, nW, H)
        self.dbias = torch.empty(H, T, T, device="cuda")
        self.part = torch.empty(B * H * nW * T * T, device="cuda")  # room for one image a run

    def dims(self, target):
        saved = self.swa.TARGET_BLOCKS
        self.swa.TARGET_BLOCKS = target
        chunk, runs = self.swa._runs(self.B, self.H, self.nW)
        self.swa.TARGET_BLOCKS = saved
        return [self.B, self.H, self.nW, self.T, self.D, 1, self.T * self.T, 0, self.T, chunk,
                runs, self.scale]

    def calls(self, lib, strided, target):
        fwd, bwd = entries(lib, strided)
        dims = self.dims(target)
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
                             p(self.dbias), 0, *bs, *dims, stream), "bwd")

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
        err = float((back(self.vo) - ref).abs().max())
        got = (back(self.vdq), back(self.vdk), back(self.vdv), self.dbias)
        rel = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(got, ref_grads)]
        return err, max(rel)


def main():
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--earlier", default=None,
                        help="root of another checkout whose swin_attention.cu is timed too")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_k4_variants: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[host] card: {cs.gpu_name_and_limit()}", flush=True)
    libs = build_all(args.earlier)
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
    print(cs.gpu_name_and_limit(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
