"""Kernels K1 (vit_reranking_tpu_torch/csrc/sinkhorn_score.cu) and K2
(csrc/filter_threshold.cu) against variants of themselves on one NVIDIA card.

Each variant is the kept source with a few lines replaced (``VARIANTS``): one
design choice undone.  With ``--earlier DIR`` (the root of another checkout of
the repository, e.g. an earlier commit unpacked with ``git archive``), that
tree's two sources are built too, as "earlier".  Everything is built at once
with the port's nvcc flags into build/k1k2_variants/, checked against the
plain versions (K1 within 1e-5 with identical rankings, K2 bit for bit) and
timed by CUDA events in turns (kept, the others, the others reversed, kept)
at the main paths' shapes: K2 on CvT-13's stage-0 and stage-1 maps at batch
32, K1 at R=49 full OT (the CvT eval), R=49 partial OT 0.9 and 0.5 with
group exit at thresholds 1e-1 and 1e-3 (the SOP recipe), and R=196 modes
a, (d) and c (the DeiT-S evals), 128 queries x 100 candidates.  K1's
rankings are checked as chip_smoke.py checks them (``k1_ranks``), and under
group exit every group must also exit at the plain version's iteration.
The earlier tree's K1 is timed whatever its check says (it does not report
its exits); its check is printed.

    python3 chip_k1k2_variants.py [--earlier DIR]
"""

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs
from vit_reranking_tpu_torch.ops import native

OUT = native.BUILD_DIR.parent / "k1k2_variants"
KEPT = "kept"
EARLIER = "earlier"
VARIANTS = {
    "sinkhorn_score": {
        "K1 load batches of 32": [(
            "constexpr int kBatch = 8;", "constexpr int kBatch = 32;")],
        "K1 one row of loads in flight": [(
            "constexpr int kRowsInFlight = 4;", "constexpr int kRowsInFlight = 1;")],
        "K1 block layout unpadded": [
            ("constexpr int kBlockPadMaxRP = 208;", "constexpr int kBlockPadMaxRP = 160;"),
            ("case 13: return launch_block<T, 13, 7, true>",
             "case 13: return launch_block<T, 13, 7, false>")],
        "K1 group: team slots summed by one thread": [(
            "for (int q = threadIdx.x; q < size; q += 32) {",
            "for (int q = 0; q < size && threadIdx.x == 0; ++q) {")],
    },
    "filter_threshold": {
        "K2 four copies of the bins": [
            ("__shared__ unsigned bins[kBins];", "__shared__ unsigned bins[kBins * 4];"),
            ("for (int i = tid; i < kBins; i += kThreads) bins[i] = 0u;",
             "for (int i = tid; i < kBins * 4; i += kThreads) bins[i] = 0u;"),
            ("atomicAdd(&bins[k >> shift_of(0)], 1u);",
             "atomicAdd(&bins[(k >> shift_of(0)) * 4 + (lane & 3)], 1u);"),
            ("atomicAdd(&bins[(k >> shift_of(P)) & (kBins - 1)], 1u);",
             "atomicAdd(&bins[((k >> shift_of(P)) & (kBins - 1)) * 4 + (lane & 3)], 1u);"),
            ("const unsigned n = bins[d];",
             "const unsigned n = bins[4 * d] + bins[4 * d + 1] + bins[4 * d + 2] "
             "+ bins[4 * d + 3];"),
        ],
        "K2 one vector in flight": [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 1;")],
    },
}


def build_all(earlier):
    """One nvcc per source and variant, all started together; returns
    {source: {name: CDLL}}."""
    OUT.mkdir(parents=True, exist_ok=True)
    texts = {}
    for source, variants in VARIANTS.items():
        src = (native.CSRC / f"{source}.cu").read_text()
        texts[(source, KEPT)] = src
        for name, edits in variants.items():
            text = src
            for old, new in edits:
                if old not in text:
                    raise SystemExit(f"variant {name!r}: {old!r} is not in {source}.cu")
                text = text.replace(old, new)
            texts[(source, name)] = text
        if earlier is not None:
            texts[(source, EARLIER)] = (
                Path(earlier) / "vit_reranking_tpu_torch" / "csrc" / f"{source}.cu").read_text()
    procs = {}
    for i, (key, text) in enumerate(texts.items()):
        cu = OUT / f"v{i}.cu"
        cu.write_text(text)
        procs[key] = (cu.with_suffix(".so"), subprocess.Popen(
            [native.nvcc_path(), *native.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {source: {} for source in VARIANTS}
    for (source, name), (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {source} {name}:\n{log}")
        libs[source][name] = ctypes.CDLL(str(so))
    return libs


def k1_call(torch, lib, S, u, v, cost=None, thresh=1e-1, iters=100, ot_part=1.0, group=1,
            earlier=False, iters_out=None):
    """sinkhorn_scores(S, u, v, iters, thresh, ot_part=ot_part, group=group,
    cost=cost) through the library ``lib``; ``earlier`` for a library with
    the earlier entry point (a Km scratch in place of the exit iterations
    and the teams' work array), ``iters_out`` an int32 tensor for the exit
    iterations of each group."""
    fn = lib.sinkhorn_score_launch
    fn.restype = ctypes.c_int
    ints, floats, ptr = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    head = [ptr, ptr, ints, ptr, ptr, ptr] + ([ptr] if earlier else [ptr, ptr])
    fn.argtypes = head + [ints, ints, ints, floats, floats, ints, floats, ints, ptr]
    P, R, _ = S.shape
    partial = ot_part <= 0.999
    RP = R + int(partial)
    out = torch.empty(P, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    if earlier:
        scratch = torch.empty(P * 2 * RP * (RP | 1) if group > 1 else 0, device="cuda")
        mid = [scratch.data_ptr() if group > 1 else None]
    else:
        work = torch.zeros(2 * P if group > 1 else 0, dtype=torch.int64, device="cuda")
        mid = [None if iters_out is None else iters_out.data_ptr(),
               work.data_ptr() if group > 1 else None]

    def run():
        if not earlier and group > 1:
            work.zero_()  # the teams' slots start at 0, as the wrapper's fresh zeros
        native.check(fn(S.data_ptr(), None if cost is None else cost.data_ptr(),
                        int(S.dtype == torch.bfloat16), u.data_ptr(), v.data_ptr(),
                        out.data_ptr(), *mid, P, R, int(partial), 1.0 - ot_part, 0.05, iters,
                        thresh, group, stream), "K1")
        return out

    return run


def k2_call(torch, lib, flat, k):
    """filter_threshold(flat, k) through the library ``lib``, with scratch
    for either design."""
    fn = lib.filter_threshold_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    B, N = flat.shape
    out = torch.empty_like(flat)
    scratch = torch.empty((B, 8192), dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        native.check(fn(flat.data_ptr(), out.data_ptr(), scratch.data_ptr(), B, N, k, 40,
                        stream), "K2")
        return out

    return run


def in_turns(torch, tag, calls, reps):
    """Time each call by CUDA events in turns (kept, others, others reversed,
    kept) and print the mean of each's two turns."""
    names = list(calls)
    order = names + names[::-1]
    times = {n: [] for n in names}
    for n in order:
        times[n].append(cs.cuda_ms(torch, calls[n], reps=reps))
    for n in names:
        t = times[n]
        turns = ", ".join(f"{x:.4f}" for x in t)
        print(f"[{tag}] {n:32s} ms={sum(t) / len(t):.4f} (turns {turns})", flush=True)


def main():
    import torch

    from vit_reranking_tpu_torch.ops.rerank import sinkhorn_scores_plain
    from vit_reranking_tpu_torch.ops.rollout import filter_threshold_plain

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--earlier", default=None,
                        help="root of another checkout whose K1 and K2 sources are timed too")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_k1k2_variants: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[host] card: {cs.gpu_name_and_limit()}", flush=True)
    libs = build_all(args.earlier)
    print("[build] " + ", ".join(f"{s}: {len(v)} libraries" for s, v in libs.items()), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(1)
    for stage, (Tq, Tk) in (("stage 0", (3136, 784)), ("stage 1", (784, 196))):
        B, N = 32, Tq * Tk
        flat = torch.randn(B, Tq, Tk, device="cuda", generator=gen).softmax(-1).reshape(B, N)
        k = int(N * 0.1)
        ref = filter_threshold_plain(flat, k)
        calls = {n: k2_call(torch, lib, flat, k) for n, lib in libs["filter_threshold"].items()}
        for n, call in calls.items():
            if not torch.equal(call().view(torch.int32), ref.view(torch.int32)):
                raise SystemExit(f"K2 {n} differs from the plain version at {stage}")
        in_turns(torch, f"K2 {stage} B={B} N={N}", calls, reps=5)
        del flat, ref, calls

    Q, K, S49, u49, v49 = cs.k1_rollout_inputs(torch)
    S196, u196, v196, cost = cs.k1_qk_inputs(torch)
    k1_libs = libs["sinkhorn_score"]
    for tag, S, u, v, C, kw in (
            ("K1 R=49 full OT f32", S49, u49, v49, None, {}),
            ("K1 R=49 partial OT 0.9, group exit", S49, u49, v49, None,
             dict(ot_part=0.9, group=K)),
            ("K1 R=49 partial OT 0.9, group exit, thresh 1e-3", S49, u49, v49, None,
             dict(ot_part=0.9, group=K, thresh=1e-3)),
            ("K1 R=49 partial OT 0.5, group exit", S49, u49, v49, None,
             dict(ot_part=0.5, group=K)),
            ("K1 R=49 partial OT 0.5, group exit, thresh 1e-3", S49, u49, v49, None,
             dict(ot_part=0.5, group=K, thresh=1e-3)),
            ("K1 R=196 mode a f32", S196, u196, v196, None, {}),
            ("K1 R=196 mode (d) f32", S196, u196, v196, cost, {}),
            ("K1 R=196 partial OT 0.5, group exit, mode c", S196, u196, v196, None,
             dict(ot_part=0.5, group=K))):
        ref, ref_iters = sinkhorn_scores_plain(S, u, v, cost=C, return_iters=True, **kw)
        group = kw.get("group", 1)
        calls = {}
        for n, lib in k1_libs.items():
            if group == 1 and n.startswith("K1 group"):
                continue  # the per-pair layouts do not run the group code
            it = torch.empty(S.shape[0] // group, dtype=torch.int32, device="cuda")
            calls[n] = k1_call(torch, lib, S, u, v, cost=C, earlier=n == EARLIER,
                               iters_out=None if n == EARLIER else it, **kw)
            out = calls[n]()
            err = float((out - ref).abs().max())
            same, exact, notes = cs.k1_ranks(torch, out, ref, ref_iters, S, u, v, Q, K, cost=C,
                                             **kw)
            exits = "not reported" if n == EARLIER else \
                int((it.repeat_interleave(group) != ref_iters).sum()) // group
            print(f"[{tag}] {n:48s} max_abs_err={err:.3e} ranks_equal={same} "
                  f"ranks_exact={exact} {'groups' if group > 1 else 'pairs'}_exiting_elsewhere="
                  f"{exits}", flush=True)
            for note in notes:
                print(f"[{tag}] {n}: {note}", flush=True)
            # the earlier tree's kernel is timed whatever its rankings
            if n != EARLIER and (not (err <= cs.K1_TOL and exact) or (group > 1 and exits)):
                raise SystemExit(f"{tag} {n}: err {err}, ranks exact {exact}, "
                                 f"exits elsewhere {exits}")
        in_turns(torch, tag, calls, reps=10)
        # the kept kernel's fixed part (Km from S or C, and the score) and
        # what an iteration adds: 0 and 8 iterations for every pair
        kept = k1_libs[KEPT]
        fixed, eight = (cs.cuda_ms(torch, k1_call(torch, kept, S, u, v, cost=C, **{
            **kw, "thresh": 0.0, "iters": n}), reps=10) for n in (0, 8))
        print(f"[{tag}] kept with 0 iterations (Km and the score only) ms={fixed:.4f}; "
              f"with 8 for every pair ms={eight:.4f}, so {(eight - fixed) / 8:.4f} an iteration",
              flush=True)
    print(cs.gpu_name_and_limit(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
