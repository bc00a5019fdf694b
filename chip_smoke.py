"""Smoke run of the PyTorch/CUDA port (vit_reranking_tpu_torch) on one NVIDIA card.

Builds the port's CUDA kernels from vit_reranking_tpu_torch/csrc/, holds each
against its plain PyTorch version at the shapes of the main paths, and drives
both paths through the port's CLI entry points with random weights from a
seeded generator:

  * evaluation: the flagship rerank (CvT-13 with embed_dim 128 at 224 px
    with attention rollout, exact top-100, Sinkhorn OT rerank, R@1 / RP /
    MAP@R on a 128-image synthetic set), carried by kernels K1 and K2;
  * training: train_baseline (full CvT-13, margin loss, distance miner,
    Adam, f32) for 3 steps at batch 112 and one in-train evaluation,
    carried by kernel K3 forward and backward;
  * Swin-T training: train_baseline --arch swin_normalize (full Swin-T at
    224 px, f32) for 3 steps at batch 112 and one in-train evaluation, with
    the window-attention kernels on: K4a (packed, the default variant)
    forward and backward, reached through the qkv entry that reads the
    model's projection in place; then one step and an evaluation batch with
    the batched variant, K4b;
  * DeiT-S evaluation: test_diml_vit (full DeiT-S with embed_dim 128 at
    224 px, --grid_size 14 so R = 196 rerank patches, exact top-100, full
    OT, 128 synthetic images) with the qk method, carried by K1's
    separate-cost mode (d), and with the featvit method, carried by K1's
    modes from S; K1 is held against its plain version at R = 196 in both;
  * the repo's SOP recipe (scripts/diml/test_diml_cvt_sop.sh: CvT-13,
    rollout, --ot_part 0.9) on the evaluation's synthetic set, carried by
    K1's group exit (one query's candidates frozen together), held against
    the eager rerank of the same features.

For each path it checks that its kernels carried it (launch counts set to 0
just before and read just after), and it checks the models' forward or one
train step on the card against the CPU path on a small input.

Every phase prints one line as it ends.  Before the last line come one JSON
line with the kernels' numbers and the card's name and power limit; the last
line is {"ok": true, "device": {...}}.  Any mismatch or error exits non-zero,
and so does a run without a CUDA card.

    python3 chip_smoke.py
"""

import contextlib
import ctypes
import importlib.util
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

# published H100 SXM peaks, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12  # f32 outside the tensor cores (SIMT)
TF32_OPS_PER_S = 495e12  # TF32 on the tensor cores, dense

K1_TOL = 1e-5  # kernel vs plain scores: f32 mat-vec sums in another order
FWD_TOL = 1e-4  # card vs CPU forward: cuDNN/cuBLAS vs CPU f32 sum order, 13 blocks deep
# K3 vs plain: the online softmax and the 64-wide tiles sum in another order,
# and each product is three TF32 products (within about 2^-21 relative of
# f32); dk and dv sum 3136 rows in another order, so their bound is relative
K3_FWD_TOL = 1e-5
K3_GRAD_RTOL = 1e-4
# card vs CPU train step: the forward's f32 sum-order differences (FWD_TOL
# above) pass through BatchNorm on 4 images and the backward of 13 blocks
STEP_RTOL = 1e-4
# K4 vs plain: the same f32 window sums in another order; dq, dk, dv and
# dbias/dadd held to their largest magnitude (dbias sums B * nW windows)
K4_FWD_TOL = 1e-5
K4_GRAD_RTOL = 1e-4


def say(*parts):
    print(*parts, flush=True)


def cuda_ms(torch, fn, reps, warmup=1):
    """Mean milliseconds of ``fn`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved, ops, ops_per_s=FP32_OPS_PER_S):
    """Least time the card could take: bytes over HBM rate vs ops over
    ``ops_per_s`` (by default the f32 SIMT rate), in ms, and which of the
    two bounds it."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gpu_name_and_limit():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


@contextlib.contextmanager
def scratch_cwd():
    """Run inside a temporary working directory (the CLIs write their logs,
    CSVs and checkpoints there), removed afterwards."""
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as work:
        os.chdir(work)
        try:
            yield work
        finally:
            os.chdir(cwd)


def report_profile(tag, what, wall, prof, top, port_kernels=()):
    """From a torch.profiler run over ``wall`` seconds: the device's busy
    share and the kernels that take it; ``port_kernels`` are name parts of
    the port's own kernels, whose time is summed."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        say(f"[{tag}] {what} {wall:.4f}s; the profiler recorded no device events: "
            "device busy share not measured")
        return
    busy, end, by_name = 0.0, -math.inf, {}
    for start, stop, name in spans:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
        total, count = by_name.get(name, (0.0, 0))
        by_name[name] = (total + stop - start, count + 1)
    line = (f"[{tag}] {what} {wall:.4f}s under the profiler; device busy "
            f"{busy / 1e3:.3f} ms = {busy / 1e4 / wall:.2f}% of wall")
    if port_kernels:
        mine = sum(t for n, (t, _) in by_name.items() if any(k in n for k in port_kernels))
        line += f"; port kernels {mine / 1e3:.3f} ms"
    say(line)
    for name, (total, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        say(f"[{tag}] {total / 1e3:9.3f} ms {count:6d}x {name[:100]}")


def phase_host(torch, native):
    nvcc = subprocess.run([native.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    say(f"[host] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"torch.version.cuda {torch.version.cuda}, nvcc: {nvcc}")
    say(f"[host] card: {gpu_name_and_limit()}")
    found = {m: importlib.util.find_spec(m) is not None
             for m in ("triton", "jax", "flax", "PIL", "ninja")}
    say("[host] importable: " + ", ".join(f"{m} {'yes' if ok else 'no'}" for m, ok in found.items()))


def kernel_name(signature):
    """``name<args>`` of a kernel from its demangled signature, with integer
    casts dropped and bools as 1 and 0 (``cu++filt`` writes ``(int)14``)."""
    m = re.search(r"(\w+kernel(?:<[^()]*(?:\([a-z ]+\)[^()]*)*>)?)\(", signature)
    name = m.group(1) if m else signature
    name = re.sub(r"\((?:unsigned |signed )?(?:int|long|long long|short|char|bool)\)", "", name)
    return re.sub(r"\btrue\b", "1", re.sub(r"\bfalse\b", "0", name))


def kernel_resources(native, source):
    """{kernel<args>: "N registers, spills"} from the compiler's report for
    ``csrc/<source>.cu`` (empty when the log is absent); ``cu++filt``, which
    ships beside ``nvcc``, demangles the names."""
    log = native.BUILD_DIR / f"{source}.log"
    if not log.exists():
        return {}
    mangled, res, spill = [], [], ""
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            mangled.append(m.group(1))
        elif "spill" in line:
            spill = line.split(",", 1)[1].strip()
        elif "registers" in line and len(res) < len(mangled):
            res.append(f"{line.split('Used ')[1].split(' ')[0]} registers, {spill}")
    filt = os.path.join(os.path.dirname(native.nvcc_path()), "cu++filt")
    names = subprocess.run([filt], input="\n".join(mangled), capture_output=True, text=True,
                           check=True).stdout.splitlines()
    return {kernel_name(n): r for n, r in zip(names, res)}


def phase_build(native):
    t0 = time.perf_counter()
    secs = native.build()
    wall = time.perf_counter() - t0
    size = sum(p.stat().st_size for p in native.BUILD_DIR.iterdir() if p.is_file())
    say(f"[build] {wall:.3f}s wall ({', '.join(f'{k} {v:.3f}s' for k, v in secs.items())}), "
        f"build/kernels holds {size} bytes")
    for name in native.SOURCES:
        for kernel, res in kernel_resources(native, name).items():
            say(f"[build] {name}: {kernel}: {res}")


def k1_plain_f64(torch, S, u, v, ran, iters=100, thresh=1e-1, ot_temp=0.05, ot_part=1.0,
                 group=1, cost=None):
    """sinkhorn_scores_plain's arithmetic in f64, each group (pair) running
    the ``ran`` iterations the f32 plain version ran: the exact scores of
    the function both the kernel and the plain version compute in f32."""
    import torch.nn.functional as F

    from vit_reranking_tpu_torch.ops.sinkhorn import extend_dustbin

    S, u, v = S.double(), u.double(), v.double()
    Km = torch.exp(-(1.0 - (S if cost is None else cost.double())) / ot_temp)
    if ot_part <= 0.999:
        Km, u, v = extend_dustbin(Km, u, v, 1.0 - ot_part)
        S = F.pad(S, (0, 1, 0, 1))
    r, c = torch.ones_like(u), torch.ones_like(v)
    for it in range(int(ran.max()) if ran.numel() else 0):
        live = (ran > it)[:, None]
        r = torch.where(live, u / torch.bmm(Km, c[:, :, None])[:, :, 0], r)
        c = torch.where(live, v / torch.bmm(Km.transpose(1, 2), r[:, :, None])[:, :, 0], c)
    return torch.sum(r * torch.sum((Km * S) * c[:, None, :], dim=2), dim=1)


def k1_ranks(torch, out, ref, ran, S, u, v, Q, K, **kw):
    """Whether the kernel's scores ``out`` rank each query's K candidates as
    the plain version's ``ref`` do: ``(same, exact, notes)``.  Where the
    orders part, the plain version's own f32 rounding may be what misorders
    two near-tied candidates, so the same arithmetic in f64 with the same
    exits (``ran``) arbitrates: ``exact`` holds if the orders are the same,
    or if on every query where they part the plain version's order is not
    the f64 one and the kernel's is exactly it.  ``notes`` describe each
    such query."""
    k_order = torch.argsort(-out.view(Q, K), dim=1, stable=True)
    p_order = torch.argsort(-ref.view(Q, K), dim=1, stable=True)
    rows = torch.nonzero((k_order != p_order).any(dim=1)).flatten().tolist()
    if not rows:
        return True, True, []
    exact_order = torch.argsort(
        -k1_plain_f64(torch, S, u, v, ran, **kw).view(Q, K), dim=1, stable=True)
    exact, notes = True, []
    for q in rows:
        j = int(torch.nonzero(k_order[q] != p_order[q])[0])
        a, b = int(p_order[q, j]), int(k_order[q, j])
        pa, pb = float(ref.view(Q, K)[q, a]), float(ref.view(Q, K)[q, b])
        kernel_exact = torch.equal(k_order[q], exact_order[q])
        plain_exact = torch.equal(p_order[q], exact_order[q])
        exact = exact and kernel_exact and not plain_exact
        notes.append(
            f"query {q} rank {j}: plain {pa:.9e} (candidate {a}) vs {pb:.9e} ({b}), gap "
            f"{abs(pa - pb):.3e}; kernel off by {abs(float(out.view(Q, K)[q, a]) - pa):.3e} / "
            f"{abs(float(out.view(Q, K)[q, b]) - pb):.3e}; the f64 order is the kernel's: "
            f"{kernel_exact}, the plain version's: {plain_exact}")
    return False, exact, notes


def k1_check(torch, tag, S, u, v, Q, K, **kw):
    """Kernel K1 against its plain version on Q x K pairs (S, u, v and, for
    mode (d), ``kw["cost"]``): max error, identical rankings (see
    :func:`k1_ranks`), under group exit the same exit iteration for every
    group, kernel and plain ms, and the bound from the iterations each pair
    ran."""
    from vit_reranking_tpu_torch.ops import native
    from vit_reranking_tpu_torch.ops.rerank import (
        kernel_layout, sinkhorn_scores, sinkhorn_scores_plain,
    )

    out, k_iters = sinkhorn_scores(S, u, v, return_iters=True, **kw)
    ref, iters = sinkhorn_scores_plain(S, u, v, return_iters=True, **kw)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    same, exact, notes = k1_ranks(torch, out, ref, iters, S, u, v, Q, K, **kw)
    # candidates of one query whose plain scores lie within a few f32 ulps
    # of each other, where the strict rank check can trip on sum order alone
    gaps = -torch.diff(torch.sort(ref.view(Q, K), dim=1, descending=True).values, dim=1)
    near_ties = int((gaps < 1e-7).sum())
    # the iterations each group (each pair, group 1) ran before its exit:
    # group exit must freeze every group at the plain version's iteration
    group = kw.get("group", 1)
    exits_differ = int((k_iters != iters).sum()) // group
    ms = cuda_ms(torch, lambda: sinkhorn_scores(S, u, v, **kw), reps=10)
    plain_ms = cuda_ms(torch, lambda: sinkhorn_scores_plain(S, u, v, **kw), reps=3)
    R = S.shape[-1]
    RP = R + (kw.get("ot_part", 1.0) <= 0.999)
    cost = kw.get("cost")
    bytes_moved = (S.numel() * S.element_size() + (u.numel() + v.numel() + Q * K) * 4
                   + (0 if cost is None else cost.numel() * cost.element_size()))
    ops = int(iters.sum()) * 4 * RP * RP + Q * K * (3 * RP * RP + 3 * R * R)
    bound_ms, bound_by = bound(bytes_moved, ops)
    # the kernel instance the launcher takes, as the launcher names it
    name = ctypes.create_string_buffer(128)
    fn = native.launcher("sinkhorn_score", "sinkhorn_score_instance", [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_int])
    native.check(fn(R, int(RP > R), group, int(S.dtype == torch.bfloat16), name, len(name)),
                 "sinkhorn_score_instance")
    kernel = name.value.decode()
    layout = kernel_layout(R, RP > R, group)[0]
    res = kernel_resources(native, "sinkhorn_score").get(kernel, "resources not reported")
    say(f"[{tag}] max_abs_err={err:.3e} ranks_equal={same} ranks_exact={exact} "
        f"plain_gaps_below_1e-7={near_ties} mean_iters={float(iters.float().mean()):.2f} "
        f"{'groups' if group > 1 else 'pairs'}_exiting_elsewhere={exits_differ} "
        f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.5f} ({bound_by}); "
        f"layout {layout}, {kernel}: {res}")
    for note in notes:
        say(f"[{tag}] {note}")
    if not (err <= K1_TOL and exact and math.isfinite(err)):
        raise AssertionError(f"{tag}: kernel disagrees with its plain version")
    if group > 1 and exits_differ:
        raise AssertionError(f"{tag}: {exits_differ} groups exit at another iteration than "
                             "in the plain version")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def k1_problem(torch, Q, K, C, R, seed):
    """Unit patch features (Q, C, R), their exact top-K by patch-mean
    centers, and the Q * K pairs' similarities S (Q * K, R, R) f32; also
    the generator that drew the features, for what the caller draws next."""
    gen = torch.Generator().manual_seed(seed)
    fb = torch.randn(Q, C, R, generator=gen)
    fb = fb / fb.norm(dim=1, keepdim=True)
    centers = fb.mean(-1)
    centers = centers / centers.norm(dim=-1, keepdim=True)
    sims = centers @ centers.T
    sims.fill_diagonal_(-100.0)
    top = torch.topk(sims, K, dim=1).indices
    fb, top = fb.cuda(), top.cuda()
    S = torch.matmul(fb[top].transpose(-1, -2), fb[:, None]).reshape(Q * K, R, R).contiguous()
    return gen, top, S


def k1_rollout_inputs(torch):
    """The CvT main path's K1 inputs: Q=128 queries, K=100 candidates,
    C=128 channels, R=49 patches, rollout marginals; (Q, K, S, u, v)."""
    from vit_reranking_tpu_torch.ops.rerank import rollout_marginals

    Q, K, C, R = 128, 100, 128, 49
    gen, top, S32 = k1_problem(torch, Q, K, C, R, seed=0)
    roll = torch.randn(Q, R, generator=gen).abs().cuda()
    u, v = rollout_marginals(roll, roll[top])
    u, v = u.reshape(Q * K, R).contiguous(), v.reshape(Q * K, R).contiguous()
    return Q, K, S32, u, v


def phase_k1(torch):
    """Kernel K1 against its plain version at the main path's shapes
    (Q=128 queries, K=100 candidates, C=128 channels, R=49 patches)."""
    Q, K, S32, u, v = k1_rollout_inputs(torch)

    # the main path's exit threshold (1e-1) stops group exit after 2 (ot_part
    # 0.5) or 8 (0.9, the SOP recipe's value) iterations on these inputs;
    # 1e-3 runs the team-shared loop 12-20 deep
    entries = [k1_check(torch, f"K1 {mode}", S, u, v, Q, K, ot_part=ot_part, group=group,
                        thresh=thresh)
               for mode, S, ot_part, group, thresh in (
                   ("full OT f32", S32, 1.0, 1, 1e-1),
                   ("R=49 partial OT 0.9, group exit", S32, 0.9, K, 1e-1),
                   ("R=49 partial OT 0.9, group exit, thresh 1e-3", S32, 0.9, K, 1e-3),
                   ("partial OT 0.5, group exit", S32, 0.5, K, 1e-1),
                   ("partial OT 0.5, group exit, thresh 1e-3", S32, 0.5, K, 1e-3),
                   ("full OT bf16 stream", S32.to(torch.bfloat16), 1.0, 1, 1e-1))]
    return entries[0], entries[1]  # the main path's mode, the SOP recipe's


def k1_qk_inputs(torch):
    """DeiT-S's K1 inputs (Q=128, K=100, C=128, R=196): S, and the qk
    method's marginals and cost as fused_qk_rerank_scores builds them;
    (S, u, v, cost)."""
    from vit_reranking_tpu_torch.ops.similarity import l2_normalize

    Q, K, C, R, D = 128, 100, 128, 196, 64
    _, top, S32 = k1_problem(torch, Q, K, C, R, seed=6)
    # the qk method's inputs, as fused_qk_rerank_scores builds them: q and
    # k head means of unit norm, dp = k . q / 8, the cost its patch block,
    # the marginals its cls column and row
    gen = torch.Generator(device="cuda").manual_seed(6)
    q, k = (l2_normalize(torch.randn(Q, R + 1, D, device="cuda", generator=gen)) for _ in "qk")
    kg = k[top]  # (Q, K, R + 1, D)
    cost = (torch.matmul(kg[:, :, 1:].reshape(Q, K * R, D), q[:, 1:].transpose(1, 2)) / 8.0)
    cost = cost.reshape(Q * K, R, R).contiguous()
    u = torch.relu(torch.matmul(kg[:, :, 1:], q[:, None, 0, :, None])[..., 0] / 8.0)
    v = torch.relu(torch.matmul(kg[:, :, 0], q[:, 1:].transpose(1, 2)) / 8.0)
    u, v = (t / (t.sum(-1, keepdim=True) + 1e-5) for t in (u, v))
    u, v = u.reshape(Q * K, R).contiguous(), v.reshape(Q * K, R).contiguous()
    del kg
    return S32, u, v, cost


def phase_k1_large(torch):
    """K1 at DeiT-S's rerank shapes (Q=128, K=100, C=128, R=196, one block
    a pair): mode (d) with the qk method's cost, f32 and bf16, and modes a
    (full OT) and c (partial OT 0.5 with group exit) from S."""
    from vit_reranking_tpu_torch.ops.rerank import kernel_layout

    Q, K, R = 128, 100, 196
    S32, u, v, cost = k1_qk_inputs(torch)
    say("[K1 R=196] layouts: full OT " + str(kernel_layout(R, False, 1))
        + ", partial OT group exit " + str(kernel_layout(R, True, K))
        + " (layout, shared-memory bytes, the card's limit)")
    qk = k1_check(torch, "K1 qk f32, mode (d), R=196", S32, u, v, Q, K, cost=cost)
    k1_check(torch, "K1 qk bf16 stream, mode (d), R=196", S32.to(torch.bfloat16), u, v, Q, K,
             cost=cost.to(torch.bfloat16))
    k1_check(torch, "K1 R=196 full OT f32, mode a", S32, u, v, Q, K)
    k1_check(torch, "K1 R=196 partial OT 0.5, group exit, mode c", S32, u, v, Q, K,
             ot_part=0.5, group=K)
    del S32, cost
    torch.cuda.empty_cache()
    return qk


def k2_edge_rows(torch, kind, B, N, offset, gen):
    """(B, N) f32 rows of one edge kind on the card, starting ``offset``
    floats past a 16-byte boundary (a contiguous view)."""
    buf = torch.empty(B * N + offset, device="cuda")
    if kind == "ties":
        vals = torch.tensor([0.0, 1e-3, 2.5e-3, 0.5], device="cuda")
    elif kind == "signed zeros":
        vals = torch.tensor([0.0, -0.0, 1e-30, -1e-30, 3e-4], device="cuda")
    else:  # constant
        vals = torch.tensor([0.25], device="cuda")
    idx = torch.randint(0, len(vals), (B * N,), device="cuda", generator=gen)
    buf[offset:] = vals[idx]
    return buf[offset:].view(B, N)


def phase_k2(torch):
    """Kernel K2 against its plain version, bit for bit: edge rows (ties,
    zeros of both signs, constant rows; k = 1, N / 10, N; rows on and off
    16-byte boundaries), then rows of CvT-13's stage-0 and stage-1
    attention maps at 224 px, batch 32, timed, with the launches of one
    call counted by the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vit_reranking_tpu_torch.ops.rollout import filter_threshold, filter_threshold_plain

    def same_bits(a, b):
        return torch.equal(a.view(torch.int32), b.view(torch.int32))

    gen = torch.Generator(device="cuda").manual_seed(1)
    failed = []
    cases = 0
    for kind in ("ties", "signed zeros", "constant"):
        for N in (70_001, 153_664):
            for offset in (0, 1):
                flat = k2_edge_rows(torch, kind, 3, N, offset, gen)
                for k in (1, N // 10, N):
                    cases += 1
                    if not same_bits(filter_threshold(flat, k), filter_threshold_plain(flat, k)):
                        failed.append((kind, N, offset, k))
    torch.cuda.synchronize()
    say(f"[K2 edge rows] {cases} cases (ties, signed zeros, constant; N 70001 and 153664; "
        f"offset 0 and 1 float; k 1, N/10, N) bitwise_equal={not failed}")
    if failed:
        raise AssertionError(f"K2 differs from its plain version on edge rows: {failed}")

    entry = None
    for stage, (Tq, Tk) in (("stage 0", (3136, 784)), ("stage 1", (784, 196))):
        B, N = 32, Tq * Tk
        flat = torch.randn(B, Tq, Tk, device="cuda", generator=gen).softmax(-1).reshape(B, N)
        k = int(N * 0.1)
        out = filter_threshold(flat, k)
        ref = filter_threshold_plain(flat, k)
        torch.cuda.synchronize()
        same = same_bits(out, ref)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            filter_threshold(flat, k)
            torch.cuda.synchronize()
        per_call = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
        ms = cuda_ms(torch, lambda: filter_threshold(flat, k), reps=5)
        plain_ms = cuda_ms(torch, lambda: filter_threshold_plain(flat, k), reps=3)
        # yardstick: one PyTorch call for the threshold alone (no zeroing)
        lib_ms = cuda_ms(torch, lambda: torch.kthvalue(flat, k, dim=1), reps=3)
        bound_ms, bound_by = bound(2 * flat.numel() * 4, 40 * flat.numel())
        say(f"[K2 {stage} B={B} N={N}] bitwise_equal={same} kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} kthvalue_ms={lib_ms:.4f} "
            f"bound_ms={bound_ms:.5f} ({bound_by}) device_launches_per_call={per_call}")
        if not same:
            raise AssertionError(f"K2 {stage}: kernel output differs from its plain version")
        if entry is None:
            entry = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=lib_ms)
        del flat, out, ref
    return entry


def sdpa_backend(*args, **kw):
    """The first of scaled_dot_product_attention's backends (flash, cuDNN,
    memory-efficient, math) that takes these inputs."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for b in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
              SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([b]):
                F.scaled_dot_product_attention(*args, **kw)
            return b
        except RuntimeError:
            continue
    raise RuntimeError("no scaled_dot_product_attention backend ran")


def phase_k3(torch):
    """Kernel K3, forward and backward, against its plain versions at the
    main path's shape: CvT-13 stage 0 at 224 px and batch 112 (BH=112,
    T=3136, Tkv=784, D=64), the backward twice for the same bits, with the
    yardstick of scaled_dot_product_attention on the same inputs."""
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    from vit_reranking_tpu_torch.ops.attention import (
        kv_resident_attention, kv_resident_attention_plain,
    )

    BH, T, Tkv, D = 112, 3136, 784, 64
    scale = D ** -0.5  # CvT's full-dim scale; stage 0 has one head of 64
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, do = (torch.randn(BH, T, D, device="cuda", generator=gen) for _ in range(2))
    k, v = (torch.randn(BH, Tkv, D, device="cuda", generator=gen) for _ in range(2))

    with torch.no_grad():
        out = kv_resident_attention(q, k, v, scale)
        ref = kv_resident_attention_plain(q, k, v, scale)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    og = kv_resident_attention(qg, kg, vg, scale)
    grads = torch.autograd.grad(og, (qg, kg, vg), do, retain_graph=True)
    again = torch.autograd.grad(og, (qg, kg, vg), do, retain_graph=True)
    # the plain version's gradient is autograd's, through a kept graph that
    # is timed below as the plain backward
    rq, rk, rv = (t.clone().requires_grad_() for t in (q, k, v))
    ro = kv_resident_attention_plain(rq, rk, rv, scale)
    ref_grads = torch.autograd.grad(ro, (rq, rk, rv), do, retain_graph=True)
    torch.cuda.synchronize()
    fwd_err = float((out - ref).abs().max())
    rel = {n: float((a - b).abs().max() / b.abs().max())
           for n, a, b in zip(("dq", "dk", "dv"), grads, ref_grads)}
    bwd_err = max(float((a - b).abs().max()) for a, b in zip(grads, ref_grads))
    same_bits = all(torch.equal(a, b) for a, b in zip(grads, again))
    del ref, ref_grads, again

    backend = sdpa_backend(q[:1, None], k[:1, None], v[:1, None], scale=scale)
    q4, k4, v4 = (t.view(BH, 1, -1, D).clone().requires_grad_() for t in (q, k, v))
    with sdpa_kernel([backend]):
        o4 = F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
        sdpa_fwd_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q4.detach(), k4.detach(), v4.detach(), scale=scale), reps=5)
        sdpa_bwd_ms = cuda_ms(torch, lambda: torch.autograd.grad(
            o4, (q4, k4, v4), do.view(BH, 1, T, D), retain_graph=True), reps=5)
        sdpa_fb_ms = cuda_ms(torch, lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(q4, k4, v4, scale=scale), (q4, k4, v4),
            do.view(BH, 1, T, D)), reps=5)
    del q4, k4, v4, o4

    with torch.no_grad():
        fwd_ms = cuda_ms(torch, lambda: kv_resident_attention(q, k, v, scale), reps=10)
        fwd_plain_ms = cuda_ms(torch, lambda: kv_resident_attention_plain(q, k, v, scale), reps=3)
    bwd_ms = cuda_ms(torch, lambda: torch.autograd.grad(og, (qg, kg, vg), do, retain_graph=True),
                     reps=5)
    bwd_plain_ms = cuda_ms(torch, lambda: torch.autograd.grad(ro, (rq, rk, rv), do,
                                                              retain_graph=True), reps=3)
    del ro, rq, rk, rv
    # the kernel computes each f32 product as three TF32 tensor-core
    # products (csrc/kv_attention.cu), so its bound is 3 x ops at the TF32
    # rate; the f32 SIMT bound of the same products is printed beside it
    elem = 4
    fwd_bytes, fwd_ops = (q.numel() * 2 + k.numel() * 2) * elem, 4 * T * Tkv * D * BH
    bwd_bytes, bwd_ops = (q.numel() * 4 + k.numel() * 4) * elem, 10 * T * Tkv * D * BH
    fwd_bound = bound(fwd_bytes, 3 * fwd_ops, TF32_OPS_PER_S)
    bwd_bound = bound(bwd_bytes, 3 * bwd_ops, TF32_OPS_PER_S)
    fwd_simt, bwd_simt = bound(fwd_bytes, fwd_ops)[0], bound(bwd_bytes, bwd_ops)[0]
    say(f"[K3 fwd BH={BH} T={T} Tkv={Tkv} D={D}] max_abs_err={fwd_err:.3e} "
        f"kernel_ms={fwd_ms:.4f} plain_ms={fwd_plain_ms:.4f} sdpa_ms={sdpa_fwd_ms:.4f} "
        f"bound_ms 3xTF32={fwd_bound[0]:.5f} ({fwd_bound[1]}) f32 SIMT={fwd_simt:.5f}")
    say(f"[K3 bwd BH={BH} T={T} Tkv={Tkv} D={D}] max_abs_err={bwd_err:.3e} rel_err "
        + " ".join(f"{n}={e:.3e}" for n, e in rel.items())
        + f" same_bits_twice={same_bits} kernel_ms={bwd_ms:.4f} plain_ms={bwd_plain_ms:.4f} "
        f"sdpa_bwd_ms={sdpa_bwd_ms:.4f} bound_ms 3xTF32={bwd_bound[0]:.5f} ({bwd_bound[1]}) "
        f"f32 SIMT={bwd_simt:.5f}")
    say(f"[K3] sdpa backend in f32: {backend.name}; sdpa fwd+bwd {sdpa_fb_ms:.4f} ms, "
        f"K3 fwd+bwd {fwd_ms + bwd_ms:.4f} ms")
    if not fwd_err <= K3_FWD_TOL:
        raise AssertionError(f"K3 forward disagrees with its plain version: {fwd_err}")
    bad = {n: e for n, e in rel.items() if not e <= K3_GRAD_RTOL}
    if bad:
        raise AssertionError(f"K3 backward disagrees with autograd of the plain version: {bad}")
    if not same_bits:
        raise AssertionError("K3 backward gave other bits on a second run of the same inputs")
    return {
        "fwd": dict(max_abs_err=fwd_err, ms=fwd_ms, plain_ms=fwd_plain_ms,
                    bound_ms=fwd_bound[0], bound_by=fwd_bound[1], library_ms=sdpa_fwd_ms),
        "bwd": dict(max_abs_err=bwd_err, ms=bwd_ms, plain_ms=bwd_plain_ms,
                    bound_ms=bwd_bound[0], bound_by=bwd_bound[1], library_ms=sdpa_bwd_ms),
    }


MAIN_ARGS = [
    "--dataset", "synthetic", "--synthetic_classes", "8", "--synthetic_per_class", "16",
    "--synthetic_size", "224", "--bs", "32", "--arch", "cvt_13_normalize",
    "--embed_dim", "128", "--use_rollout", "--use_ot", "--seed", "0", "--device", "cuda",
]


def run_main_path(torch, args=MAIN_ARGS):
    """The port's run_eval on --dataset synthetic, from a scratch working
    directory (it appends its CSV to test_results/ there); returns the
    results and the wall seconds."""
    from vit_reranking_tpu_torch.cli.test_diml import run_eval
    from vit_reranking_tpu_torch.core.config import from_args

    with scratch_cwd():
        t0 = time.perf_counter()
        results = run_eval(from_args(args), trunc_nums=(0, 100))
        torch.cuda.synchronize()
        return results, time.perf_counter() - t0


def check_metrics(tag, results):
    for t in (0, 100):
        say(f"[{tag}] trunc {t}: R@1={results['r1'][t]:.4f} RP={results['rp'][t]:.4f} "
            f"MAP@R={results['mapr'][t]:.4f}")
    for m in results:
        for t, val in results[m].items():
            if not (math.isfinite(val) and 0.0 <= val <= 100.0):
                raise AssertionError(f"{tag}: metric {m}@{t} = {val}")


def phase_main(torch):
    """The main path, with every kernel's launch count set to 0 just before
    and read just after."""
    from vit_reranking_tpu_torch.ops.rerank import sinkhorn_scores
    from vit_reranking_tpu_torch.ops.rollout import filter_threshold

    sinkhorn_scores.launches = 0
    filter_threshold.launches = 0
    results, wall = run_main_path(torch)
    launches = {"sinkhorn_score": sinkhorn_scores.launches,
                "filter_threshold": filter_threshold.launches}
    check_metrics("main", results)
    say(f"[main] run_eval {wall:.3f}s (first run, after the kernel checks), launches {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    return launches


def phase_profile(torch):
    """A second, warm run of the main path under torch.profiler: the device's
    busy share of the wall time and the kernels that take it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = run_main_path(torch)
    report_profile("profile", "warm run_eval", wall, prof, top=12,
                   port_kernels=("sinkhorn_", "_digit_kernel", "::apply_kernel<"))


def phase_reference(torch):
    """CvT-13 forward with rollout on the card (kernel K2) against the CPU
    path (plain versions), same weights and images."""
    from vit_reranking_tpu_torch.models.cvt import CvTNetwork

    model = CvTNetwork(embed_dim=128, generator=torch.Generator().manual_seed(0)).eval()
    x = torch.randn(2, 3, 224, 224, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref = model(x, ret_attn=True)
        out = model.cuda()(x.cuda(), ret_attn=True)
    pairs = {
        "embed": (out[0], ref[0]),
        "head_tokens": (out[2]["head_tokens"], ref[2]["head_tokens"]),
        "rollout_maps": (out[2]["rollout_maps"], ref[2]["rollout_maps"]),
    }
    errs = {}
    for name, (a, b) in pairs.items():
        a = a.cpu()
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError(f"{name}: shape {tuple(a.shape)} or non-finite values")
        errs[name] = float((a - b).abs().max())
    say("[reference] card vs CPU forward, max abs err: "
        + ", ".join(f"{k}={v:.3e}" for k, v in errs.items()))
    bad = {k: v for k, v in errs.items() if not v <= FWD_TOL}
    if bad:
        raise AssertionError(f"card and CPU forward disagree beyond {FWD_TOL}: {bad}")


# the repo's SOP recipe (scripts/diml/test_diml_cvt_sop.sh: CvT-13, rollout,
# partial OT 0.9) on the main path's synthetic set and random weights
SOP_ARGS = MAIN_ARGS + ["--ot_part", "0.9", "--use_minus", "--use_cls_token",
                        "--temperature", "0.1", "--grid_size", "7", "--bs", "16"]


def phase_sop(torch):
    """run_eval with the SOP recipe's flags, counts zeroed just before and
    read just after: partial OT sends every query tile to K1's group exit.
    Its rankings and metrics are then held against the same features
    reranked eagerly (``use_fused=False``) on the card: identical rankings,
    MAP@R within 1e-4 points.  Then a warm run, and one under the profiler
    for K1's device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vit_reranking_tpu_torch.cli import test_diml
    from vit_reranking_tpu_torch.engine import rerank_eval
    from vit_reranking_tpu_torch.ops.rerank import sinkhorn_scores
    from vit_reranking_tpu_torch.ops.rollout import filter_threshold

    calls, finals = [], []
    real_eval, real_metrics = test_diml.rerank_evaluate, rerank_eval.metrics_from_ranks

    def record_eval(*args, **kwargs):
        calls.append((args, kwargs))
        return real_eval(*args, **kwargs)

    def record_metrics(final, *args, **kwargs):
        finals.append(final.clone())
        return real_metrics(final, *args, **kwargs)

    sinkhorn_scores.launches = sinkhorn_scores.group_launches = 0
    filter_threshold.launches = 0
    with switched([(test_diml, "rerank_evaluate", record_eval),
                   (rerank_eval, "metrics_from_ranks", record_metrics)]):
        results, wall = run_main_path(torch, SOP_ARGS)
    launches = {"sinkhorn_score": sinkhorn_scores.launches,
                "sinkhorn_score_group": sinkhorn_scores.group_launches,
                "filter_threshold": filter_threshold.launches}
    check_metrics("sop", results)
    say(f"[sop] run_eval {wall:.3f}s (first run), launches {launches}")
    if launches["sinkhorn_score_group"] <= 0 or launches["filter_threshold"] <= 0:
        raise AssertionError(f"sop: the group exit layout was not launched: {launches}")
    fused_finals = finals[:]
    finals.clear()
    args, kwargs = calls[0]
    with switched([(rerank_eval, "metrics_from_ranks", record_metrics)]):
        eager = real_eval(*args, **{**kwargs, "use_fused": False})
    torch.cuda.synchronize()
    same = len(finals) == len(fused_finals) and all(
        torch.equal(a, b) for a, b in zip(fused_finals, finals))
    gaps = {m: max(abs(results[m][t] - eager[m][t]) for t in results[m]) for m in results}
    say(f"[sop] fused vs eager rerank of the same features: rankings_equal={same}, "
        f"largest metric gaps (points) " + ", ".join(f"{m} {g:.2e}" for m, g in gaps.items()))
    if not (same and gaps["r1"] == 0.0 and gaps["rp"] == 0.0 and gaps["mapr"] <= 1e-4):
        raise AssertionError("sop: the fused rerank disagrees with the eager one")
    _, warm = run_main_path(torch, SOP_ARGS)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = run_main_path(torch, SOP_ARGS)
    k1 = [e.time_range.end - e.time_range.start for e in prof.events()
          if e.device_type == DeviceType.CUDA and "sinkhorn_group" in e.name]
    say(f"[sop] warm run_eval {warm:.3f}s; K1 group exit {sum(k1) / 1e3:.4f} ms device time "
        f"in {len(k1)} launches of a profiled warm run")
    report_profile("sop", "warm run_eval", wall, prof, top=8,
                   port_kernels=("sinkhorn_", "_digit_kernel", "::apply_kernel<"))
    return launches


TRAIN_ARGS = [
    "--dataset", "synthetic", "--arch", "cvt_13_normalize", "--loss", "margin",
    "--batch_mining", "distance", "--bs", "112", "--samples_per_class", "2",
    "--n_epochs", "1", "--evalevery", "1", "--synthetic_classes", "8",
    "--synthetic_per_class", "48", "--synthetic_size", "224", "--embed_dim", "128",
    "--seed", "0", "--kernels", "8", "--device", "cuda",
]


def run_train(torch, args, counted):
    """train_baseline.main(args) from a scratch working directory with
    --save_path there, the launch counts of ``counted`` (a kernel wrapper)
    set to 0 just before and read just after.  Returns (summary, launches,
    wall seconds)."""
    from vit_reranking_tpu_torch.cli import train_baseline

    with scratch_cwd() as work:
        counted.fwd_launches = counted.bwd_launches = 0
        t0 = time.perf_counter()
        summary = train_baseline.main(args + ["--save_path", os.path.join(work, "runs")])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return summary, {"fwd": counted.fwd_launches, "bwd": counted.bwd_launches}, wall


def report_train(tag, summary, wall, kernel, launches, expected, steps=3):
    """Print a training run's losses, step seconds (CUDA events), in-train
    metrics and launch counts; fail on non-finite values or when
    ``expected`` (the launch check) is false."""
    losses, secs = summary["step_loss"], summary["step_seconds"]
    say(f"[{tag}] step losses " + " ".join(f"{x:.6f}" for x in losses))
    say(f"[{tag}] step seconds (CUDA events): first {secs[0]:.4f}, warm "
        + " ".join(f"{x:.4f}" for x in secs[1:]))
    ev = summary["eval"][-1]
    say(f"[{tag}] in-train eval R@1={ev['r1']:.4f} RP={ev['rp']:.4f} MAP@R={ev['mapr']:.4f}; "
        f"train_baseline.main {wall:.3f}s; {kernel} launches {launches}")
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{tag} losses {losses}")
    if not expected:
        raise AssertionError(f"{kernel} was not launched as the {tag} path needs: {launches}")
    for m, val in ev.items():
        if not (math.isfinite(val) and 0.0 <= val <= 100.0):
            raise AssertionError(f"{tag} in-train metric {m} = {val}")


def phase_train(torch):
    """The training path: 384 images at batch 112, 3 steps, then one
    evaluation of the 384-image test split, kernel K3's launches counted."""
    from vit_reranking_tpu_torch.ops.attention import kv_resident_attention

    summary, launches, wall = run_train(torch, TRAIN_ARGS, kv_resident_attention)
    n_eval = -(-8 * 48 // 112)
    report_train("train", summary, wall, "K3", launches,
                 launches["fwd"] >= 3 + n_eval and launches["bwd"] == 3)
    return launches


@contextlib.contextmanager
def switched(settings):
    """Set each ``(module, name, value)`` of ``settings`` for the block and
    restore the old values after it."""
    saved = [(m, n, getattr(m, n)) for m, n, _ in settings]
    for m, n, val in settings:
        setattr(m, n, val)
    try:
        yield
    finally:
        for m, n, val in saved:
            setattr(m, n, val)


def ab_and_profile(torch, tag, args, variants, order, profiled, port_kernels, top=15):
    """Warm train steps at ``args``'s configuration under each of
    ``variants`` (label -> module settings, see :func:`switched`) in the
    turns of ``order``, each turn 3 timed steps after a warm-up, with its
    median and peak memory; then one step of each label in ``profiled``
    under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from vit_reranking_tpu_torch.cli.common import build_training, run_train_step
    from vit_reranking_tpu_torch.core.config import from_args
    from vit_reranking_tpu_torch.data.loader import build_dataset

    opt = from_args(args)
    loaders, _ = build_dataset(opt)
    lab, images, _ = next(iter(loaders["training"]))
    _, _, state = build_training(opt, len(loaders["training"]), torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(1)

    def step():
        return run_train_step(state, lab, images, gen, "cuda")

    def timed_steps(label, n=3):
        with switched(variants[label]):
            step()  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(n):
                t0 = time.perf_counter()
                float(step()["loss"])
                times.append(time.perf_counter() - t0)
            return sorted(times)[n // 2], torch.cuda.max_memory_allocated() / 2**30

    ab = [(label, *timed_steps(label)) for label in order]
    say(f"[{tag}-ab] warm step median s / peak GiB: "
        + ", ".join(f"{label} {t:.4f} s {m:.2f} GiB" for label, t, m in ab))
    for label in profiled:
        with switched(variants[label]):
            step()  # warm-up
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        report_profile(f"{tag}-profile", f"one warm step, {label},", wall, prof, top=top,
                       port_kernels=port_kernels)


def phase_train_profile(torch):
    """K3 against the materialising attention (models/cvt.py
    USE_KV_RESIDENT_ATTENTION off), and a profiled step."""
    from vit_reranking_tpu_torch.models import cvt

    switch = "USE_KV_RESIDENT_ATTENTION"
    ab_and_profile(torch, "train", TRAIN_ARGS,
                   {"K3 on": [(cvt, switch, True)], "off (materialising)": [(cvt, switch, False)]},
                   ("K3 on", "off (materialising)", "off (materialising)", "K3 on"), ("K3 on",),
                   ("dkdv_kernel", "dq_kernel", "fwd_kernel", "delta_kernel"))


def card_vs_cpu_step(torch, tag, base):
    """One train step of ``base`` on the card against the same step on the
    CPU: a copy of the same weights on each, 4 images at 224 px, fixed
    triplets, Adam with two groups; loss and gradient norm compared."""
    import copy
    from types import SimpleNamespace

    from vit_reranking_tpu_torch.engine.train import init_train_state, make_optimizer, train_step
    from vit_reranking_tpu_torch.losses.margin import MarginLoss
    from vit_reranking_tpu_torch.miners.common import Triplets

    class FixedMiner:
        name = "distance"

        def __call__(self, batch, labels, generator=None):
            idx = lambda *i: torch.tensor(i, device=batch.device)
            return Triplets(idx(0, 1, 2, 3), idx(1, 0, 3, 2), idx(2, 3, 0, 1),
                            torch.ones(4, dtype=torch.bool, device=batch.device))

    x = torch.randn(4, 3, 224, 224, generator=torch.Generator().manual_seed(3))
    labels = torch.tensor([0, 0, 1, 1])
    opt = SimpleNamespace(n_classes=2)

    def one_step(device):
        model = copy.deepcopy(base).to(device)
        crit = MarginLoss(opt, FixedMiner()).to(device)
        optim = make_optimizer("adam", 4e-4, {"model": list(model.parameters()),
                                              "criterion": list(crit.parameters())},
                               {"model": 1e-5, "criterion": 5e-4})
        m = train_step(init_train_state(model, crit, optim), x.to(device), labels.to(device))
        return {k: float(v) for k, v in m.items()}

    card, cpu = one_step("cuda"), one_step("cpu")
    rel = {k: abs(card[k] - cpu[k]) / abs(cpu[k]) for k in ("loss", "grad_l2")}
    say(f"[{tag}] card {card} cpu {cpu} rel_err "
        + " ".join(f"{k}={v:.3e}" for k, v in rel.items()))
    bad = {k: v for k, v in rel.items() if not v <= STEP_RTOL}
    if bad or not all(math.isfinite(v) for v in card.values()):
        raise AssertionError(f"card and CPU train steps disagree beyond {STEP_RTOL}: {bad}")


def phase_train_reference(torch):
    """Full CvT-13 (drop-path 0), card step against CPU step."""
    from vit_reranking_tpu_torch.models.cvt import CvTNetwork, CvTSpec

    base = CvTNetwork(embed_dim=128, spec=CvTSpec(drop_path_rate=(0.0, 0.0, 0.0)),
                      generator=torch.Generator().manual_seed(0))
    card_vs_cpu_step(torch, "train-reference", base)


def phase_k3_head_dims(torch):
    """K3's gate after its repair: at D = 192 the kernel runs and matches
    its plain version; at D = 256, which K3 is not built for, cvt_attention
    returns None and the caller materialises."""
    from vit_reranking_tpu_torch.ops.attention import (
        cvt_attention, kv_resident_attention, kv_resident_attention_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(7)
    for D in (192, 256):
        q, k, v, do = (torch.randn(1, 2, 784, D, device="cuda", generator=gen) for _ in range(4))
        scale = D ** -0.5
        before = kv_resident_attention.fwd_launches
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = cvt_attention(*leaves, scale)
        routed = out is not None
        if not routed:
            out = kv_resident_attention_plain(*leaves, scale)
        grads = torch.autograd.grad(out, leaves, do)
        ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        ref = kv_resident_attention_plain(*ref_leaves, scale)
        ref_grads = torch.autograd.grad(ref, ref_leaves, do)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        rel = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(grads, ref_grads))
        launched = kv_resident_attention.fwd_launches - before
        say(f"[K3 D={D}] B*H=2 T=Tkv=784: {'kernel' if routed else 'gate returns None'} "
            f"(launches {launched}), max_abs_err={err:.3e} grad rel_err={rel:.3e}")
        if routed != (D == 192) or launched != int(routed):
            raise AssertionError(f"K3 gate at D={D}: routed={routed}, launches {launched}")
        if not (err <= K3_FWD_TOL and rel <= K3_GRAD_RTOL):
            raise AssertionError(f"K3 at D={D} disagrees with its plain version")


def phase_k4(torch):
    """Kernels K4a (packed contract) and K4b (batched contract), forward and
    backward, against their plain versions at Swin-T's stage-0 and stage-2
    shapes at batch 112 (T=49, D=32; the real shifted-window masks), with
    dbias/dadd checked for the same bits on a second run, and the yardstick
    of scaled_dot_product_attention over the same windows with the bias and
    mask expanded to a float attn_mask; then the model's qkv entry at the
    same shapes (:func:`k4_qkv_entry`)."""
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    from vit_reranking_tpu_torch.models.swin import _shift_attn_mask
    from vit_reranking_tpu_torch.ops import swin_attention as swa

    T, D, B = 49, 32, 112
    scale = D ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(4)
    entries = {}
    for stage, nW, H, res in (("stage 0", 64, 3, 56), ("stage 2", 4, 12, 14)):
        G = H * B
        q, k, v, do = (torch.randn(G, nW, T, D, device="cuda", generator=gen) for _ in range(4))
        bias = torch.randn(H, T, T, device="cuda", generator=gen)
        mask = torch.from_numpy(_shift_attn_mask(res, res, 7, 3)).cuda()
        P = swa._pick_pack_packed(nW, T)
        nblk, PT = nW // P, P * T
        add = swa._packed_add_term(bias, mask, P, nblk).contiguous()
        pshape = (G, nblk, PT, D)

        # the yardstick: one library call over the G * nW windows
        q4, k4, v4 = (t.view(G * nW, 1, T, D).clone().requires_grad_() for t in (q, k, v))
        full_mask = (bias.repeat_interleave(B, dim=0)[:, None] + mask[None]).view(G * nW, 1, T, T)
        backend = sdpa_backend(q4[:8], k4[:8], v4[:8], attn_mask=full_mask[:8], scale=scale)
        with sdpa_kernel([backend]):
            o4 = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=full_mask, scale=scale)
            sdpa_fwd = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                q4.detach(), k4.detach(), v4.detach(), attn_mask=full_mask, scale=scale), reps=5)
            sdpa_bwd = cuda_ms(torch, lambda: torch.autograd.grad(
                o4, (q4, k4, v4), do.view(G * nW, 1, T, D), retain_graph=True), reps=5)
            sdpa_fb = cuda_ms(torch, lambda: torch.autograd.grad(
                F.scaled_dot_product_attention(q4, k4, v4, attn_mask=full_mask, scale=scale),
                (q4, k4, v4), do.view(G * nW, 1, T, D)), reps=5)
        del q4, k4, v4, o4, full_mask
        fwd_bwd, bounds = {}, {}

        qkv_bytes = q.numel() * 4
        ops_fwd = 4 * T * T * D * G * nW
        ops_bwd = 10 * T * T * D * G * nW
        for name, fn, plain, operands in (
            ("K4a packed", lambda *a: swa._packed_attention(*a, scale, B, T),
             lambda *a: swa.packed_attention_plain(*a, scale, B),
             (q.view(pshape), k.view(pshape), v.view(pshape), add)),
            ("K4b batched", lambda *a: swa.swin_window_attention(*a, mask, scale),
             lambda *a: swa.swin_window_attention_plain(*a, mask, scale), (q, k, v, bias)),
        ):
            gout = do.view(operands[0].shape)
            leaves = [t.clone().requires_grad_() for t in operands]
            out = fn(*leaves)
            grads = torch.autograd.grad(out, leaves, gout, retain_graph=True)
            again = torch.autograd.grad(out, leaves, gout, retain_graph=True)
            ref_leaves = [t.clone().requires_grad_() for t in operands]
            ref = plain(*ref_leaves)
            ref_grads = torch.autograd.grad(ref, ref_leaves, gout, retain_graph=True)
            torch.cuda.synchronize()
            fwd_err = float((out - ref).abs().max())
            rel = {n: float((a - b).abs().max() / b.abs().max())
                   for n, a, b in zip(("dq", "dk", "dv", "dadd" if "packed" in name else "dbias"),
                                      grads, ref_grads)}
            bwd_err = max(float((a - b).abs().max()) for a, b in zip(grads, ref_grads))
            same_bits = torch.equal(grads[3], again[3])
            with torch.no_grad():
                ms = cuda_ms(torch, lambda: fn(*operands), reps=10)
                plain_ms = cuda_ms(torch, lambda: plain(*operands), reps=3)
            bwd_ms = cuda_ms(torch, lambda: torch.autograd.grad(out, leaves, gout,
                                                                retain_graph=True), reps=10)
            bwd_plain_ms = cuda_ms(torch, lambda: torch.autograd.grad(ref, ref_leaves, gout,
                                                                      retain_graph=True), reps=3)
            # the packed contract's function needs only add's diagonal (T, T)
            # blocks (the rest is -1e9); its gradient is written in full
            add_bytes = (H * nW * T * T * 4 if "packed" in name
                         else (bias.numel() + mask.numel()) * 4)
            fwd_bound = bound(4 * qkv_bytes + add_bytes, ops_fwd)
            bwd_bound = bound(7 * qkv_bytes + add_bytes + operands[3].numel() * 4, ops_bwd)
            bounds[name] = fwd_bound, bwd_bound
            del out, ref, grads, again, ref_grads, leaves, ref_leaves
            say(f"[{name} fwd, {stage}: G={G} nW={nW} T={T} D={D}] max_abs_err={fwd_err:.3e} "
                f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} sdpa_ms={sdpa_fwd:.4f} "
                f"bound_ms={fwd_bound[0]:.5f} ({fwd_bound[1]})")
            say(f"[{name} bwd, {stage}: G={G} nW={nW} T={T} D={D}] max_abs_err={bwd_err:.3e} "
                "rel_err " + " ".join(f"{n}={e:.3e}" for n, e in rel.items())
                + f" same_bits_on_rerun={same_bits} kernel_ms={bwd_ms:.4f} "
                f"plain_ms={bwd_plain_ms:.4f} sdpa_bwd_ms={sdpa_bwd:.4f} "
                f"bound_ms={bwd_bound[0]:.5f} ({bwd_bound[1]})")
            if not fwd_err <= K4_FWD_TOL:
                raise AssertionError(f"{name} {stage} forward disagrees: {fwd_err}")
            bad = {n: e for n, e in rel.items() if not e <= K4_GRAD_RTOL}
            if bad or not same_bits:
                raise AssertionError(f"{name} {stage} backward: {bad}, same bits {same_bits}")
            fwd_bwd[name] = ms + bwd_ms
            if stage == "stage 0":
                entries[name] = {
                    "fwd": dict(max_abs_err=fwd_err, ms=ms, plain_ms=plain_ms,
                                bound_ms=fwd_bound[0], bound_by=fwd_bound[1],
                                library_ms=sdpa_fwd),
                    "bwd": dict(max_abs_err=bwd_err, ms=bwd_ms, plain_ms=bwd_plain_ms,
                                bound_ms=bwd_bound[0], bound_by=bwd_bound[1],
                                library_ms=sdpa_bwd),
                }
        say(f"[K4 {stage}] sdpa backend in f32 with a float attn_mask: {backend.name}; "
            f"sdpa fwd+bwd {sdpa_fb:.4f} ms, "
            + ", ".join(f"{n} fwd+bwd {t:.4f} ms" for n, t in fwd_bwd.items()))
        del q, k, v, do, add
        torch.cuda.empty_cache()
        k4_qkv_entry(torch, stage, nW, H, res, B, T, D, bounds, gen)
    return entries["K4a packed"], entries["K4b batched"]


def k4_qkv_entry(torch, stage, nW, H, res, B, T, D, bounds, gen):
    """The model's entry, swin_attention_qkv, on a (B nW, T, 3 H D)
    projection as models/swin.py gives it, in both variants: forward and
    backward against its plain version at K4's tolerances, dbias the same
    bits on a rerun, times beside the bound (the same bytes as the
    contracts') and SDPA on the same strided q, k, v; then two forwards and
    backwards under the profiler, whose kernel list must hold no copy, fill
    or add of q, k, v, o or their gradients (the batched variant runs the
    port's three kernels and nothing else; the packed one adds the
    additive term's own small kernels)."""
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.nn.attention import sdpa_kernel
    from torch.profiler import ProfilerActivity, profile

    from vit_reranking_tpu_torch.models.swin import _shift_attn_mask
    from vit_reranking_tpu_torch.ops import swin_attention as swa

    Bw, C = B * nW, H * D
    scale = D ** -0.5
    qkv = torch.randn(Bw, T, 3 * C, device="cuda", generator=gen)
    do = torch.randn(Bw, T, C, device="cuda", generator=gen)
    bias = torch.randn(H, T, T, device="cuda", generator=gen)
    mask = torch.from_numpy(_shift_attn_mask(res, res, 7, 3)).cuda()
    q4, k4, v4 = qkv.view(Bw, T, 3, H, D).permute(2, 0, 3, 1, 4)
    full_mask = bias[None] + mask.repeat(B, 1, 1)[:, None]
    backend = sdpa_backend(q4[:8], k4[:8], v4[:8], attn_mask=full_mask[:8], scale=scale)
    with sdpa_kernel([backend]):
        sdpa_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=full_mask, scale=scale), reps=5)
    del q4, k4, v4, full_mask
    for packed in (True, False):
        name = "K4a packed" if packed else "K4b batched"
        fwd_bound, bwd_bound = bounds[name]
        with switched([(swa, "SWIN_KERNEL_PACKED", packed)]):
            def run(entry):
                leaves = [qkv.clone().requires_grad_(), bias.clone().requires_grad_()]
                out = entry(*leaves, mask, scale, H, n_windows=nW)
                return leaves, out

            leaves, out = run(swa.swin_attention_qkv)
            grads = torch.autograd.grad(out, leaves, do, retain_graph=True)
            again = torch.autograd.grad(out, leaves, do, retain_graph=True)
            ref_leaves, ref = run(swa.swin_attention_qkv_plain)
            ref_grads = torch.autograd.grad(ref, ref_leaves, do, retain_graph=True)
            torch.cuda.synchronize()
            fwd_err = float((out - ref).abs().max())
            rel = {n: float((a - b).abs().max() / b.abs().max())
                   for n, a, b in zip(("dqkv", "dbias"), grads, ref_grads)}
            same_bits = torch.equal(grads[1], again[1])
            with torch.no_grad():
                ms = cuda_ms(torch, lambda: swa.swin_attention_qkv(qkv, bias, mask, scale, H,
                                                                   n_windows=nW), reps=10)
                plain_ms = cuda_ms(torch, lambda: swa.swin_attention_qkv_plain(
                    qkv, bias, mask, scale, H, n_windows=nW), reps=3)
            bwd_ms = cuda_ms(torch, lambda: torch.autograd.grad(out, leaves, do,
                                                                retain_graph=True), reps=10)
            bwd_plain_ms = cuda_ms(torch, lambda: torch.autograd.grad(
                ref, ref_leaves, do, retain_graph=True), reps=3)
            del ref, ref_grads, ref_leaves, grads, again
            say(f"[{name} qkv entry, {stage}: qkv ({Bw}, {T}, {3 * C}) H={H}] "
                f"max_abs_err={fwd_err:.3e} rel_err "
                + " ".join(f"{n}={e:.3e}" for n, e in rel.items())
                + f" same_bits_on_rerun={same_bits} fwd_ms={ms:.4f} "
                f"(plain {plain_ms:.4f}, sdpa {sdpa_ms:.4f}) bwd_ms={bwd_ms:.4f} "
                f"(plain {bwd_plain_ms:.4f}) bound_ms={fwd_bound[0]:.5f} / {bwd_bound[0]:.5f}")
            if not (fwd_err <= K4_FWD_TOL and all(e <= K4_GRAD_RTOL for e in rel.values())
                    and same_bits):
                raise AssertionError(f"{name} qkv entry, {stage}: {fwd_err}, {rel}, {same_bits}")
            leaves = [qkv.clone().requires_grad_(), bias.clone().requires_grad_()]
            torch.cuda.synchronize()
            # two passes: the tracer can miss the first launch of its window
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(2):
                    out = swa.swin_attention_qkv(*leaves, mask, scale, H, n_windows=nW)
                    torch.autograd.grad(out, leaves, do)
                torch.cuda.synchronize()
            del leaves, out
        kernels = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                total, count = kernels.get(e.name, (0.0, 0))
                kernels[e.name] = (total + e.time_range.end - e.time_range.start, count + 1)
        say(f"[{name} qkv entry, {stage}] every device kernel of two forwards and backwards: "
            + "; ".join(f"{n[:70]} {c}x {t / 1e3:.3f} ms"
                        for n, (t, c) in sorted(kernels.items(), key=lambda kv: -kv[1][0])))
        base = sorted(m.group(1) if (m := re.search(r"::(\w+)[<(]", n)) else n for n in kernels)
        if not packed and base != ["bwd_kernel", "fwd_kernel", "reduce_bias_kernel"]:
            raise AssertionError(f"the batched qkv entry ran other kernels: {list(kernels)}")
        if not {"fwd_kernel", "bwd_kernel"} <= set(base):
            raise AssertionError(f"{name} qkv entry: the profile shows no K4 launch")
    del qkv, do
    torch.cuda.empty_cache()


SWIN_TRAIN_ARGS = [
    "--dataset", "synthetic", "--arch", "swin_normalize", "--loss", "margin",
    "--batch_mining", "distance", "--bs", "112", "--samples_per_class", "2",
    "--n_epochs", "1", "--evalevery", "1", "--synthetic_classes", "8",
    "--synthetic_size", "224", "--embed_dim", "128", "--seed", "0", "--kernels", "8",
    "--device", "cuda",
]


def run_swin_train(torch, per_class, packed):
    """train_baseline --arch swin_normalize with the window kernels on
    (``packed`` picks the variant), that variant's launches counted."""
    from vit_reranking_tpu_torch.models import swin
    from vit_reranking_tpu_torch.ops import swin_attention as swa

    fn = swa.swin_window_attention_packed if packed else swa.swin_window_attention
    with switched([(swin, "USE_SWIN_WINDOW_KERNEL", True), (swa, "SWIN_KERNEL_PACKED", packed)]):
        return run_train(torch, SWIN_TRAIN_ARGS + ["--synthetic_per_class", str(per_class)], fn)


def phase_swin_train(torch):
    """The Swin-T training path: 384 images at batch 112, 3 steps and the
    in-train evaluation of the 384-image test split, packed kernels (K4a).
    Stages 0-2 run the kernel, 2 + 2 + 6 = 10 blocks; stage 3 (one window
    an image) materialises, as in the JAX package."""
    summary, launches, wall = run_swin_train(torch, per_class=48, packed=True)
    n_eval = -(-8 * 48 // 112)
    say(f"[swin-train] expected K4a launches: fwd {10 * (3 + n_eval)}, bwd 30")
    report_train("swin-train", summary, wall, "K4a", launches,
                 launches["fwd"] == 10 * (3 + n_eval) and launches["bwd"] == 30)
    return launches


def phase_swin_batched(torch):
    """The same path with the batched variant (K4b): 112 images, one step
    and one evaluation batch."""
    summary, launches, wall = run_swin_train(torch, per_class=14, packed=False)
    say("[swin-train-batched] expected K4b launches: fwd 20, bwd 10")
    report_train("swin-train-batched", summary, wall, "K4b", launches,
                 launches["fwd"] == 20 and launches["bwd"] == 10, steps=1)
    return launches


def phase_swin_ab(torch):
    """K4a (packed) and K4b (batched) against the materialising window
    attention (models/swin.py USE_SWIN_WINDOW_KERNEL off) at batch 112, and
    a profiled step of each variant: K4a and K4b launch the same window
    core, so their difference is the packed contract's additive term and
    its gradient."""
    from vit_reranking_tpu_torch.models import swin
    from vit_reranking_tpu_torch.ops import swin_attention as swa

    on = (swin, "USE_SWIN_WINDOW_KERNEL", True)
    variants = {"K4a packed": [on, (swa, "SWIN_KERNEL_PACKED", True)],
                "K4b batched": [on, (swa, "SWIN_KERNEL_PACKED", False)],
                "off (materialising)": [(swin, "USE_SWIN_WINDOW_KERNEL", False)]}
    ab_and_profile(torch, "swin-train", SWIN_TRAIN_ARGS + ["--synthetic_per_class", "14"],
                   variants, ("K4a packed", "K4b batched", "off (materialising)",
                              "off (materialising)", "K4b batched", "K4a packed"),
                   ("K4a packed", "K4b batched"),
                   ("fwd_kernel", "bwd_kernel", "reduce_add_kernel", "reduce_bias_kernel"),
                   top=40)


def phase_swin_reference(torch):
    """Full Swin-T (drop-path 0) with K4a on, card step against CPU step;
    the card step runs K4a in its 10 blocks each way."""
    from vit_reranking_tpu_torch.models import swin
    from vit_reranking_tpu_torch.ops import swin_attention as swa

    base = swin.SwinNetwork(embed_dim=128, drop_path_rate=0.0,
                            generator=torch.Generator().manual_seed(0))
    fn = swa.swin_window_attention_packed
    fn.fwd_launches = fn.bwd_launches = 0
    with switched([(swin, "USE_SWIN_WINDOW_KERNEL", True), (swa, "SWIN_KERNEL_PACKED", True)]):
        card_vs_cpu_step(torch, "swin-train-reference", base)
    if (fn.fwd_launches, fn.bwd_launches) != (10, 10):
        raise AssertionError(f"the card step did not run K4a in its 10 blocks: "
                             f"{(fn.fwd_launches, fn.bwd_launches)}")


VIT_ARGS = [
    "--dataset", "synthetic", "--synthetic_classes", "8", "--synthetic_per_class", "16",
    "--synthetic_size", "224", "--bs", "16", "--arch", "vit_normalize", "--embed_dim", "128",
    "--use_ot", "--grid_size", "14", "--seed", "0", "--device", "cuda",
]
VIT_QK_ARGS = VIT_ARGS + ["--use_qk", "--blk_ind", "0"]


def phase_vit(torch, tag, args):
    """test_diml_vit's run_eval at full DeiT-S (224 px, 196 patches, grid
    14, exact top-100, full OT) with K1's launch counts set to 0 just before
    and read just after: the qk method must launch mode (d), the featvit
    method K1 from S alone."""
    from vit_reranking_tpu_torch.ops.rerank import sinkhorn_scores

    sinkhorn_scores.launches = sinkhorn_scores.cost_launches = 0
    results, wall = run_main_path(torch, args)
    launches = {"sinkhorn_score": sinkhorn_scores.launches,
                "sinkhorn_score_cost": sinkhorn_scores.cost_launches}
    check_metrics(tag, results)
    say(f"[{tag}] run_eval {wall:.3f}s (first run), launches {launches}")
    qk = "--use_qk" in args
    if launches["sinkhorn_score"] <= 0 or (launches["sinkhorn_score_cost"] > 0) != qk:
        raise AssertionError(f"{tag}: K1 was not launched as the path needs: {launches}")
    return launches


def phase_vit_profile(torch):
    """A second, warm run of the qk path under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = run_main_path(torch, VIT_QK_ARGS)
    report_profile("vit-profile", "warm qk run_eval", wall, prof, top=12,
                   port_kernels=("sinkhorn_",))


def phase_vit_reference(torch):
    """Full DeiT-S forward (with block 0's q and k) on the card against the
    CPU, same weights and images."""
    from vit_reranking_tpu_torch.models.vit import ViTNetwork

    model = ViTNetwork(embed_dim=128, generator=torch.Generator().manual_seed(0)).eval()
    x = torch.randn(2, 3, 224, 224, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref = model(x, ret_attn=True)
        out = model.cuda()(x.cuda(), ret_attn=True)
    errs = {}
    for name, a, b in (("embed", out[0], ref[0]),
                       *((k, out[2][k], ref[2][k]) for k in ("head_tokens", "q", "k"))):
        a = a.cpu()
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError(f"{name}: shape {tuple(a.shape)} or non-finite values")
        errs[name] = float((a - b).abs().max())
    say("[vit-reference] card vs CPU DeiT-S forward, max abs err: "
        + ", ".join(f"{k}={v:.3e}" for k, v in errs.items()))
    bad = {k: v for k, v in errs.items() if not v <= FWD_TOL}
    if bad:
        raise AssertionError(f"card and CPU DeiT-S forward disagree beyond {FWD_TOL}: {bad}")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this check runs on the card",
              file=sys.stderr)
        return 1
    from vit_reranking_tpu_torch.ops import native

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_host(torch, native)
    phase_build(native)
    k1, k1_group = phase_k1(torch)
    k2 = phase_k2(torch)
    k3 = phase_k3(torch)
    launches = phase_main(torch)
    phase_profile(torch)
    phase_reference(torch)
    sop_launches = phase_sop(torch)
    k3_launches = phase_train(torch)
    phase_train_profile(torch)
    phase_train_reference(torch)
    phase_k3_head_dims(torch)
    k4a, k4b = phase_k4(torch)
    k4a_launches = phase_swin_train(torch)
    k4b_launches = phase_swin_batched(torch)
    phase_swin_ab(torch)
    phase_swin_reference(torch)
    k1_qk = phase_k1_large(torch)
    qk_launches = phase_vit(torch, "vit-qk", VIT_QK_ARGS)
    phase_vit(torch, "vit-featvit", VIT_ARGS)
    phase_vit_profile(torch)
    phase_vit_reference(torch)
    kernels = [
        dict(name="sinkhorn_score", route="cuda",
             source="vit_reranking_tpu_torch/csrc/sinkhorn_score.cu",
             replaces="vit_reranking_tpu/ops/rerank_pallas.py:97",
             launches=launches["sinkhorn_score"], **k1),
        dict(name="filter_threshold", route="cuda",
             source="vit_reranking_tpu_torch/csrc/filter_threshold.cu",
             replaces="vit_reranking_tpu/ops/rollout.py:29",
             launches=launches["filter_threshold"], **k2),
        dict(name="kv_attention_fwd", route="cuda",
             source="vit_reranking_tpu_torch/csrc/kv_attention.cu",
             replaces="vit_reranking_tpu/ops/attention_pallas.py:48",
             launches=k3_launches["fwd"], **k3["fwd"]),
        dict(name="kv_attention_bwd", route="cuda",
             source="vit_reranking_tpu_torch/csrc/kv_attention.cu",
             replaces="vit_reranking_tpu/ops/attention_pallas.py:66",
             launches=k3_launches["bwd"], **k3["bwd"]),
        dict(name="swin_attention_packed_fwd", route="cuda",
             source="vit_reranking_tpu_torch/csrc/swin_attention.cu",
             replaces="vit_reranking_tpu/ops/swin_attention_pallas.py:218",
             launches=k4a_launches["fwd"], **k4a["fwd"]),
        dict(name="swin_attention_packed_bwd", route="cuda",
             source="vit_reranking_tpu_torch/csrc/swin_attention.cu",
             replaces="vit_reranking_tpu/ops/swin_attention_pallas.py:234",
             launches=k4a_launches["bwd"], **k4a["bwd"]),
        dict(name="swin_window_attention_fwd", route="cuda",
             source="vit_reranking_tpu_torch/csrc/swin_attention.cu",
             replaces="vit_reranking_tpu/ops/swin_attention_pallas.py:77",
             launches=k4b_launches["fwd"], **k4b["fwd"]),
        dict(name="swin_window_attention_bwd", route="cuda",
             source="vit_reranking_tpu_torch/csrc/swin_attention.cu",
             replaces="vit_reranking_tpu/ops/swin_attention_pallas.py:88",
             launches=k4b_launches["bwd"], **k4b["bwd"]),
        dict(name="sinkhorn_score_cost", route="cuda",
             source="vit_reranking_tpu_torch/csrc/sinkhorn_score.cu",
             replaces="vit_reranking_tpu/ops/rerank_pallas.py:115",
             launches=qk_launches["sinkhorn_score_cost"], **k1_qk),
        dict(name="sinkhorn_score_group", route="cuda",
             source="vit_reranking_tpu_torch/csrc/sinkhorn_score.cu",
             replaces="vit_reranking_tpu/ops/rerank_pallas.py:169",
             launches=sop_launches["sinkhorn_score_group"], **k1_group),
    ]
    say(f"[done] {time.perf_counter() - t_start:.3f}s in all")
    say(json.dumps({"kernels": kernels}))
    say(gpu_name_and_limit())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
