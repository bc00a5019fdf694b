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
    the batched variant, K4b (on the card the entry runs the same kernels
    from bias and mask under either variant, counted as the variant's);
  * the reference's default training precision: K3 and K4 in bf16 against
    their plain versions at CvT-13 stage 0 and Swin-T stage 0, then
    train_baseline on its card defaults (bf16 activations, narrowed
    softmax) for CvT-13 (K3's bf16 form) and Swin-T with the window
    kernels on (K4a's bf16 form; K4b's in one step), each against its f32
    step in turns, and one bf16 CvT-13 step against the CPU's (the f32
    phases above pass --no-bf16 --no-narrow_sm);
  * DeiT-S evaluation: test_diml_vit (full DeiT-S with embed_dim 128 at
    224 px, --grid_size 14 so R = 196 rerank patches, exact top-100, full
    OT, 128 synthetic images) with the qk method, carried by K1's
    separate-cost mode (d), and with the featvit method, carried by K1's
    modes from S; K1 is held against its plain version at R = 196 in both;
  * the repo's SOP recipe (scripts/diml/test_diml_cvt_sop.sh: CvT-13,
    rollout, --ot_part 0.9) on the evaluation's synthetic set, carried by
    K1's group exit (one query's candidates frozen together), held against
    the eager rerank of the same features;
  * the repo's recipes on image trees, in a temporary directory: a
    CUB200-layout tree of JPEGs and a stand-in of the reference's ImageNet
    CvT-13 checkpoint (tests/manifests/cvt13.json's keys and shapes, seeded
    values), trained on with scripts/baselines/cub_reprod.sh's flags for 2
    epochs on the card's default bf16 (K3's bf16 form), resumed from
    `latest`, and its `best` evaluated with scripts/diml/test_diml_cvt.sh's
    flags, twice (K1, K2); then an SOP-layout tree evaluated from a Swin-T
    stand-in with scripts/diml/test_diml_swin.sh's flags (K1);
  * the device-resident image pools (--cache_device) on that CUB tree: the
    same recipe trained with its batches gathered and augmented on the card
    (K3's bf16 form; the augmentation held against its CPU version; host
    seconds a step from the loader and from the pool, in turns), and its
    `best` evaluated from the loader and from the pool in turns (K1, K2;
    the metrics within 1e-3 points);
  * DeiT-S training on the card's default precision (bf16, narrowed
    softmax; no port kernel: its attention materialises), against --no-bf16
    in turns and one step against the CPU's; and the CvT evaluation with
    --bf16, rollout (K2, K1) and featvit (K3's bf16 forward, K1), beside f32;
  * ResNet-50 and the DIML recipes: train_baseline on a ResNet-50 (bf16)
    from a stand-in of the ImageNet checkpoint, its `best` evaluated with
    scripts/diml/test_diml.sh's flags (the script's eager Sinkhorn, and
    with --use_ot K1 at R = 16 on the 2048-d map), train_diml on
    ResNet-50-DIML and CvT-DIML (margin_diml; K1 in the in-train featvit
    evaluation, K3's bf16 form in CvT-DIML; a warm step's host syncs and
    busy share), and one f32 ResNet-50-DIML step against the CPU's;
  * MSLS place recognition: test_msls_baseline --use_ot (full-width CvT-13
    with embed_dim 128 at 224 px on the synthetic MSLS set: global recall
    and the query != gallery featvit rerank, K1), msls_val at a 256-query
    tile (K1 held against its plain version there), and
    train_msls_baseline with scripts/baselines/msls_train.sh's flags on a
    written city of 640x480 JPEGs at 224 x 224 (hard-negative mining with
    the current model, triplet steps of 16 x 7 images, validation) in the
    JAX CLI's f32 (K3 forward and backward) and with --bf16 (K3's bf16
    form), and one f32 MSLS step against the CPU's.

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
import statistics
import subprocess
import sys
import tempfile
import time

# published H100 SXM peaks, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12  # f32 outside the tensor cores (SIMT)
TF32_OPS_PER_S = 495e12  # TF32 on the tensor cores, dense
BF16_OPS_PER_S = 989e12  # bf16 on the tensor cores, dense

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
# the bf16 forms of K3 and K4 vs their plain versions, of the largest
# magnitude: both round p and ds to bf16 from f32 values summed in another
# order, so a value can land one bf16 step (2^-8 relative) apart
BF16_FWD_TOL = 1e-2
BF16_GRAD_TOL = 2e-2
# card vs CPU bf16 train step: the CPU tests' bf16 bars (tests/test_torch_bf16.py)
BF16_STEP_LOSS_RTOL = 1e-2
BF16_STEP_GRAD_RTOL = 5e-2
# the pool's augmentation on the card vs its plain CPU version on the same
# draws (the CPU tests hold the plain version within 1e-5 of the JAX package)
AUG_TOL = 1e-5
# evaluations from the loader and from the resident pool
# (tests/test_device_cache.py:236)
METRIC_POINTS = 1e-3


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
        log = native.BUILD_DIR / f"{name}.log"
        if log.exists():  # ptxas's warnings, e.g. wgmma products it serialised
            for line in log.read_text().splitlines():
                if "Performance Loss" in line or "warning" in line:
                    say(f"[build] {name}: {line.strip()[:300]}")


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


def k1_check(torch, tag, S, u, v, Q, K, ranks=True, **kw):
    """Kernel K1 against its plain version on Q x K pairs (S, u, v and, for
    mode (d), ``kw["cost"]``): max error, identical rankings (see
    :func:`k1_ranks`; with ``ranks`` False only reported, for inputs whose
    candidates tie at f32 rounding), under group exit the same exit
    iteration for every group, kernel and plain ms, and the bound from the
    iterations each pair ran."""
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
    for note in notes[:5]:
        say(f"[{tag}] {note}")
    if len(notes) > 5:
        say(f"[{tag}] ... and {len(notes) - 5} more queries whose orders part")
    if not (err <= K1_TOL and (exact or not ranks) and math.isfinite(err)):
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


# the CvT-13 recipe on its card defaults (bf16 activations, narrowed
# softmax), and the same in f32 for the f32 phases
TRAIN_BF16_ARGS = [
    "--dataset", "synthetic", "--arch", "cvt_13_normalize", "--loss", "margin",
    "--batch_mining", "distance", "--bs", "112", "--samples_per_class", "2",
    "--n_epochs", "1", "--evalevery", "1", "--synthetic_classes", "8",
    "--synthetic_per_class", "48", "--synthetic_size", "224", "--embed_dim", "128",
    "--seed", "0", "--kernels", "8", "--device", "cuda",
]
F32 = ["--no-bf16", "--no-narrow_sm"]
TRAIN_ARGS = TRAIN_BF16_ARGS + F32
COUNTERS = ("fwd", "bwd", "fwd_bf16", "bwd_bf16")


def run_train(torch, args, counted, cli=None, save_path=None):
    """``cli.main(args)`` (train_baseline unless another training CLI is
    given) from a scratch working directory with --save_path there (or at
    ``save_path``, which outlives the call), the launch counts of
    ``counted`` (a kernel wrapper; f32 and bf16) set to 0 just before and
    read just after.  Returns (summary, launches, wall seconds)."""
    from vit_reranking_tpu_torch.cli import train_baseline

    cli = cli or train_baseline
    with scratch_cwd() as work:
        for c in COUNTERS:
            setattr(counted, f"{c}_launches", 0)
        t0 = time.perf_counter()
        summary = cli.main(args + ["--save_path", save_path or os.path.join(work, "runs")])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return summary, {c: getattr(counted, f"{c}_launches") for c in COUNTERS}, wall


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


def ab_and_profile(torch, tag, args, variants, order, profiled, port_kernels, top=15,
                   flags=None):
    """Warm train steps at ``args``'s configuration (its card defaults, see
    core/config.py::resolve_precision) under each of ``variants`` (label ->
    module settings, see :func:`switched`) in the turns of ``order``, each
    turn 3 timed steps after a warm-up, with its median and peak memory;
    then one step of each label in ``profiled`` under torch.profiler.  A
    label with command-line ``flags`` of its own (label -> list) trains a
    state built from ``args`` plus them, from the same seed and batch."""
    from torch.profiler import ProfilerActivity, profile

    from vit_reranking_tpu_torch.cli.common import build_training, run_train_step
    from vit_reranking_tpu_torch.core.config import from_args, resolve_precision
    from vit_reranking_tpu_torch.data.loader import build_dataset

    flags = flags or {}
    states = {}
    for label in variants:
        key = tuple(flags.get(label, ()))
        if key not in states:
            opt = resolve_precision(from_args(args + list(key)))
            loaders, _ = build_dataset(opt)
            lab, images, _ = next(iter(loaders["training"]))
            states[key] = build_training(opt, len(loaders["training"]), torch.device("cuda"))[2]
    gen = torch.Generator(device="cuda").manual_seed(1)

    def step(label):
        state = states[tuple(flags.get(label, ()))]
        return run_train_step(state, lab, images, gen, "cuda")

    def timed_steps(label, n=3):
        with switched(variants[label]):
            step(label)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(n):
                t0 = time.perf_counter()
                float(step(label)["loss"])
                times.append(time.perf_counter() - t0)
            return sorted(times)[n // 2], torch.cuda.max_memory_allocated() / 2**30

    ab = [(label, *timed_steps(label)) for label in order]
    say(f"[{tag}-ab] warm step median s / peak GiB: "
        + ", ".join(f"{label} {t:.4f} s {m:.2f} GiB" for label, t, m in ab))
    for label in profiled:
        with switched(variants[label]):
            step(label)  # warm-up
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                step(label)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        report_profile(f"{tag}-profile", f"one warm step, {label},", wall, prof, top=top,
                       port_kernels=port_kernels)
    del states
    torch.cuda.empty_cache()


def phase_train_profile(torch):
    """K3 against the materialising attention (models/cvt.py
    USE_KV_RESIDENT_ATTENTION off), and a profiled step."""
    from vit_reranking_tpu_torch.models import cvt

    switch = "USE_KV_RESIDENT_ATTENTION"
    ab_and_profile(torch, "train", TRAIN_ARGS,
                   {"K3 on": [(cvt, switch, True)], "off (materialising)": [(cvt, switch, False)]},
                   ("K3 on", "off (materialising)", "off (materialising)", "K3 on"), ("K3 on",),
                   ("dkdv_kernel", "dq_kernel", "fwd_kernel", "delta_kernel"))


def card_vs_cpu_step(torch, tag, base, rtol=None, loss_cls=None):
    """One train step of ``base`` on the card against the same step on the
    CPU: a copy of the same weights on each, 4 images at 224 px, fixed
    triplets, Adam with two groups, the margin loss (or ``loss_cls``);
    loss and gradient norm compared at ``rtol`` (by key; STEP_RTOL for both
    by default)."""
    rtol = rtol or {"loss": STEP_RTOL, "grad_l2": STEP_RTOL}
    import copy
    from types import SimpleNamespace

    from vit_reranking_tpu_torch.engine.train import init_train_state, make_optimizer, train_step
    from vit_reranking_tpu_torch.losses.margin import MarginLoss
    from vit_reranking_tpu_torch.miners.common import Triplets

    loss_cls = loss_cls or MarginLoss

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
        crit = loss_cls(opt, FixedMiner()).to(device)
        optim = make_optimizer("adam", 4e-4, {"model": list(model.parameters()),
                                              "criterion": list(crit.parameters())},
                               {"model": 1e-5, "criterion": 5e-4})
        m = train_step(init_train_state(model, crit, optim), x.to(device), labels.to(device))
        return {k: float(v) for k, v in m.items()}

    card, cpu = one_step("cuda"), one_step("cpu")
    rel = {k: abs(card[k] - cpu[k]) / abs(cpu[k]) for k in ("loss", "grad_l2")}
    say(f"[{tag}] card {card} cpu {cpu} rel_err "
        + " ".join(f"{k}={v:.3e}" for k, v in rel.items()))
    bad = {k: v for k, v in rel.items() if not v <= rtol[k]}
    if bad or not all(math.isfinite(v) for v in card.values()):
        raise AssertionError(f"card and CPU train steps disagree beyond {rtol}: {bad}")


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
    same shapes (:func:`k4_qkv_entry`).  Returns K4a's rows (the qkv entry's
    numbers and the packed contract's, :func:`entry_rows`) and K4b's."""
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
        entry = k4_qkv_entry(torch, stage, nW, H, res, B, T, D, bounds, gen)
        if stage == "stage 0":
            entries["qkv entry"] = entry
    return entry_rows(entries["qkv entry"], entries["K4a packed"]), entries["K4b batched"]


def k4_qkv_entry(torch, stage, nW, H, res, B, T, D, bounds, gen):
    """The model's entry, swin_attention_qkv, on a (B nW, T, 3 H D)
    projection as models/swin.py gives it and calls it (``SWIN_KERNEL_PACKED``
    on; the batched setting launches the same kernels and only counts them
    apart): forward and backward against its plain version at K4's
    tolerances, dbias the same bits on a rerun, times beside the bound (the
    same bytes as the batched contract's: bias and mask) and SDPA on the
    same strided q, k, v; then four forwards and backwards under the
    profiler, whose kernel list must be the port's three kernels and nothing
    else (no additive term is built, and no copy, fill or add of q, k, v, o
    or their gradients).  Returns the forward's and backward's numbers for
    the kernels JSON."""
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

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
    sdpa_leaves = [t.detach().requires_grad_() for t in (q4, k4, v4)]
    with sdpa_kernel([backend]):
        o4 = F.scaled_dot_product_attention(*sdpa_leaves, attn_mask=full_mask, scale=scale)
        sdpa_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=full_mask, scale=scale), reps=5)
        sdpa_bwd_ms = cuda_ms(torch, lambda: torch.autograd.grad(
            o4, sdpa_leaves, do.view(Bw, T, H, D).transpose(1, 2), retain_graph=True), reps=5)
    del q4, k4, v4, o4, full_mask, sdpa_leaves
    tag = f"K4a packed qkv entry, {stage}"
    fwd_bound, bwd_bound = bounds["K4b batched"]  # the entry runs from bias and mask
    with switched([(swa, "SWIN_KERNEL_PACKED", True)]):
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
        bwd_err = max(float((a - b).abs().max()) for a, b in zip(grads, ref_grads))
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
        say(f"[{tag}: qkv ({Bw}, {T}, {3 * C}) H={H}] "
            f"max_abs_err={fwd_err:.3e} / {bwd_err:.3e} rel_err "
            + " ".join(f"{n}={e:.3e}" for n, e in rel.items())
            + f" same_bits_on_rerun={same_bits} fwd_ms={ms:.4f} "
            f"(plain {plain_ms:.4f}, sdpa {sdpa_ms:.4f}) bwd_ms={bwd_ms:.4f} "
            f"(plain {bwd_plain_ms:.4f}, sdpa {sdpa_bwd_ms:.4f}) "
            f"bound_ms={fwd_bound[0]:.5f} / {bwd_bound[0]:.5f}")
        if not (fwd_err <= K4_FWD_TOL and all(e <= K4_GRAD_RTOL for e in rel.values())
                and same_bits):
            raise AssertionError(f"{tag}: {fwd_err}, {rel}, {same_bits}")
        leaves = [qkv.clone().requires_grad_(), bias.clone().requires_grad_()]
        kernels = profiled_kernels(torch, lambda: torch.autograd.grad(
            swa.swin_attention_qkv(*leaves, mask, scale, H, n_windows=nW), leaves, do))
        del leaves, out
    say(f"[{tag}] every device kernel of four forwards and backwards: "
        + "; ".join(f"{n[:70]} {c}x {t / 1e3:.3f} ms"
                    for n, (t, c) in sorted(kernels.items(), key=lambda kv: -kv[1][0])))
    check_kernel_list(tag, kernels, ["bwd_kernel", "fwd_kernel", "reduce_bias_kernel"])
    del qkv, do
    torch.cuda.empty_cache()
    return {"fwd": dict(max_abs_err=fwd_err, ms=ms, plain_ms=plain_ms, bound_ms=fwd_bound[0],
                        bound_by=fwd_bound[1], library_ms=sdpa_ms),
            "bwd": dict(max_abs_err=bwd_err, ms=bwd_ms, plain_ms=bwd_plain_ms,
                        bound_ms=bwd_bound[0], bound_by=bwd_bound[1], library_ms=sdpa_bwd_ms)}


def device_kernels(prof):
    """{name: (microseconds, launches)} of the device kernels in a profile."""
    from torch.autograd import DeviceType

    kernels = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            total, count = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (total + e.time_range.end - e.time_range.start, count + 1)
    return kernels


def device_ms(torch, fn, kernels, reps=10):
    """Device milliseconds one call of ``fn`` spends in the kernels whose
    names contain each of ``kernels``, from the profiler (each kernel's
    durations summed over its own launches): the kernels' time without the
    host's between calls, which CUDA events around back-to-back calls count
    where a call's host work outlasts its kernels."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    found = device_kernels(prof)
    total = 0.0
    for part in kernels:
        hits = [tc for n, tc in found.items() if part in n]
        if not hits:
            raise AssertionError(f"the profile shows no {part} launch: {list(found)}")
        total += sum(t for t, _ in hits) / sum(c for _, c in hits)
    return total / 1e3


def profiled_kernels(torch, fn, passes=4):
    """:func:`device_kernels` of ``passes`` calls of ``fn`` under the
    profiler, synchronised after each: the tracer can drop a launch (one of
    two launches of a kernel was seen in some runs, none in one), so a
    kernel list is read over several passes."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(passes):
            fn()
            torch.cuda.synchronize()
    return device_kernels(prof)


def check_kernel_list(tag, kernels, want):
    """The profiled device kernels of an entry must be exactly ``want``
    (base names): the port's kernels and no copy, fill or add."""
    base = sorted(m.group(1) if (m := re.search(r"::(\w+)[<(]", n)) else n for n in kernels)
    if base != want:
        raise AssertionError(f"{tag} ran other kernels than {want}: {list(kernels)}")


SWIN_TRAIN_BF16_ARGS = [
    "--dataset", "synthetic", "--arch", "swin_normalize", "--loss", "margin",
    "--batch_mining", "distance", "--bs", "112", "--samples_per_class", "2",
    "--n_epochs", "1", "--evalevery", "1", "--synthetic_classes", "8",
    "--synthetic_size", "224", "--embed_dim", "128", "--seed", "0", "--kernels", "8",
    "--device", "cuda",
]
SWIN_TRAIN_ARGS = SWIN_TRAIN_BF16_ARGS + F32


def run_swin_train(torch, per_class, packed, base=SWIN_TRAIN_ARGS):
    """train_baseline --arch swin_normalize with the window kernels on
    (``packed`` picks the variant), that variant's launches counted."""
    from vit_reranking_tpu_torch.models import swin
    from vit_reranking_tpu_torch.ops import swin_attention as swa

    fn = swa.swin_window_attention_packed if packed else swa.swin_window_attention
    with switched([(swin, "USE_SWIN_WINDOW_KERNEL", True), (swa, "SWIN_KERNEL_PACKED", packed)]):
        return run_train(torch, base + ["--synthetic_per_class", str(per_class)], fn)


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
    and one evaluation batch.  The qkv entry launches the same kernels as
    under the packed variant; this short run gives K4b's rows their
    launches on the main path, counted under K4b's counters."""
    summary, launches, wall = run_swin_train(torch, per_class=14, packed=False)
    say("[swin-train-batched] expected K4b launches: fwd 20, bwd 10")
    report_train("swin-train-batched", summary, wall, "K4b", launches,
                 launches["fwd"] == 20 and launches["bwd"] == 10, steps=1)
    return launches


def phase_swin_ab(torch):
    """The window kernels (K4a, as the model calls them) against the
    materialising window attention (models/swin.py USE_SWIN_WINDOW_KERNEL
    off) at batch 112, and a profiled step with the kernels.  The batched
    setting is not a turn of its own: the model's qkv entry launches the
    same window core from bias and mask under either setting."""
    from vit_reranking_tpu_torch.models import swin
    from vit_reranking_tpu_torch.ops import swin_attention as swa

    variants = {"K4a packed": [(swin, "USE_SWIN_WINDOW_KERNEL", True),
                               (swa, "SWIN_KERNEL_PACKED", True)],
                "off (materialising)": [(swin, "USE_SWIN_WINDOW_KERNEL", False)]}
    ab_and_profile(torch, "swin-train", SWIN_TRAIN_ARGS + ["--synthetic_per_class", "14"],
                   variants, ("K4a packed", "off (materialising)", "off (materialising)",
                              "K4a packed"),
                   ("K4a packed",), ("fwd_kernel", "bwd_kernel", "reduce_bias_kernel"),
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


# ---- the bf16 recipe: K3 and K4 in bf16, the default training precision ----------

def rel_err(a, b):
    """Largest |a - b| over the largest |b|, in f32."""
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


# K3's bf16 kernels (csrc/kv_attention_bf16.cu) and the products of T Tkv D
# multiply-adds each runs
K3_BF16_KERNELS = {"wgmma_fwd_kernel": 3, "wgmma_dq_kernel": 5, "wgmma_dkdv_kernel": 4}


def phase_k3_bf16(torch):
    """K3's bf16 form against its plain version (the TPU kernel's rounding
    points, explicit backward) at CvT-13 stage 0 and batch 112, the backward
    twice for the same bits, with SDPA in bf16 (flash; cuDNN beside it) as
    the yardstick, and each kernel's device time and product rate."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.profiler import ProfilerActivity, profile

    from vit_reranking_tpu_torch.ops.attention import (
        kv_resident_attention, kv_resident_attention_plain,
    )

    BH, T, Tkv, D = 112, 3136, 784, 64
    scale = D ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(12)
    q, do = (torch.randn(BH, T, D, device="cuda", generator=gen).bfloat16() for _ in range(2))
    k, v = (torch.randn(BH, Tkv, D, device="cuda", generator=gen).bfloat16() for _ in range(2))
    with torch.no_grad():
        out = kv_resident_attention(q, k, v, scale)
        ref = kv_resident_attention_plain(q, k, v, scale)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    og = kv_resident_attention(*leaves, scale)
    grads = torch.autograd.grad(og, leaves, do, retain_graph=True)
    again = torch.autograd.grad(og, leaves, do, retain_graph=True)
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ro = kv_resident_attention_plain(*ref_leaves, scale)
    ref_grads = torch.autograd.grad(ro, ref_leaves, do, retain_graph=True)
    torch.cuda.synchronize()
    fwd_err = rel_err(out, ref)
    rel = {n: rel_err(a, b) for n, a, b in zip(("dq", "dk", "dv"), grads, ref_grads)}
    abs_fwd = float((out.float() - ref.float()).abs().max())
    abs_bwd = max(float((a.float() - b.float()).abs().max()) for a, b in zip(grads, ref_grads))
    same_bits = all(torch.equal(a, b) for a, b in zip(grads, again))
    del ref, ref_grads, again

    backend = sdpa_backend(q[:1, None], k[:1, None], v[:1, None], scale=scale)
    q4, k4, v4 = (t.view(BH, 1, -1, D).clone().requires_grad_() for t in (q, k, v))
    with sdpa_kernel([backend]):
        o4 = F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
        sdpa_fwd_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q4.detach(), k4.detach(), v4.detach(), scale=scale), reps=10)
        sdpa_bwd_ms = cuda_ms(torch, lambda: torch.autograd.grad(
            o4, (q4, k4, v4), do.view(BH, 1, T, D), retain_graph=True), reps=10)
    del q4, k4, v4, o4
    with torch.no_grad():
        fwd_ms = cuda_ms(torch, lambda: kv_resident_attention(q, k, v, scale), reps=20)
        fwd_plain_ms = cuda_ms(torch, lambda: kv_resident_attention_plain(q, k, v, scale), reps=3)
    bwd_ms = cuda_ms(torch, lambda: torch.autograd.grad(og, leaves, do, retain_graph=True),
                     reps=10)
    bwd_plain_ms = cuda_ms(torch, lambda: torch.autograd.grad(ro, ref_leaves, do,
                                                              retain_graph=True), reps=3)
    # each kernel's device time (csrc/kv_attention_bf16.cu), and the rate of
    # its own products: 3 of T Tkv D forward, 5 in the dQ pass and 4 in the
    # dK/dV pass (the TPU kernel's rounding points recompute S and dP)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            with torch.no_grad():
                kv_resident_attention(q, k, v, scale)
            torch.autograd.grad(og, leaves, do, retain_graph=True)
        torch.cuda.synchronize()
    sums = {}  # device microseconds and launches, by kernel
    for e in prof.key_averages():
        for kern in K3_BF16_KERNELS:
            if kern in e.key:
                total, count = sums.get(kern, (0.0, 0))
                sums[kern] = (total + e.device_time_total, count + e.count)
    macs = T * Tkv * D * BH
    per = {kern: total / count / 1e3 for kern, (total, count) in sums.items() if count}
    rates = " ".join(f"{kern} {t:.4f} ms = {2 * K3_BF16_KERNELS[kern] * macs / t / 1e9:.1f} "
                     f"TFLOP/s" for kern, t in per.items())
    own = {"fwd": 2 * 3 * macs / fwd_ms / 1e9, "bwd": 2 * 9 * macs / bwd_ms / 1e9}
    # SDPA's cuDNN backend beside flash, where it takes these inputs
    try:
        q4c, k4c, v4c = (t.view(BH, 1, -1, D).clone().requires_grad_() for t in (q, k, v))
        with sdpa_kernel([SDPBackend.CUDNN_ATTENTION]):
            o4c = F.scaled_dot_product_attention(q4c, k4c, v4c, scale=scale)
            cudnn_fwd = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                q4c.detach(), k4c.detach(), v4c.detach(), scale=scale), reps=10)
            cudnn_bwd = cuda_ms(torch, lambda: torch.autograd.grad(
                o4c, (q4c, k4c, v4c), do.view(BH, 1, T, D), retain_graph=True), reps=10)
        cudnn = f"sdpa cuDNN bf16 fwd {cudnn_fwd:.4f} ms, bwd {cudnn_bwd:.4f} ms"
        del q4c, k4c, v4c, o4c
    except RuntimeError as err:
        cudnn = f"sdpa cuDNN bf16 not run ({str(err).splitlines()[0][:80]})"
    del ro, ref_leaves, og, leaves
    # bytes: bf16 q, k, v (and dO) read once, bf16 o (dq, dk, dv) written
    # once, lse (and delta) f32; work: the function's 2 (forward) and 5
    # (backward) products of T Tkv D multiply-adds, at the dense bf16 rate
    elem, rows = 2, BH * T
    fwd_bytes = (q.numel() * 2 + k.numel() * 2) * elem + rows * 4
    bwd_bytes = (q.numel() * 4 + k.numel() * 4) * elem + rows * 4
    fwd_bound = bound(fwd_bytes, 4 * T * Tkv * D * BH, BF16_OPS_PER_S)
    bwd_bound = bound(bwd_bytes, 10 * T * Tkv * D * BH, BF16_OPS_PER_S)
    say(f"[K3 bf16 fwd BH={BH} T={T} Tkv={Tkv} D={D}] rel_err={fwd_err:.3e} "
        f"(max_abs_err={abs_fwd:.3e}) kernel_ms={fwd_ms:.4f} plain_ms={fwd_plain_ms:.4f} "
        f"sdpa_bf16_ms={sdpa_fwd_ms:.4f} bound_ms={fwd_bound[0]:.5f} ({fwd_bound[1]}, "
        f"{fwd_bound[0] / fwd_ms * 100:.1f}% of it); its 3 products at {own['fwd']:.1f} TFLOP/s")
    say(f"[K3 bf16 bwd BH={BH} T={T} Tkv={Tkv} D={D}] rel_err "
        + " ".join(f"{n}={e:.3e}" for n, e in rel.items())
        + f" (max_abs_err={abs_bwd:.3e}) same_bits_twice={same_bits} kernel_ms={bwd_ms:.4f} "
        f"plain_ms={bwd_plain_ms:.4f} sdpa_bf16_bwd_ms={sdpa_bwd_ms:.4f} "
        f"bound_ms={bwd_bound[0]:.5f} ({bwd_bound[1]}, {bwd_bound[0] / bwd_ms * 100:.1f}% of it); "
        f"its 9 products at {own['bwd']:.1f} TFLOP/s")
    say(f"[K3 bf16] device time by kernel: {rates}; {cudnn}")
    say(f"[K3 bf16] sdpa backend in bf16: {backend.name}")
    if not fwd_err <= BF16_FWD_TOL:
        raise AssertionError(f"K3 bf16 forward disagrees with its plain version: {fwd_err}")
    bad = {n: e for n, e in rel.items() if not e <= BF16_GRAD_TOL}
    if bad or not same_bits:
        raise AssertionError(f"K3 bf16 backward: {bad}, same bits {same_bits}")
    return {
        "fwd": dict(max_abs_err=abs_fwd, ms=fwd_ms, plain_ms=fwd_plain_ms,
                    bound_ms=fwd_bound[0], bound_by=fwd_bound[1], library_ms=sdpa_fwd_ms),
        "bwd": dict(max_abs_err=abs_bwd, ms=bwd_ms, plain_ms=bwd_plain_ms,
                    bound_ms=bwd_bound[0], bound_by=bwd_bound[1], library_ms=sdpa_bwd_ms),
    }


def phase_k4_bf16(torch):
    """K4's bf16 form (csrc/swin_attention_bf16.cu) at Swin-T stage 0 and
    batch 112 (G=336, nW=64, T=49, D=32, the shifted-window mask): the
    packed (K4a) and batched (K4b) contracts against their plain versions,
    forward and backward, the gradients the same bits on a rerun, with SDPA
    in bf16 over the same windows (float mask) as the yardstick; then the
    model's qkv entry at stages 0, 1 and 2 (:func:`k4_bf16_qkv_entry`)."""
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    from vit_reranking_tpu_torch.models.swin import _shift_attn_mask
    from vit_reranking_tpu_torch.ops import swin_attention as swa

    T, D, B, nW, H, res = 49, 32, 112, 64, 3, 56
    G, scale = H * B, D ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(14)
    q, k, v, do = (torch.randn(G, nW, T, D, device="cuda", generator=gen).bfloat16()
                   for _ in range(4))
    bias = torch.randn(H, T, T, device="cuda", generator=gen)
    mask = torch.from_numpy(_shift_attn_mask(res, res, 7, 3)).cuda()
    P = swa._pick_pack_packed(nW, T)
    nblk, PT = nW // P, P * T
    add = swa._packed_add_term(bias, mask, P, nblk).contiguous()
    pshape = (G, nblk, PT, D)

    q4, k4, v4 = (t.view(G * nW, 1, T, D).clone().requires_grad_() for t in (q, k, v))
    full_mask = (bias.repeat_interleave(B, dim=0)[:, None] + mask[None]).view(
        G * nW, 1, T, T).bfloat16()
    backend = sdpa_backend(q4[:8], k4[:8], v4[:8], attn_mask=full_mask[:8], scale=scale)
    with sdpa_kernel([backend]):
        o4 = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=full_mask, scale=scale)
        sdpa_fwd = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q4.detach(), k4.detach(), v4.detach(), attn_mask=full_mask, scale=scale), reps=10)
        sdpa_bwd = cuda_ms(torch, lambda: torch.autograd.grad(
            o4, (q4, k4, v4), do.view(G * nW, 1, T, D), retain_graph=True), reps=10)
    del q4, k4, v4, o4, full_mask

    elem = 2
    ops_fwd, ops_bwd = 4 * T * T * D * G * nW, 10 * T * T * D * G * nW
    entries = {}
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
        fwd_err = rel_err(out, ref)
        abs_fwd = float((out.float() - ref.float()).abs().max())
        names = ("dq", "dk", "dv", "dadd" if "packed" in name else "dbias")
        rel = {n: rel_err(a, b) for n, a, b in zip(names, grads, ref_grads)}
        abs_bwd = max(float((a.float() - b.float()).abs().max())
                      for a, b in zip(grads, ref_grads))
        same_bits = all(torch.equal(a, b) for a, b in zip(grads, again))
        reduce = "reduce_add_kernel" if "packed" in name else "reduce_bias_kernel"
        with torch.no_grad():
            ms = cuda_ms(torch, lambda: fn(*operands), reps=20)
            dev_ms = device_ms(torch, lambda: fn(*operands), ["window_fwd_kernel"])
            plain_ms = cuda_ms(torch, lambda: plain(*operands), reps=3)
        bwd = lambda: torch.autograd.grad(out, leaves, gout, retain_graph=True)
        bwd_ms = cuda_ms(torch, bwd, reps=20)
        bwd_dev_ms = device_ms(torch, bwd, ["window_bwd_kernel", reduce])
        bwd_plain_ms = cuda_ms(torch, lambda: torch.autograd.grad(ref, ref_leaves, gout,
                                                                  retain_graph=True), reps=3)
        del out, ref, grads, again, ref_grads, leaves, ref_leaves, bwd
        # bf16 q, k, v (and dO) read, o (dq, dk, dv) written; the additive
        # term f32 (K4a: its diagonal (T, T) blocks), its gradient written
        qkv_bytes = q.numel() * elem
        add_bytes = (H * nW * T * T * 4 if "packed" in name
                     else (bias.numel() + mask.numel()) * 4)
        fwd_bound = bound(4 * qkv_bytes + add_bytes, ops_fwd, BF16_OPS_PER_S)
        bwd_bound = bound(7 * qkv_bytes + add_bytes + operands[3].numel() * 4, ops_bwd,
                          BF16_OPS_PER_S)
        say(f"[{name} bf16 fwd, stage 0: G={G} nW={nW} T={T} D={D}] rel_err={fwd_err:.3e} "
            f"(max_abs_err={abs_fwd:.3e}) kernel_ms={ms:.4f} (device {dev_ms:.4f}) "
            f"plain_ms={plain_ms:.4f} sdpa_bf16_ms={sdpa_fwd:.4f} "
            f"bound_ms={fwd_bound[0]:.5f} ({fwd_bound[1]})")
        say(f"[{name} bf16 bwd, stage 0: G={G} nW={nW} T={T} D={D}] rel_err "
            + " ".join(f"{n}={e:.3e}" for n, e in rel.items())
            + f" (max_abs_err={abs_bwd:.3e}) same_bits_on_rerun={same_bits} "
            f"kernel_ms={bwd_ms:.4f} (device {bwd_dev_ms:.4f}, with the {reduce[:-7]}) "
            f"plain_ms={bwd_plain_ms:.4f} sdpa_bf16_bwd_ms={sdpa_bwd:.4f} "
            f"bound_ms={bwd_bound[0]:.5f} ({bwd_bound[1]})")
        if not fwd_err <= BF16_FWD_TOL:
            raise AssertionError(f"{name} bf16 forward disagrees: {fwd_err}")
        bad = {n: e for n, e in rel.items() if not e <= BF16_GRAD_TOL}
        if bad or not same_bits:
            raise AssertionError(f"{name} bf16 backward: {bad}, same bits {same_bits}")
        entries[name] = {
            "fwd": dict(max_abs_err=abs_fwd, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                        bound_ms=fwd_bound[0], bound_by=fwd_bound[1], library_ms=sdpa_fwd),
            "bwd": dict(max_abs_err=abs_bwd, ms=bwd_ms, device_ms=bwd_dev_ms,
                        plain_ms=bwd_plain_ms, bound_ms=bwd_bound[0], bound_by=bwd_bound[1],
                        library_ms=sdpa_bwd),
        }
    say(f"[K4 bf16] sdpa backend in bf16 with a float attn_mask: {backend.name}")
    del q, k, v, do, add, bias, mask
    torch.cuda.empty_cache()
    # the model's entry on a bf16 projection, read in place, at stages 0-2
    rows = {}
    for stage, nW_s, H_s, res_s in (("stage 0", 64, 3, 56), ("stage 1", 16, 6, 28),
                                    ("stage 2", 4, 12, 14)):
        rows[stage] = k4_bf16_qkv_entry(torch, stage, B, nW_s, H_s, T, D, res_s, gen,
                                        profiled=stage == "stage 0")
    return entry_rows(rows["stage 0"], entries["K4a packed"])


def entry_rows(entry, contract):
    """The kernels-JSON rows of K4a (fwd, bwd): the numbers of the model's
    qkv entry at stage 0, which is what the main path's counted launches
    run (the core with bias and mask, read in place), and beside them the
    packed contract's own as ``contract_*``."""
    return {d: {**entry[d], **{f"contract_{k}": v for k, v in contract[d].items()
                               if k not in ("bound_by", "library_ms")}}
            for d in ("fwd", "bwd")}


def k4_bf16_qkv_entry(torch, stage, B, nW, H, T, D, res, gen, profiled):
    """The model's entry on a bf16 (B nW, T, 3 H D) projection, as the
    model calls it (``SWIN_KERNEL_PACKED`` on; the batched setting launches
    the same kernels and only counts them apart): against its plain version
    (forward within 1e-2, gradients within 2e-2 of the largest magnitude,
    the same bits on a rerun), times beside the byte bound (q, k, v in
    place, o out, bias and mask; the backward with dO, dq, dk, dv and
    dbias) and SDPA in bf16 on the same strided windows; ``profiled``: four
    forwards and backwards under the profiler, whose kernels must be the
    bf16 core's forward and backward and the bias reduction, nothing else.
    Times: the call's (CUDA events over back-to-back calls, the host's work
    included) and the kernels' device time (:func:`device_ms`).  Returns the
    forward's and backward's numbers for the kernels JSON."""
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    from vit_reranking_tpu_torch.models.swin import _shift_attn_mask
    from vit_reranking_tpu_torch.ops import swin_attention as swa

    Bw, C, scale = B * nW, H * D, D ** -0.5
    qkv = torch.randn(Bw, T, 3 * C, device="cuda", generator=gen).bfloat16()
    dout = torch.randn(Bw, T, C, device="cuda", generator=gen).bfloat16()
    bias = torch.randn(H, T, T, device="cuda", generator=gen)
    mask = torch.from_numpy(_shift_attn_mask(res, res, 7, 3)).cuda()
    part = Bw * T * C * 2
    small = (bias.numel() + mask.numel()) * 4
    fwd_bound = bound(4 * part + small, 4 * T * T * D * H * Bw, BF16_OPS_PER_S)
    bwd_bound = bound(7 * part + small + bias.numel() * 4, 10 * T * T * D * H * Bw,
                      BF16_OPS_PER_S)
    q4, k4, v4 = qkv.view(Bw, T, 3, H, D).permute(2, 0, 3, 1, 4)
    full_mask = (bias[None] + mask.repeat(B, 1, 1)[:, None]).bfloat16()
    backend = sdpa_backend(q4[:8], k4[:8], v4[:8], attn_mask=full_mask[:8], scale=scale)
    sdpa_leaves = [t.detach().requires_grad_() for t in (q4, k4, v4)]
    with sdpa_kernel([backend]):
        o4 = F.scaled_dot_product_attention(*sdpa_leaves, attn_mask=full_mask, scale=scale)
        sdpa_fwd = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=full_mask, scale=scale), reps=10)
        sdpa_bwd = cuda_ms(torch, lambda: torch.autograd.grad(
            o4, sdpa_leaves, dout.view(Bw, T, H, D).transpose(1, 2), retain_graph=True),
            reps=10)
    del q4, k4, v4, o4, full_mask, sdpa_leaves
    tag = f"K4a packed bf16 qkv entry, {stage}"
    with switched([(swa, "SWIN_KERNEL_PACKED", True)]):
        def run(entry):
            leaves = [qkv.clone().requires_grad_(), bias.clone().requires_grad_()]
            out = entry(*leaves, mask, scale, H, n_windows=nW)
            return leaves, out

        leaves, out = run(swa.swin_attention_qkv)
        grads = torch.autograd.grad(out, leaves, dout, retain_graph=True)
        again = torch.autograd.grad(out, leaves, dout, retain_graph=True)
        ref_leaves, ref = run(swa.swin_attention_qkv_plain)
        ref_grads = torch.autograd.grad(ref, ref_leaves, dout, retain_graph=True)
        torch.cuda.synchronize()
        fwd_err = rel_err(out, ref)
        abs_fwd = float((out.float() - ref.float()).abs().max())
        rel = {n: rel_err(a, b) for n, a, b in zip(("dqkv", "dbias"), grads, ref_grads)}
        abs_bwd = max(float((a.float() - b.float()).abs().max())
                      for a, b in zip(grads, ref_grads))
        same_bits = all(torch.equal(a, b) for a, b in zip(grads, again))
        fwd = lambda: swa.swin_attention_qkv(qkv, bias, mask, scale, H, n_windows=nW)
        bwd = lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True)
        with torch.no_grad():
            ms = cuda_ms(torch, fwd, reps=20)
            dev_ms = device_ms(torch, fwd, ["window_fwd_kernel"])
            plain_ms = cuda_ms(torch, lambda: swa.swin_attention_qkv_plain(
                qkv, bias, mask, scale, H, n_windows=nW), reps=3)
        bwd_ms = cuda_ms(torch, bwd, reps=20)
        bwd_dev_ms = device_ms(torch, bwd, ["window_bwd_kernel", "reduce_bias_kernel"])
        bwd_plain_ms = cuda_ms(torch, lambda: torch.autograd.grad(
            ref, ref_leaves, dout, retain_graph=True), reps=3)
        del out, grads, again, ref_leaves, ref, ref_grads, fwd, bwd
        say(f"[{tag}: qkv ({Bw}, {T}, {3 * C}) H={H}] "
            f"rel_err={fwd_err:.3e} " + " ".join(f"{n}={e:.3e}" for n, e in rel.items())
            + f" (max_abs_err {abs_fwd:.3e} / {abs_bwd:.3e}) same_bits_on_rerun={same_bits} "
            f"fwd_ms={ms:.4f} (device {dev_ms:.4f}; plain {plain_ms:.4f}; bound "
            f"{fwd_bound[0]:.5f}, sdpa_bf16 {sdpa_fwd:.4f}) bwd_ms={bwd_ms:.4f} (device "
            f"{bwd_dev_ms:.4f} with the reduce; plain {bwd_plain_ms:.4f}; bound "
            f"{bwd_bound[0]:.5f}, sdpa_bf16 {sdpa_bwd:.4f})")
        if not (fwd_err <= BF16_FWD_TOL and all(e <= BF16_GRAD_TOL for e in rel.values())
                and same_bits):
            raise AssertionError(f"{tag}: {fwd_err}, {rel}, {same_bits}")
        if profiled:
            kernels = profiled_kernels(torch, lambda: torch.autograd.grad(
                swa.swin_attention_qkv(*leaves, mask, scale, H, n_windows=nW), leaves, dout))
            say(f"[{tag}] every device kernel of four forwards and backwards: " + "; ".join(
                f"{n[:70]} {c}x {t / 1e3:.3f} ms"
                for n, (t, c) in sorted(kernels.items(), key=lambda kv: -kv[1][0])))
            check_kernel_list(tag, kernels,
                              ["reduce_bias_kernel", "window_bwd_kernel", "window_fwd_kernel"])
        del leaves
    say(f"[K4 bf16 qkv entry, {stage}] sdpa backend in bf16 with a float attn_mask: "
        f"{backend.name}")
    del qkv, dout
    torch.cuda.empty_cache()
    return {"fwd": dict(max_abs_err=abs_fwd, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                        bound_ms=fwd_bound[0], bound_by=fwd_bound[1], library_ms=sdpa_fwd),
            "bwd": dict(max_abs_err=abs_bwd, ms=bwd_ms, device_ms=bwd_dev_ms,
                        plain_ms=bwd_plain_ms, bound_ms=bwd_bound[0], bound_by=bwd_bound[1],
                        library_ms=sdpa_bwd)}


def phase_train_bf16(torch):
    """The CvT-13 recipe on its card defaults (bf16, narrow_sm): 3 steps at
    batch 112 and the in-train evaluation, K3's bf16 launches counted (no
    f32 launch); then the bf16 and f32 steps in turns, and a profiled bf16
    step (the same seed and batch)."""
    from vit_reranking_tpu_torch.ops.attention import kv_resident_attention

    torch.cuda.reset_peak_memory_stats()
    summary, launches, wall = run_train(torch, TRAIN_BF16_ARGS, kv_resident_attention)
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_eval = -(-8 * 48 // 112)
    say(f"[train-bf16] peak memory {peak:.2f} GiB; expected K3 bf16 launches: fwd >= "
        f"{3 + n_eval}, bwd 3, f32 none")
    report_train("train-bf16", summary, wall, "K3", launches,
                 launches["fwd_bf16"] >= 3 + n_eval and launches["bwd_bf16"] == 3
                 and launches["fwd"] == launches["bwd"] == 0)
    ab_and_profile(torch, "train-bf16", TRAIN_BF16_ARGS, {"bf16": [], "f32": []},
                   ("bf16", "f32", "f32", "bf16"), ("bf16",),
                   tuple(K3_BF16_KERNELS), flags={"f32": F32})
    return {"fwd": launches["fwd_bf16"], "bwd": launches["bwd_bf16"]}


def phase_swin_train_bf16(torch):
    """Swin-T on its card defaults (bf16, narrow_sm) with the window kernels
    on: 3 steps at batch 112 and the in-train evaluation through K4a's bf16
    form (10 launches a pass), then one step and an evaluation batch through
    K4b's; K4a against the materialising attention in bf16 and the bf16
    step against the f32 one, in turns, and a profiled bf16 step."""
    from vit_reranking_tpu_torch.models import swin
    from vit_reranking_tpu_torch.ops import swin_attention as swa

    n_eval = -(-8 * 48 // 112)
    torch.cuda.reset_peak_memory_stats()
    summary, launches, wall = run_swin_train(torch, 48, True, SWIN_TRAIN_BF16_ARGS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    say(f"[swin-train-bf16] peak memory {peak:.2f} GiB; expected K4a bf16 launches: fwd "
        f"{10 * (3 + n_eval)}, bwd 30, f32 none")
    report_train("swin-train-bf16", summary, wall, "K4a", launches,
                 launches["fwd_bf16"] == 10 * (3 + n_eval) and launches["bwd_bf16"] == 30
                 and launches["fwd"] == launches["bwd"] == 0)
    summary_b, launches_b, wall_b = run_swin_train(torch, 14, False, SWIN_TRAIN_BF16_ARGS)
    report_train("swin-train-bf16-batched", summary_b, wall_b, "K4b", launches_b,
                 launches_b["fwd_bf16"] == 20 and launches_b["bwd_bf16"] == 10
                 and launches_b["fwd"] == launches_b["bwd"] == 0, steps=1)
    k4a = [(swin, "USE_SWIN_WINDOW_KERNEL", True), (swa, "SWIN_KERNEL_PACKED", True)]
    ab_and_profile(torch, "swin-train-bf16", SWIN_TRAIN_BF16_ARGS + ["--synthetic_per_class", "14"],
                   {"K4a packed": k4a, "off (materialising)": [(swin, "USE_SWIN_WINDOW_KERNEL", False)],
                    "f32, K4a packed": k4a},
                   ("K4a packed", "off (materialising)", "off (materialising)", "K4a packed",
                    "f32, K4a packed", "f32, K4a packed", "K4a packed"),
                   ("K4a packed",), ("fwd_kernel", "bwd_kernel", "reduce_bias_kernel"),
                   flags={"f32, K4a packed": F32})
    return {"fwd": launches["fwd_bf16"], "bwd": launches["bwd_bf16"]}


def phase_train_bf16_reference(torch):
    """One bf16 (narrow_sm) step of full CvT-13 (drop-path 0) on the card
    against the same step on the CPU, at the CPU tests' bf16 bars (loss
    rtol 1e-2, gradient norm rtol 5e-2: the two devices round bf16 products
    and sums in another order, 13 blocks deep, and K3 runs on the card
    where the CPU runs its plain version)."""
    from vit_reranking_tpu_torch.models.cvt import CvTNetwork, CvTSpec
    from vit_reranking_tpu_torch.ops.attention import kv_resident_attention

    base = CvTNetwork(embed_dim=128, spec=CvTSpec(drop_path_rate=(0.0, 0.0, 0.0)),
                      generator=torch.Generator().manual_seed(0), dtype=torch.bfloat16,
                      narrow_sm=True)
    before = kv_resident_attention.fwd_bf16_launches
    card_vs_cpu_step(torch, "train-bf16-reference", base,
                     rtol={"loss": BF16_STEP_LOSS_RTOL, "grad_l2": BF16_STEP_GRAD_RTOL})
    if kv_resident_attention.fwd_bf16_launches != before + 1:
        raise AssertionError("the bf16 card step did not run K3's bf16 form at stage 0")


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


def stand_ins():
    """tests/stand_ins.py, which writes the image trees and the stand-ins
    of the reference's checkpoints (it imports nothing of JAX)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "stand_ins.py")
    spec = importlib.util.spec_from_file_location("stand_ins", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def loader_rate(loader, passes):
    """The loader alone (JPEG decode and transform in its threads, batches
    stacked; no model) over ``passes`` passes of its index batches in one
    stream, as an epoch of that many batches runs (the training sampler
    draws anew each pass; at most PREFETCH + 1 batches in flight): seconds
    to the first batch, batches a second over the whole window, host
    seconds a batch after the first, and the batch count."""
    from vit_reranking_tpu_torch.data.loader import DataLoader

    batches = [b for _ in range(passes) for b in loader.iter_index_batches()]
    stream = DataLoader(loader.dataset, batch_sampler=batches,
                        num_workers=loader.num_workers)
    t0 = time.perf_counter()
    it = iter(stream)
    next(it)
    first = time.perf_counter() - t0
    n = 1 + sum(1 for _ in it)
    wall = time.perf_counter() - t0
    return first, n / wall, (wall - first) / (n - 1), n


# scripts/baselines/cub_reprod.sh for 2 epochs (the pretrained checkpoint and
# --source_path are added where the phase writes them)
RECIPE_TRAIN_ARGS = [
    "--dataset", "cub200", "--kernels", "6", "--n_epochs", "2",
    "--group", "CUB_Margin_b12_Distance_cvt", "--seed", "0", "--bs", "112",
    "--samples_per_class", "2", "--loss", "margin", "--batch_mining", "distance",
    "--arch", "cvt_13_normalize", "--embed_dim", "128", "--evalevery", "10",
    "--max_patience", "5", "--device", "cuda",
]
# scripts/diml/test_diml_cvt.sh (--resume_path added by the phase)
RECIPE_EVAL_ARGS = [
    "--dataset", "cub200", "--seed", "0", "--bs", "16", "--arch", "cvt_13_normalize",
    "--embed_dim", "128", "--use_cls_token", "--temperature", "0.1", "--use_ot",
    "--use_inverse", "--grid_size", "7", "--ot_part", "1.0", "--use_rollout",
    "--device", "cuda",
]
# scripts/diml/test_diml_swin.sh, from the pretrained checkpoint
SWIN_RECIPE_ARGS = [
    "--dataset", "online_products", "--seed", "0", "--bs", "16", "--arch", "swin_normalize",
    "--embed_dim", "128", "--use_cls_token", "--use_ot", "--grid_size", "7",
    "--device", "cuda",
]


@contextlib.contextmanager
def recipe_tree(torch):
    """A temporary working directory holding a CUB200-layout tree (120
    classes of 4 JPEGs, sides 240-420 px: 60 training and 60 test classes)
    under ``data/cub200`` and a stand-in of the ImageNet CvT-13 checkpoint;
    yields (work, source, ckpt, sd)."""
    si = stand_ins()
    with scratch_cwd() as work:
        t0 = time.perf_counter()
        source = os.path.join(work, "data")
        si.write_class_tree(os.path.join(source, "cub200"), n_classes=120, per_class=4,
                            seed=0, sides=(240, 420), exts=(".jpg",))
        sd = si.manifest_state_dict("cvt13")
        ckpt = os.path.join(work, "CvT-13-224x224-IN-1k.pth")
        torch.save(sd, ckpt)
        say(f"[recipe] wrote 480 JPEGs and a {len(sd)}-key CvT-13 checkpoint stand-in in "
            f"{time.perf_counter() - t0:.3f}s")
        yield work, source, ckpt, sd


def phase_recipe(torch, work, source, ckpt, sd):
    """The CUB recipe round trip on the tree of :func:`recipe_tree` from its
    checkpoint stand-in: the loader alone (24 training and 30
    evaluation batches, each in one stream), then train_baseline for 2
    epochs on the card's defaults (bf16, K3's bf16 launches counted; the
    trunk before the first step must be the converted checkpoint, bit for
    bit), `best` loaded into a fresh model and held against the weights
    the trained model had at the evaluation that made it best, a resume
    from `latest` for one more epoch, and test_diml_cvt from `best` twice
    (K1 and K2 counted; the two runs' metrics identical).  Returns the
    loader's host seconds a training batch."""
    from vit_reranking_tpu_torch import models
    from vit_reranking_tpu_torch.cli import test_diml, train_baseline
    from vit_reranking_tpu_torch.core import convert
    from vit_reranking_tpu_torch.core.checkpoint import load_checkpoint
    from vit_reranking_tpu_torch.core.config import from_args
    from vit_reranking_tpu_torch.data.loader import build_dataset, build_eval_loaders
    from vit_reranking_tpu_torch.ops.attention import kv_resident_attention
    from vit_reranking_tpu_torch.ops.rerank import sinkhorn_scores
    from vit_reranking_tpu_torch.ops.rollout import filter_threshold

    src = ["--source_path", source]
    train_args = RECIPE_TRAIN_ARGS + src + ["--pretrained_ckpt", ckpt,
                                            "--save_path", os.path.join(work, "runs")]

    loaders, _ = build_dataset(from_args(train_args))
    rates = {
        "training": loader_rate(loaders["training"], passes=12),
        "evaluation": loader_rate(
            build_eval_loaders(from_args(RECIPE_EVAL_ARGS + src))["testing"], passes=2),
    }
    for name, (first, per_s, steady, n), what in zip(
            rates, rates.values(), ("112, TrainTransform base", "16, EvalTransform")):
        say(f"[recipe] loader alone, {name} (JPEG decode + transform, 6 threads, no "
            f"model): {n} batches of {what} in one stream: first batch {first:.4f}s, "
            f"{per_s:.4f} batches/s over the window, {steady:.4f}s a batch after the first")
    tr_s, te_s = rates["training"][2], rates["evaluation"][2]

    converted = convert.convert_for_arch("cvt_13_normalize", sd)
    first = []
    evaluated = {}  # step count -> the weights the model held at that evaluation
    states = []
    real_step, real_eval = train_baseline.run_train_step, train_baseline.evaluate_plain

    def checked_step(state, *args):
        if not first:
            have = state.model.state_dict()
            first.append(all(torch.equal(have[k].cpu(), v) for k, v in converted.items()))
            states.append(state)
        return real_step(state, *args)

    def snapshot_eval(model, *args):
        evaluated[states[0].step] = {k: v.detach().cpu().clone()
                                     for k, v in model.state_dict().items()}
        return real_eval(model, *args)

    for c in COUNTERS:
        setattr(kv_resident_attention, f"{c}_launches", 0)
    t0 = time.perf_counter()
    with switched([(train_baseline, "run_train_step", checked_step),
                   (train_baseline, "evaluate_plain", snapshot_eval)]):
        summary = train_baseline.main(train_args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c: getattr(kv_resident_attention, f"{c}_launches") for c in COUNTERS}
    steps = len(summary["step_loss"])
    say(f"[recipe] trunk before the first step is the converted checkpoint, bitwise: "
        f"{first == [True]} ({len(converted)} entries)")
    report_train("recipe", summary, wall, "K3", launches,
                 launches["fwd_bf16"] > steps and launches["bwd_bf16"] == steps
                 and launches["fwd"] == launches["bwd"] == 0, steps=4)
    if first != [True]:
        raise AssertionError("recipe: the trunk was not the converted checkpoint")

    run = summary["run_dir"]
    best = load_checkpoint(os.path.join(run, "best"), map_location="cuda")
    fresh = models.select("cvt_13_normalize", from_args(train_args)).cuda()
    fresh.load_state_dict(best["params"])
    # against the weights the trained model held when `best` was evaluated
    trained = evaluated.get(best["step"], {})
    have = fresh.state_dict()
    loaded = (set(have) == set(trained)
              and all(torch.equal(v.cpu(), trained[k]) for k, v in have.items()))
    say(f"[recipe] best/state.pt (epoch {best['epoch']}, step {best['step']}) loads into a "
        f"fresh model bitwise equal to the trained model at that evaluation "
        f"(evaluations at steps {sorted(evaluated)}): {loaded}")
    if not loaded:
        raise AssertionError("recipe: best/state.pt did not load bitwise")

    saved = load_checkpoint(os.path.join(run, "latest"))
    resumed = train_baseline.main(RECIPE_TRAIN_ARGS + src + [
        "--resume_path", os.path.join(run, "latest"), "--start_epoch", "2",
        "--n_epochs", "3", "--save_path", os.path.join(work, "resumed")])
    state = resumed["state"]
    adam_steps = {float(st["step"]) for st in state.optimizer.state.values()}
    say(f"[recipe] resumed latest (epoch {saved['epoch']}, step {saved['step']}): restored "
        f"{resumed['resumed']}, {len(resumed['step_loss'])} more steps to step "
        f"{state.step}, Adam step counts {sorted(adam_steps)}, losses "
        + " ".join(f"{x:.6f}" for x in resumed["step_loss"]))
    if (resumed["resumed"] != (saved["epoch"], saved["step"])
            or state.step != saved["step"] + len(resumed["step_loss"])
            or adam_steps != {float(state.step)}
            or not all(math.isfinite(x) for x in resumed["step_loss"])):
        raise AssertionError("recipe: the resumed run did not continue the saved state")

    eval_args = RECIPE_EVAL_ARGS + src + ["--resume_path", os.path.join(run, "best")]
    runs, walls = [], []
    for i in range(2):
        sinkhorn_scores.launches = filter_threshold.launches = 0
        t0 = time.perf_counter()
        runs.append(test_diml.run_eval(from_args(eval_args), trunc_nums=(0, 100)))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches = {"sinkhorn_score": sinkhorn_scores.launches,
                    "filter_threshold": filter_threshold.launches}
        check_metrics("recipe", runs[-1])
        say(f"[recipe] test_diml_cvt from best, run {i + 1}: {walls[-1]:.3f}s, "
            f"launches {launches}")
        if min(launches.values()) <= 0:
            raise AssertionError(f"recipe: K1 or K2 was not launched: {launches}")
    say(f"[recipe] the two evaluations' metrics identical: {runs[0] == runs[1]}")
    if runs[0] != runs[1]:
        raise AssertionError("recipe: two evaluations of best disagree")
    secs = summary["step_seconds"]
    say(f"[recipe] step seconds (CUDA events): first {secs[0]:.4f}, warm "
        + " ".join(f"{x:.4f}" for x in secs[1:]) + f"; eval wall first {walls[0]:.3f}s, "
        f"warm {walls[1]:.3f}s; loader host s a batch: training {tr_s:.4f}, "
        f"evaluation {te_s:.4f}")
    return tr_s


def capturing(module, name, into):
    """A setting for :func:`switched`: ``module.name`` wrapped so that each
    result is kept in the list ``into``."""
    real = getattr(module, name)

    def wrapper(*args, **kwargs):
        into.append(real(*args, **kwargs))
        return into[-1]

    return module, name, wrapper


def paced_steps(torch, state, loader, pool, n):
    """Host seconds a step over ``n`` train steps after one warm-up step,
    each fed as train_baseline feeds it: a loader batch (JPEG decode and
    transform in its threads, pinned copy) when ``pool`` is None, else the
    batch's indices and labels and the gather and augmentation on the card;
    the card synchronised once, at the end."""
    from vit_reranking_tpu_torch.cli.common import epoch_batches, run_train_step
    from vit_reranking_tpu_torch.data.loader import DataLoader

    batches = [b for _ in range(-(-(n + 1) // len(loader))) for b in loader.iter_index_batches()]
    stream = DataLoader(loader.dataset, batch_sampler=batches[:n + 1],
                        num_workers=loader.num_workers)
    items = iter(epoch_batches(stream, pool))
    gen = torch.Generator(device="cuda").manual_seed(1)
    lab, images, idx = next(items)
    run_train_step(state, lab, images, gen, "cuda", pool, idx)  # the warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for lab, images, idx in items:
        m = run_train_step(state, lab, images, gen, "cuda", pool, idx)
    float(m["loss"])
    return (time.perf_counter() - t0) / n


def phase_cache_train(torch, work, source, ckpt, loader_s):
    """scripts/baselines/cub_reprod.sh's flags (CvT-13 on the card's bf16,
    batch 112, 2 epochs: 4 steps and the in-train evaluation) with
    --cache_device on the recipe's tree: both pools resident, K3's bf16
    launches counted; the on-device augmentation of a fixed batch against
    the plain CPU version of the same draws (within 1e-5); then the host
    seconds a step fed by the loader and by the pool, in turns (loader,
    pool, pool, loader), beside the loader's own rate.  Returns the run's
    `best` directory."""
    from vit_reranking_tpu_torch.cli import train_baseline
    from vit_reranking_tpu_torch.cli.common import build_training
    from vit_reranking_tpu_torch.core.config import from_args, resolve_precision
    from vit_reranking_tpu_torch.data.device_cache import DeviceImageCache
    from vit_reranking_tpu_torch.data.loader import build_dataset
    from vit_reranking_tpu_torch.ops.attention import kv_resident_attention

    args = RECIPE_TRAIN_ARGS + ["--source_path", source, "--pretrained_ckpt", ckpt]
    pools = []
    torch.cuda.reset_peak_memory_stats()
    for c in COUNTERS:
        setattr(kv_resident_attention, f"{c}_launches", 0)
    t0 = time.perf_counter()
    with switched([capturing(train_baseline, "setup_pool", pools)]):
        summary = train_baseline.main(args + ["--cache_device",
                                              "--save_path", os.path.join(work, "cached")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c: getattr(kv_resident_attention, f"{c}_launches") for c in COUNTERS}
    pool, eval_pool = pools
    say(f"[cache-train] resident pools: training {tuple(pool.images.shape)} "
        f"{pool.images.dtype} {pool.nbytes} bytes ({pool.augmentation}, out {pool.out_size}), "
        f"test {tuple(eval_pool.images.shape)} {eval_pool.images.dtype} {eval_pool.nbytes} "
        f"bytes; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    steps = len(summary["step_loss"])
    report_train("cache-train", summary, wall, "K3", launches,
                 launches["fwd_bf16"] > steps and launches["bwd_bf16"] == steps
                 and launches["fwd"] == launches["bwd"] == 0, steps=4)
    if not (pool.images.is_cuda and pool.images.dtype == torch.uint8 and eval_pool.images.is_cuda):
        raise AssertionError("cache-train: the pools are not uint8 on the card")
    if pool.out_size != 224:
        raise AssertionError(f"cache-train: the pool crops to {pool.out_size}, the recipe's "
                             "model takes 224")

    idx = torch.arange(112, device="cuda") % pool.images.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(3)
    raw = pool.images.index_select(0, idx)
    draws = pool.draw(112, gen)
    out = pool.apply(raw, draws)
    plain = DeviceImageCache(raw.cpu(), pool.out_size, pool.augmentation, pool.normalized)
    ref = plain.apply(plain.images, {k: v.cpu() for k, v in draws.items()})
    err = float((out.cpu() - ref).abs().max())
    aug_ms = cuda_ms(torch, lambda: pool.augment(pool.images.index_select(0, idx), gen), reps=20)
    say(f"[cache-train] on-device augmentation of a fixed batch of 112 (gather, draw, crop "
        f"to {pool.out_size}, flip, normalise): {tuple(out.shape)}, max abs err against the "
        f"plain CPU version of the same draws {err:.3e} (tolerance {AUG_TOL}); "
        f"{aug_ms:.4f} ms a batch on the card (CUDA events)")
    if not (out.shape == ref.shape and err <= AUG_TOL):
        raise AssertionError(f"cache-train: the card's augmentation disagrees: {err}")

    opt = resolve_precision(from_args(args + ["--save_path", os.path.join(work, "paced")]))
    loader = build_dataset(opt)[0]["training"]
    state = build_training(opt, len(loader), torch.device("cuda"))[2]
    n = 16
    paced = [(label, paced_steps(torch, state, loader, pool if label == "pool" else None, n))
             for label in ("loader", "pool", "pool", "loader")]
    secs = summary["step_seconds"]
    say(f"[cache-train] host s a step over {n} steps after a warm-up, in turns: "
        + ", ".join(f"{label} {t:.4f}" for label, t in paced)
        + f"; the run's CUDA-event step s: first {secs[0]:.4f}, warm "
        + " ".join(f"{x:.4f}" for x in secs[1:])
        + f"; the loader alone {loader_s:.4f} s a batch ([recipe], this run)")
    del state, pools, pool, eval_pool
    torch.cuda.empty_cache()
    return os.path.join(summary["run_dir"], "best")


def phase_cache_eval(torch, source, best):
    """test_diml_cvt (scripts/diml/test_diml_cvt.sh's flags: rollout, full
    OT) from [cache-train]'s `best`, in turns from the loader, from the
    resident pool twice, and from the loader again; K1 and K2 launched in
    each, R@1, RP and MAP@R of every run within 1e-3 points of the first's,
    and the pool's normalised input bitwise the host transform's."""
    import numpy as np

    from vit_reranking_tpu_torch.cli import test_diml
    from vit_reranking_tpu_torch.core.config import from_args
    from vit_reranking_tpu_torch.data.device_cache import PixelNormalizer
    from vit_reranking_tpu_torch.data.loader import build_eval_loaders
    from vit_reranking_tpu_torch.ops.rerank import sinkhorn_scores
    from vit_reranking_tpu_torch.ops.rollout import filter_threshold

    args = RECIPE_EVAL_ARGS + ["--source_path", source, "--resume_path", best]
    runs, pools = [], []
    for label in ("loader", "pool", "pool", "loader"):
        sinkhorn_scores.launches = filter_threshold.launches = 0
        t0 = time.perf_counter()
        with switched([capturing(test_diml, "setup_pool", pools)]):
            res = test_diml.run_eval(from_args(args + (["--cache_device"] if label == "pool"
                                                       else [])), trunc_nums=(0, 100))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"sinkhorn_score": sinkhorn_scores.launches,
                    "filter_threshold": filter_threshold.launches}
        check_metrics("cache-eval", res)
        say(f"[cache-eval] {label}: run_eval {wall:.3f}s, launches {launches}")
        if min(launches.values()) <= 0:
            raise AssertionError(f"cache-eval {label}: K1 or K2 was not launched: {launches}")
        if (label == "pool") != (pools[-1] is not None):
            raise AssertionError(f"cache-eval {label}: the pool was used {pools[-1] is not None}")
        runs.append(res)
    gaps = {m: max(abs(r[m][t] - runs[0][m][t]) for r in runs for t in runs[0][m])
            for m in runs[0]}
    # the model's input from the pool against the host transform's, bitwise
    pool = next(p for p in pools if p is not None)
    dataset = build_eval_loaders(from_args(args))["testing"].dataset
    host = torch.from_numpy(np.stack([dataset[i][1] for i in range(16)])).cuda()
    dev = PixelNormalizer("cuda")(pool.images[:16].permute(0, 3, 1, 2).float())
    dev = dev.permute(0, 2, 3, 1)
    same_input = torch.equal(dev, host)
    say("[cache-eval] largest metric gaps to the first run (points): "
        + ", ".join(f"{m} {g:.2e}" for m, g in gaps.items())
        + f"; the four runs' metrics identical: {all(r == runs[0] for r in runs)}; the pool's "
        f"normalised input of 16 images equals the host EvalTransform's bitwise: {same_input}")
    if max(gaps.values()) > METRIC_POINTS or not same_input:
        raise AssertionError(f"cache-eval: the runs' metrics or inputs disagree: {gaps}")


# DeiT-S on the CvT recipe's synthetic set, no precision flag: the card's
# default (bf16 with the narrowed softmax)
VIT_TRAIN_ARGS = [a if a != "cvt_13_normalize" else "vit_small_normalize"
                  for a in TRAIN_BF16_ARGS]


def phase_vit_train_bf16(torch):
    """DeiT-S margin training at batch 112 on its card defaults: 3 steps
    and the in-train evaluation (the precision must resolve to bf16 with
    the narrowed softmax; no port kernel on this path, ViT attention
    materialises as in the JAX package), peak memory; the bf16 and f32
    (--no-bf16) warm steps in turns; one bf16 step on the card against the
    same step on the CPU at the CPU tests' bf16 bars."""
    from vit_reranking_tpu_torch.models.vit import ViTNetwork
    from vit_reranking_tpu_torch.ops.attention import kv_resident_attention

    torch.cuda.reset_peak_memory_stats()
    summary, launches, wall = run_train(torch, VIT_TRAIN_ARGS, kv_resident_attention)
    peak = torch.cuda.max_memory_allocated() / 2**30
    model = summary["state"].model
    resolved = model.dtype == torch.bfloat16 and model.block0.attn.narrow_sm
    say(f"[vit-train-bf16] resolved to bf16 with the narrowed softmax: {resolved}; peak "
        f"memory {peak:.2f} GiB")
    report_train("vit-train-bf16", summary, wall, "K3 (none expected)", launches,
                 resolved and not any(launches.values()))
    ab_and_profile(torch, "vit-train-bf16", VIT_TRAIN_ARGS, {"bf16": [], "f32": []},
                   ("bf16", "f32", "f32", "bf16"), (), (), flags={"f32": F32})
    base = ViTNetwork(embed_dim=128, generator=torch.Generator().manual_seed(0),
                      dtype=torch.bfloat16, narrow_sm=True)
    card_vs_cpu_step(torch, "vit-train-bf16-reference", base,
                     rtol={"loss": BF16_STEP_LOSS_RTOL, "grad_l2": BF16_STEP_GRAD_RTOL})


def phase_eval_bf16(torch):
    """The CvT evaluation main path with --bf16 (the narrowing off, as the
    evaluation resolves no default), rollout and featvit, each beside its
    f32 run, every count set to 0 just before a run and read after it:
    rollout must run K2 and K1 with no K3 (ret_attn materialises), featvit
    K3's bf16 forward and K1."""
    from vit_reranking_tpu_torch.ops.attention import kv_resident_attention
    from vit_reranking_tpu_torch.ops.rerank import sinkhorn_scores
    from vit_reranking_tpu_torch.ops.rollout import filter_threshold

    featvit = [a for a in MAIN_ARGS if a != "--use_rollout"]
    for method, args in (("rollout", MAIN_ARGS), ("featvit", featvit)):
        results = {}
        for precision, extra in (("f32", []), ("bf16", ["--bf16"])):
            for c in COUNTERS:
                setattr(kv_resident_attention, f"{c}_launches", 0)
            sinkhorn_scores.launches = filter_threshold.launches = 0
            results[precision], wall = run_main_path(torch, args + extra)
            launches = {"K3 " + c: getattr(kv_resident_attention, f"{c}_launches")
                        for c in COUNTERS}
            launches.update(sinkhorn_score=sinkhorn_scores.launches,
                            filter_threshold=filter_threshold.launches)
            check_metrics(f"eval-bf16 {method} {precision}", results[precision])
            say(f"[eval-bf16] {method} {precision}: run_eval {wall:.3f}s, launches {launches}")
            if precision == "bf16":
                want_k3 = launches["K3 fwd_bf16"] > 0 if method == "featvit" else \
                    launches["K3 fwd_bf16"] == 0
                if not (want_k3 and launches["sinkhorn_score"] > 0
                        and (method == "featvit" or launches["filter_threshold"] > 0)
                        and launches["K3 fwd"] == 0):
                    raise AssertionError(f"eval-bf16 {method}: launches {launches}")
        say(f"[eval-bf16] {method} bf16 - f32 (points): " + ", ".join(
            f"{m}@{t} {results['bf16'][m][t] - results['f32'][m][t]:+.4f}"
            for m in results["f32"] for t in results["f32"][m]))


def phase_swin_recipe(torch):
    """An SOP-layout tree (30 training and 30 test classes of 4 JPEGs, the
    Ebay_*.txt lists with their header) evaluated with
    scripts/diml/test_diml_swin.sh's flags from a stand-in of the ImageNet
    Swin-T checkpoint (featvit from the head tokens), K1 counted."""
    from vit_reranking_tpu_torch.cli import test_diml_swin
    from vit_reranking_tpu_torch.ops.rerank import sinkhorn_scores

    si = stand_ins()
    with scratch_cwd() as work:
        source = os.path.join(work, "data")
        si.write_sop_tree(os.path.join(source, "online_products"), n_train=30, n_test=30,
                          per_class=4, seed=1, sides=(240, 420))
        ckpt = os.path.join(work, "swin_tiny_patch4_window7_224.pth")
        torch.save({"model": si.manifest_state_dict("swin_tiny")}, ckpt)
        sinkhorn_scores.launches = 0
        t0 = time.perf_counter()
        results = test_diml_swin.main(SWIN_RECIPE_ARGS + ["--source_path", source,
                                                          "--pretrained_ckpt", ckpt])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_metrics("swin-recipe", results)
        say(f"[swin-recipe] test_diml_swin {wall:.3f}s (first run), K1 launches "
            f"{sinkhorn_scores.launches}")
        if sinkhorn_scores.launches <= 0:
            raise AssertionError("swin-recipe: K1 was not launched")


# train_baseline on a ResNet-50 (the reference's default arch) with the CvT
# recipe's synthetic set, batch and loss, on its card default (bf16), from a
# stand-in of the ImageNet checkpoint (added by the phase)
RESNET_TRAIN_ARGS = [a if a != "cvt_13_normalize" else "resnet50_frozen_normalize"
                     for a in TRAIN_BF16_ARGS]
# scripts/diml/test_diml.sh on the same synthetic test split (--resume_path
# added by the phase)
RESNET_EVAL_ARGS = [
    "--dataset", "synthetic", "--synthetic_classes", "8", "--synthetic_per_class", "48",
    "--synthetic_size", "224", "--seed", "0", "--bs", "16", "--arch",
    "resnet50_frozen_normalize", "--embed_dim", "128", "--grid_size", "4", "--use_uniform",
    "--device", "cuda",
]
# scripts/diml/train_diml.sh (ResNet-50-DIML, margin_diml, distance mining,
# batch 112) on the synthetic set for one epoch of 3 steps and its evaluation
DIML_TRAIN_ARGS = [
    "--dataset", "synthetic", "--loss", "margin_diml", "--batch_mining", "distance",
    "--bs", "112", "--data_sampler", "class_random", "--samples_per_class", "2",
    "--arch", "resnet50_diml_frozen_normalize", "--n_epochs", "1", "--lr", "0.00001",
    "--embed_dim", "128", "--evalevery", "1", "--synthetic_classes", "8",
    "--synthetic_per_class", "48", "--synthetic_size", "224", "--seed", "0", "--kernels", "8",
    "--device", "cuda",
]
# scripts/diml/train_cvt.sh (CvT-DIML, the cls embedding into the loss) the same way
CVT_DIML_TRAIN_ARGS = [a if a != "resnet50_diml_frozen_normalize" else "cvt_diml_normalize_frozen"
                       for a in DIML_TRAIN_ARGS] + ["--grid_size", "7", "--use_cls_token"]


def k1_counts():
    from vit_reranking_tpu_torch.ops.rerank import sinkhorn_scores

    return {"sinkhorn_score": sinkhorn_scores.launches,
            "sinkhorn_score_cost": sinkhorn_scores.cost_launches,
            "sinkhorn_score_group": sinkhorn_scores.group_launches}


def zero_k1():
    from vit_reranking_tpu_torch.ops.rerank import sinkhorn_scores

    sinkhorn_scores.launches = sinkhorn_scores.cost_launches = 0
    sinkhorn_scores.group_launches = 0


@contextlib.contextmanager
def k1_captured(into):
    """Record the arguments of the first K1 call made in the block (the
    wrapper runs as before; it counts its launches on the name it is
    reached by, so the spy carries the counts and hands them back)."""
    from vit_reranking_tpu_torch.ops import rerank

    real = rerank.sinkhorn_scores
    counts = ("launches", "cost_launches", "group_launches")

    def spy(*args, **kw):
        if not into:
            into.append((args, kw))
        return real(*args, **kw)

    for c in counts:
        setattr(spy, c, getattr(real, c))
    try:
        with switched([(rerank, "sinkhorn_scores", spy)]):
            yield
    finally:
        for c in counts:
            setattr(real, c, getattr(spy, c))


def k1_check_captured(torch, tag, captured, K=100):
    """:func:`k1_check` on the K1 call a path made (its first query tile):
    the kernel against its plain version on the path's own inputs, the
    error held to K1_TOL and the rankings reported (a model trained 3 steps
    embeds near-duplicates whose scores tie at f32 rounding)."""
    (S, u, v), kw = captured[0]
    return k1_check(torch, tag, S, u, v, S.shape[0] // K, K, ranks=False, **kw)


def k1_residuals_f64(torch, S, u, v, steps, ot_temp=0.05):
    """Full OT in f64 (sinkhorn_scores_plain's arithmetic): each pair's mean
    row residual at update ``steps[i]`` (1-based), the quantity its exit
    test holds to the threshold there."""
    S, u, v = S.double(), u.double(), v.double()
    Km = torch.exp(-(1.0 - S) / ot_temp)
    r, c = torch.ones_like(u), torch.ones_like(v)
    out = torch.zeros(S.shape[0], dtype=torch.float64, device=S.device)
    for it in range(int(steps.max())):
        r_new = u / torch.bmm(Km, c[:, :, None])[:, :, 0]
        c = v / torch.bmm(Km.transpose(1, 2), r_new[:, :, None])[:, :, 0]
        out = torch.where(steps == it + 1, torch.mean(torch.abs(r_new - r), dim=1), out)
        r = r_new
    return out


def k1_exit_aware(torch, tag, S, u, v, window=1e-3, **kw):
    """Kernel K1 against its plain version on a path's own full-OT pairs,
    where each pair exits on its own residual: a pair whose residual comes
    within f32 rounding of the threshold can stop one update apart in the
    two (another sum order), and its score then moves by far more than
    K1_TOL.  So each version is held to the same arithmetic in f64 with its
    own exits (K1_TOL), and every pair whose exits differ must have its f64
    residual, at the first update where the two decided otherwise, within
    ``window`` (relative) of the threshold.  Returns (kernel scores, plain
    scores, the mask of pairs whose exits differ)."""
    from vit_reranking_tpu_torch.ops.rerank import sinkhorn_scores, sinkhorn_scores_plain

    if kw.get("group", 1) != 1 or kw.get("ot_part", 1.0) <= 0.999:
        raise ValueError("k1_exit_aware: full OT, one pair a group")
    out, k_iters = sinkhorn_scores(S, u, v, return_iters=True, **kw)
    ref, p_iters = sinkhorn_scores_plain(S, u, v, return_iters=True, **kw)
    err_k = float((out.double() - k1_plain_f64(torch, S, u, v, k_iters, **kw)).abs().max())
    err_p = float((ref.double() - k1_plain_f64(torch, S, u, v, p_iters, **kw)).abs().max())
    flips = k_iters != p_iters
    idx = torch.nonzero(flips).flatten()
    dist = 0.0
    if idx.numel():
        m = torch.minimum(k_iters[idx], p_iters[idx])
        res = k1_residuals_f64(torch, S[idx], u[idx], v[idx], m, kw.get("ot_temp", 0.05))
        dist = float((res / kw.get("thresh", 1e-1) - 1.0).abs().max())
    ms = cuda_ms(torch, lambda: sinkhorn_scores(S, u, v, **kw), reps=10)
    plain_ms = cuda_ms(torch, lambda: sinkhorn_scores_plain(S, u, v, **kw), reps=3)
    R = S.shape[-1]
    bound_ms, bound_by = bound(S.numel() * 4 + (u.numel() + v.numel() + S.shape[0]) * 4,
                               int(k_iters.sum()) * 4 * R * R + S.shape[0] * 6 * R * R)
    say(f"[{tag}] exit-aware: kernel vs f64 with its exits {err_k:.3e}, plain vs f64 with its "
        f"exits {err_p:.3e}; {int(flips.sum())} of {S.shape[0]} pairs exit at other updates in "
        f"the two, the f64 residual there within {dist:.3e} of the threshold (relative); "
        f"largest kernel - plain {float((out - ref).abs().max()):.3e}, elsewhere "
        f"{float((out - ref)[~flips].abs().max()):.3e}; mean_iters="
        f"{float(k_iters.float().mean()):.2f} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"bound_ms={bound_ms:.5f} ({bound_by})")
    if not (err_k <= K1_TOL and err_p <= K1_TOL and dist <= window
            and float((out - ref)[~flips].abs().max()) <= K1_TOL):
        raise AssertionError(f"{tag}: kernel disagrees with its plain version beyond its exits")
    return out, ref, flips


def step_profile(torch, tag, args, resolve, port_kernels=()):
    """One warm train step of ``args`` (precision resolved by ``resolve``,
    the CLI's rule) with the host syncs it makes counted
    (``torch.cuda.set_sync_debug_mode``: each synchronizing CUDA call
    warns), then one under torch.profiler: the device's busy share.
    Returns the sync count."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from vit_reranking_tpu_torch.cli.common import build_training, run_train_step
    from vit_reranking_tpu_torch.core.config import from_args
    from vit_reranking_tpu_torch.data.loader import build_dataset

    opt = resolve(from_args(args))
    loaders, _ = build_dataset(opt)
    lab, images, _ = next(iter(loaders["training"]))
    state = build_training(opt, len(loaders["training"]), torch.device("cuda"))[2]
    gen = torch.Generator(device="cuda").manual_seed(1)

    def step():
        return run_train_step(state, lab, images, gen, "cuda")

    step()  # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    say(f"[{tag}] host syncs in one warm step (CUDA sync debug mode): {syncs}")
    report_profile(f"{tag}-profile", "one warm step,", wall, prof, top=10,
                   port_kernels=port_kernels)
    del state
    torch.cuda.empty_cache()
    return syncs


def phase_resnet(torch):
    """[resnet-train]: train_baseline on a ResNet-50 (margin loss, distance
    miner, batch 112, 224 px, the card default bf16) from a stand-in of the
    ImageNet ResNet-50 checkpoint (tests/manifests/resnet50.json's keys and
    shapes, converted on the way in and checked bitwise before the first
    step), 3 steps and the in-train evaluation; a warm step's host syncs
    and busy share.  [resnet-eval]: scripts/diml/test_diml.sh's flags
    (test_diml_base, grid 4, uniform marginals) on the run's `best`: the
    featvit rerank at R = 16 on the 2048-d map, K1 counted."""
    from vit_reranking_tpu_torch.cli import test_diml_base, train_baseline
    from vit_reranking_tpu_torch.core import convert
    from vit_reranking_tpu_torch.core.config import resolve_precision
    from vit_reranking_tpu_torch.ops.attention import kv_resident_attention

    si = stand_ins()
    with scratch_cwd() as work:
        sd = si.manifest_state_dict("resnet50")
        ckpt = os.path.join(work, "resnet50-19c8e357.pth")
        torch.save(sd, ckpt)
        converted = convert.convert_for_arch("resnet50_frozen_normalize", sd)
        first = []
        real_step = train_baseline.run_train_step

        def checked_step(state, *args):
            if not first:
                have = state.model.state_dict()
                first.append(all(torch.equal(have[k].cpu(), v) for k, v in converted.items()))
            return real_step(state, *args)

        zero_k1()
        with switched([(train_baseline, "run_train_step", checked_step)]):
            summary, launches, wall = run_train(
                torch, RESNET_TRAIN_ARGS + ["--pretrained_ckpt", ckpt], kv_resident_attention,
                save_path=os.path.join(work, "runs"))
        launches.update(k1_counts())
        bf16 = summary["state"].model.trunk.dtype == torch.bfloat16
        warm = statistics.median(summary["step_seconds"][1:])
        say(f"[resnet-train] resolved to bf16: {bf16}; trunk before the first step is the "
            f"converted checkpoint, bitwise: {first == [True]} ({len(converted)} entries); "
            f"warm step median {warm:.4f} s")
        report_train("resnet-train", summary, wall, "port kernels (none expected)", launches,
                     bf16 and first == [True] and not any(launches.values()))
        step_profile(torch, "resnet-train", RESNET_TRAIN_ARGS, resolve_precision)

        best = os.path.join(summary["run_dir"], "best")
        results, launches, captured = {}, {}, []
        for label, extra in (("script", []), ("use_ot", ["--use_ot"])):
            zero_k1()
            t0 = time.perf_counter()
            with k1_captured(captured):
                results[label] = test_diml_base.main(
                    RESNET_EVAL_ARGS + extra + ["--resume_path", best])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches[label] = k1_counts()
            check_metrics(f"resnet-eval {label}", results[label])
            say(f"[resnet-eval] test_diml_base from best, {label}: {wall:.3f}s, launches "
                f"{launches[label]}")
        say("[resnet-eval] --use_ot minus the script's eager Sinkhorn (points; the fused "
            "rerank freezes each pair on its own residual, the eager one each query's "
            "candidates together): " + ", ".join(
                f"{m}@{t} {results['use_ot'][m][t] - results['script'][m][t]:+.4f}"
                for m in results["script"] for t in results["script"][m]))
        if launches["use_ot"]["sinkhorn_score"] < 1 or launches["script"]["sinkhorn_score"]:
            raise AssertionError(f"resnet-eval: K1 was not launched as the paths need: {launches}")
        k1_check_captured(torch, "K1 R=16 featvit uniform, C=2048 (resnet-eval)", captured)
    # the same shape on unit random features, whose scores do not tie: the
    # rankings held too
    Q, K = 128, 100
    _, _, S = k1_problem(torch, Q, K, 2048, 16, seed=4)
    u = torch.full((Q * K, 16), 1.0 / 16, device="cuda")
    k1 = k1_check(torch, "K1 R=16 uniform, C=2048", S, u, u.clone(), Q, K)
    return launches["use_ot"], k1


def phase_diml_train(torch, tag, args, model_check, expected):
    """train_diml with ``args`` on its card default: 3 steps and the
    in-train featvit rerank evaluation, every count set to 0 just before
    and read after; ``model_check(model)`` says the precision resolved as
    it should, ``expected(launches)`` that the kernels ran; K1 against its
    plain version on the evaluation's first query tile; the warm step's
    median, host syncs and busy share.  Returns the launches."""
    from vit_reranking_tpu_torch.cli import train_diml
    from vit_reranking_tpu_torch.core.config import resolve_diml_precision
    from vit_reranking_tpu_torch.ops.attention import kv_resident_attention

    zero_k1()
    torch.cuda.reset_peak_memory_stats()
    captured = []
    with k1_captured(captured):
        summary, launches, wall = run_train(torch, args, kv_resident_attention, cli=train_diml)
    launches.update(k1_counts())
    peak = torch.cuda.max_memory_allocated() / 2**30
    ev = summary["eval"][-1]
    warm = statistics.median(summary["step_seconds"][1:])
    say(f"[{tag}] resolved as the card default: {model_check(summary['state'].model)}; "
        f"warm step median {warm:.4f} s; peak memory {peak:.2f} GiB; global "
        f"R@1 before the rerank {ev['r1_global']:.4f}")
    report_train(tag, summary, wall, "K1/K3", launches,
                 model_check(summary["state"].model) and expected(launches))
    k1_check_captured(torch, f"K1 R=49 featvit ({tag} evaluation)", captured)
    step_profile(torch, tag, args, resolve_diml_precision,
                 port_kernels=("sinkhorn_", "wgmma_", "dkdv_kernel", "dq_kernel", "fwd_kernel"))
    return launches


def phase_diml(torch):
    """[diml-train] (ResNet-50-DIML, scripts/diml/train_diml.sh) and
    [cvt-diml-train] (CvT-DIML, scripts/diml/train_cvt.sh): K1 in each
    evaluation, K3's bf16 form forward and backward through CvT-DIML's
    stage 0; then [diml-reference]: one f32 ResNet-50-DIML step on the card
    against the CPU's."""
    from vit_reranking_tpu_torch.losses.margin_diml import MarginDIMLLoss
    from vit_reranking_tpu_torch.models.resnet import ResNet50DIML

    n_eval = -(-8 * 48 // 112)
    resnet = phase_diml_train(
        torch, "diml-train", DIML_TRAIN_ARGS,
        lambda m: m.trunk.dtype == torch.bfloat16,
        lambda n: n["sinkhorn_score"] >= 1 and not any(n[c] for c in COUNTERS))
    cvt = phase_diml_train(
        torch, "cvt-diml-train", CVT_DIML_TRAIN_ARGS,
        lambda m: m.trunk.stage0.dtype == torch.bfloat16 and m.trunk.stage0.block0.attn.narrow_sm,
        lambda n: (n["sinkhorn_score"] >= 1 and n["fwd_bf16"] >= 3 + n_eval
                   and n["bwd_bf16"] == 3 and n["fwd"] == n["bwd"] == 0))
    base = ResNet50DIML(embed_dim=128, bn_frozen=True, generator=torch.Generator().manual_seed(0))
    card_vs_cpu_step(torch, "diml-reference", base, loss_cls=MarginDIMLLoss)
    return resnet, cvt


# test_msls_baseline on the synthetic MSLS set (48 queries, 96 database
# images) at 224 px: full-width CvT-13 with embed_dim 128, global recall and
# the DIML rerank of each query's top 100 (K = 96, the whole database)
MSLS_EVAL_ARGS = [
    "--dataset", "synthetic", "--arch", "cvt_13_normalize", "--embed_dim", "128",
    "--msls_image_size", "224", "--use_ot", "--seed", "0", "--device", "cuda",
]
# scripts/baselines/msls_train.sh on one written city (--mini_data) at
# 224 x 224, batch 16 (16 x 7 = 112 images a step), one epoch; the tree's
# path and --save_path are added by the phase
MSLS_TRAIN_ARGS = [
    "--dataset", "msls", "--arch", "cvt_13_normalize", "--embed_dim", "128", "--nNeg", "5",
    "--margin", "0.1", "--lr", "0.0001", "--optim", "adam", "--lrstep", "20", "--lrgamma",
    "0.5", "--n_epochs", "1", "--evalevery", "1", "--cachebatchsize", "20", "--mini_data",
    "--imageresizeh", "224", "--imageresizew", "224", "--bs", "16", "--device", "cuda",
]
MSLS_FLAGS = dict(use_uniform=False, use_inverse=False, temperature=0.1, use_cls_token=True,
                  ot_temp=0.05, use_minus=True, ot_part=1.0)


def k3_counts():
    from vit_reranking_tpu_torch.ops.attention import kv_resident_attention

    return {c: getattr(kv_resident_attention, f"{c}_launches") for c in COUNTERS}


def zero_k3():
    from vit_reranking_tpu_torch.ops.attention import kv_resident_attention

    for c in COUNTERS:
        setattr(kv_resident_attention, f"{c}_launches", 0)


def phase_msls_eval(torch):
    """[msls-eval]: test_msls_baseline --use_ot on the synthetic MSLS set,
    K1 and K3 counted (set to 0 just before, read just after), first and
    warm wall.  Then the path's own K1 call against its plain version
    (:func:`k1_exit_aware`), and the same features reranked eagerly: the
    plain version's scores (torch ops on the path's S and marginals, each
    pair exiting on its own residual as in the fused rerank and in
    ``calc_similarity`` taken a pair at a time) must give the same DIML
    recalls, and the same final order on every query none of whose pairs
    exits at another update.  msls_val's own eager branch (use_ot off)
    exits each query's candidates together, as the JAX package's eager
    branch does, a different rule from the fused rerank's in both packages:
    its recalls and the rows it orders otherwise are reported, not held."""
    from vit_reranking_tpu_torch.cli import test_msls_baseline
    from vit_reranking_tpu_torch.engine import msls_val as mv

    runs, real = [], mv.msls_val

    def spy(eval_set, extract, **kw):
        details = {}
        out = real(eval_set, extract, details=details, **kw)
        runs.append((eval_set, extract, kw, details, out))
        return out

    walls, captured = [], []
    with scratch_cwd(), switched([(test_msls_baseline, "msls_val", spy)]):
        for i in range(2):
            zero_k1()
            zero_k3()
            t0 = time.perf_counter()
            with k1_captured(captured):
                results = test_msls_baseline.main(MSLS_EVAL_ARGS)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if i == 0:
                launches = {**k1_counts(), **k3_counts()}
    say(f"[msls-eval] test_msls_baseline {walls[0]:.3f}s first, {walls[1]:.3f}s warm; launches "
        f"{launches}; " + ", ".join(f"{k}={v:.4f}" for k, v in results.items()))
    if launches["sinkhorn_score"] < 1 or launches["fwd"] < 1 or launches["bwd"]:
        raise AssertionError(f"msls-eval: K1/K3 were not launched as the path needs: {launches}")
    for k, v in results.items():
        if not (math.isfinite(v) and 0.0 <= v <= 1.0):
            raise AssertionError(f"msls-eval: {k} = {v}")
    eval_set, extract, kw, details, fused = runs[-1]
    (S, u, v), k1_kw = captured[0]
    out, ref, flips = k1_exit_aware(torch, "K1 R=49 featvit qg (msls-eval)", S, u, v, **k1_kw)
    qF, _, dF, _ = details["features"]
    preds, final = details["preds"][0], details["final"][0]
    Q, K = preds.shape[0], S.shape[0] // preds.shape[0]
    top = preds[:, :K]
    adj = ref.view(Q, K) + torch.gather(qF @ dF.T, 1, top)
    eager_final = torch.cat([torch.gather(top, 1, torch.argsort(-adj, dim=1, stable=True)),
                             preds[:, K:]], dim=1)
    n_values = (1, 5, 10, 20, 50, 100)
    eager_r = mv.recall_at_n([eager_final.cpu().numpy()], eval_set.all_pos_indices, n_values,
                             len(eval_set.qIdx))
    gap = max(abs(eager_r[i] - fused[f"dimlR_{n}"]) for i, n in enumerate(n_values))
    flip_rows = flips.view(Q, K).any(dim=1)
    parted = (eager_final != final).any(dim=1)
    branch_details = {}
    branch = real(eval_set, extract, details=branch_details, rerank_flags={"use_ot": False},
                  **kw)
    rows = int((branch_details["final"][0] != final).any(dim=1).sum())
    gaps = {n: branch[f"dimlR_{n}"] - fused[f"dimlR_{n}"] for n in n_values}
    say(f"[msls-eval] the plain version's rerank vs the fused (K1): largest DIML recall gap "
        f"{gap:.4f}; {int(parted.sum())} of {Q} final orders part, "
        f"{int((parted & ~flip_rows).sum())} of them on queries with no exit apart "
        f"({int(flip_rows.sum())} such queries); msls_val's eager branch (each query's "
        f"candidates exit together): DIML recall minus the fused one "
        + " ".join(f"@{n} {g:+.4f}" for n, g in gaps.items())
        + f", {rows} of {Q} rows ordered otherwise")
    if gap != 0.0 or bool((parted & ~flip_rows).any()):
        raise AssertionError("msls-eval: the fused rerank disagrees with the eager one")
    return launches


def phase_msls_eval_scale(torch):
    """[msls-eval-scale]: msls_val on a SyntheticMSLS of 256 queries and
    1024 database images at 224 px (full-width CvT-13, embed_dim 128), so
    K1 runs one 256 x 100 query tile at R = 49, C = 128: the path's own
    call against its plain version (:func:`k1_exit_aware`), and the same
    shape on unit random features with the featvit route's marginals (the
    msls_val flags) at the [K1 ...] bars, rankings included (the kernel's
    numbers).  The validation's wall."""
    from vit_reranking_tpu_torch.cli.train_msls_baseline import make_extract_fn
    from vit_reranking_tpu_torch.data.msls import SyntheticMSLS
    from vit_reranking_tpu_torch.engine.msls_val import msls_val
    from vit_reranking_tpu_torch.models.cvt import CvTNetwork
    from vit_reranking_tpu_torch.ops.similarity import cross_attention_marginals, l2_normalize

    ds = SyntheticMSLS(n_queries=256, n_db=1024, image_size=224, seed=0)
    model = CvTNetwork(embed_dim=128, generator=torch.Generator().manual_seed(0)).cuda()
    captured = []
    zero_k1()
    t0 = time.perf_counter()
    with k1_captured(captured):
        results = msls_val(ds, make_extract_fn(model, True, torch.device("cuda")), batch=8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = k1_counts()
    say(f"[msls-eval-scale] msls_val over {len(ds.qImages)} + {len(ds.dbImages)} images "
        f"{wall:.3f}s, K1 launches {launches}; "
        + ", ".join(f"{k}={v:.4f}" for k, v in results.items()))
    (S, u, v), kw = captured[0]
    if launches["sinkhorn_score"] != 1 or S.shape != (256 * 100, 49, 49):
        raise AssertionError(f"msls-eval-scale: K1 did not run one 256 x 100 tile: {launches}, "
                             f"{tuple(S.shape)}")
    k1_exit_aware(torch, "K1 R=49 featvit qg, MSLS tile 256 x 100 (msls-eval-scale)", S, u, v,
                  **kw)
    del model, captured, S, u, v
    Q, K, C, R, N = 256, 100, 128, 49, 1024
    gen = torch.Generator().manual_seed(7)
    qb, db = (torch.randn(n, C, R, generator=gen).cuda() for n in (Q, N))
    qb, db = qb / qb.norm(dim=1, keepdim=True), db / db.norm(dim=1, keepdim=True)
    qc, dc = (l2_normalize(b.mean(-1) + 0.1 * torch.randn(b.shape[0], C, generator=gen).cuda())
              for b in (qb, db))
    top = torch.topk(qc @ dc.T, K, dim=1).indices
    u, v, _ = cross_attention_marginals(qb, qc, db[top], dc[top], use_minus=True,
                                        temperature=0.1)
    S = torch.matmul(db[top].transpose(-1, -2), qb[:, None]).reshape(Q * K, R, R).contiguous()
    k1 = k1_check(torch, "K1 R=49 featvit qg marginals, 256 x 100, unit random features", S,
                  u.reshape(Q * K, R).contiguous(), v.reshape(Q * K, R).contiguous(), Q, K,
                  **kw)
    del S, u, v, qb, db
    torch.cuda.empty_cache()
    return k1


@contextlib.contextmanager
def msls_tree():
    """A temporary MSLS tree (tests/stand_ins.py::write_msls_city): one city,
    ``train_val/amman``, of 192 database and 64 query JPEGs at 640 x 480 on
    real-magnitude UTM coordinates, with night, sideways and panorama rows;
    yields its root."""
    si = stand_ins()
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        si.write_msls_city(root, "amman", n_db=192, n_q=64, seed=0, image_size=(640, 480))
        say(f"[msls-train] wrote an MSLS city of 64 query and 192 database JPEGs at 640x480 in "
            f"{time.perf_counter() - t0:.3f}s")
        yield root


def msls_step_syncs(torch, summary, tree, args):
    """The host syncs one warm MSLS step makes (CUDA sync debug mode), on
    the trained model of ``summary`` and the run's first triplets."""
    import warnings

    from vit_reranking_tpu_torch.cli import train_msls_baseline as tm
    from vit_reranking_tpu_torch.cli.common import _to_device
    from vit_reranking_tpu_torch.core.config import from_args

    opt = from_args(args + ["--source_path", tree])
    ds = tm.build_msls(opt, "train")
    ds.new_epoch()
    ds.update_subcache(None)
    q, p, negs = tm.batch_arrays(ds, list(range(16)))
    model = summary["model"]
    optim = tm.make_msls_optimizer(opt, model)

    def step():
        return tm.msls_train_step(opt, model, optim, 0, *(_to_device(a, "cuda") for a in
                                                         (q, p, negs)))

    step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in caught)


def phase_msls_train(torch, tree, tag, extra, expected):
    """train_msls_baseline with scripts/baselines/msls_train.sh's flags on
    the tree (plus ``extra``), K3 counted (set to 0 just before, read just
    after): step losses, first and warm step seconds (CUDA events), peak
    memory, a warm step's host syncs, the mining seconds and the
    validation's recalls; ``expected(launches, steps)`` says the kernels
    carried it.  Returns (launches, summary)."""
    from vit_reranking_tpu_torch.cli import train_msls_baseline
    from vit_reranking_tpu_torch.ops.attention import kv_resident_attention

    args = MSLS_TRAIN_ARGS + extra
    torch.cuda.reset_peak_memory_stats()
    summary, launches, wall = run_train(torch, args + ["--source_path", tree],
                                        kv_resident_attention, cli=train_msls_baseline)
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses, secs = summary["step_loss"], summary["step_seconds"]
    model = summary["model"]
    dtype = model.trunk.stage0.dtype
    syncs = msls_step_syncs(torch, summary, tree, args)
    say(f"[{tag}] step losses " + " ".join(f"{x:.6f}" for x in losses))
    say(f"[{tag}] step seconds (CUDA events): first {secs[0]:.4f}, warm "
        + " ".join(f"{x:.4f}" for x in secs[1:]) + f"; peak memory {peak:.2f} GiB; host syncs "
        f"in a warm step {syncs}; mining s " + " ".join(f"{x:.3f}" for x in
                                                       summary["mine_seconds"]))
    say(f"[{tag}] train_msls_baseline.main {wall:.3f}s; trunk {dtype}; K3 launches {launches}; "
        "val " + ", ".join(f"{k}={v:.4f}" for k, v in summary["eval"][-1].items()))
    if len(losses) < 3 or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{tag}: losses {losses}")
    if not expected(launches, len(losses), dtype):
        raise AssertionError(f"{tag}: K3 was not launched as the path needs: {launches}")
    for k, v in summary["eval"][-1].items():
        if not (math.isfinite(v) and 0.0 <= v <= 1.0):
            raise AssertionError(f"{tag}: {k} = {v}")
    del summary, model
    torch.cuda.empty_cache()
    return launches


def phase_msls_reference(torch):
    """[msls-reference]: one f32 MSLS step of full CvT-13 (drop-path 0) on
    the card against the same step on the CPU: 2 triplets of a query, a
    positive and 5 negatives at 224 px (each a noisy copy of the query),
    Adam at the recipe's lr; loss and gradient norm within STEP_RTOL."""
    import copy

    from vit_reranking_tpu_torch.cli import train_msls_baseline as tm
    from vit_reranking_tpu_torch.core.config import from_args
    from vit_reranking_tpu_torch.models.cvt import CvTNetwork, CvTSpec

    base = CvTNetwork(embed_dim=128, spec=CvTSpec(drop_path_rate=(0.0, 0.0, 0.0)),
                      generator=torch.Generator().manual_seed(0))
    opt = from_args(MSLS_TRAIN_ARGS)
    # the positive and the negatives all near the query, so that every
    # triplet violates the margin and the loss is not 0
    gen = torch.Generator().manual_seed(5)
    q = torch.randn(2, 224, 224, 3, generator=gen)
    p = q + 0.5 * torch.randn(2, 224, 224, 3, generator=gen)
    negs = q[:, None] + 0.5 * torch.randn(2, 5, 224, 224, 3, generator=gen)

    def one_step(device):
        model = copy.deepcopy(base).to(device)
        m = tm.msls_train_step(opt, model, tm.make_msls_optimizer(opt, model), 0,
                               q.to(device), p.to(device), negs.to(device))
        return {k: float(v) for k, v in m.items()}

    card, cpu = one_step("cuda"), one_step("cpu")
    rel = {k: abs(card[k] - cpu[k]) / abs(cpu[k]) for k in ("loss", "grad_l2")}
    say(f"[msls-reference] card {card} cpu {cpu} rel_err "
        + " ".join(f"{k}={v:.3e}" for k, v in rel.items()))
    if not all(v <= STEP_RTOL for v in rel.values()) or not all(
            math.isfinite(v) for v in card.values()):
        raise AssertionError(f"msls-reference: card and CPU steps disagree beyond {STEP_RTOL}")


def phase_msls(torch):
    """The MSLS slice: [msls-eval], [msls-eval-scale], then on a written
    city [msls-train] (f32, the JAX CLI's default: K3's f32 forward and
    backward) and [msls-train-bf16] (--bf16: K3's bf16 form, no f32
    launch), and [msls-reference].  Returns the K1 launches of
    [msls-eval], the K3 launches of both trainings and K1's numbers at
    the MSLS tile."""
    t0 = time.perf_counter()
    k1_eval = phase_msls_eval(torch)
    k1_tile = phase_msls_eval_scale(torch)
    with msls_tree() as tree:
        f32 = phase_msls_train(
            torch, tree, "msls-train", [],
            lambda n, steps, dtype: (dtype == torch.float32 and n["bwd"] == steps
                                     and n["fwd"] > steps and not n["fwd_bf16"]
                                     and not n["bwd_bf16"]))
        bf16 = phase_msls_train(
            torch, tree, "msls-train-bf16", ["--bf16"],
            lambda n, steps, dtype: (dtype == torch.bfloat16 and n["bwd_bf16"] == steps
                                     and n["fwd_bf16"] > steps and not n["fwd"]
                                     and not n["bwd"]))
    phase_msls_reference(torch)
    say(f"[msls] the MSLS phases took {time.perf_counter() - t0:.3f}s")
    return k1_eval, f32, bf16, k1_tile


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
    k3_bf16 = phase_k3_bf16(torch)
    k4a_bf16 = phase_k4_bf16(torch)
    k3_bf16_launches = phase_train_bf16(torch)
    phase_train_bf16_reference(torch)
    k4a_bf16_launches = phase_swin_train_bf16(torch)
    k1_qk = phase_k1_large(torch)
    qk_launches = phase_vit(torch, "vit-qk", VIT_QK_ARGS)
    phase_vit(torch, "vit-featvit", VIT_ARGS)
    phase_vit_profile(torch)
    phase_vit_reference(torch)
    with recipe_tree(torch) as tree:
        loader_s = phase_recipe(torch, *tree)
        cache_best = phase_cache_train(torch, *tree[:3], loader_s)
        phase_cache_eval(torch, tree[1], cache_best)
    phase_swin_recipe(torch)
    phase_vit_train_bf16(torch)
    phase_eval_bf16(torch)
    phase_resnet(torch)
    phase_diml(torch)
    msls_k1, msls_f32, msls_bf16, _ = phase_msls(torch)
    kernels = [
        dict(name="sinkhorn_score", route="cuda",
             source="vit_reranking_tpu_torch/csrc/sinkhorn_score.cu",
             replaces="vit_reranking_tpu/ops/rerank_pallas.py:97",
             launches=launches["sinkhorn_score"], msls_launches=msls_k1["sinkhorn_score"],
             **k1),
        dict(name="filter_threshold", route="cuda",
             source="vit_reranking_tpu_torch/csrc/filter_threshold.cu",
             replaces="vit_reranking_tpu/ops/rollout.py:29",
             launches=launches["filter_threshold"], **k2),
        dict(name="kv_attention_fwd", route="cuda",
             source="vit_reranking_tpu_torch/csrc/kv_attention.cu",
             replaces="vit_reranking_tpu/ops/attention_pallas.py:48",
             launches=k3_launches["fwd"], msls_launches=msls_f32["fwd"], **k3["fwd"]),
        dict(name="kv_attention_bwd", route="cuda",
             source="vit_reranking_tpu_torch/csrc/kv_attention.cu",
             replaces="vit_reranking_tpu/ops/attention_pallas.py:66",
             launches=k3_launches["bwd"], msls_launches=msls_f32["bwd"], **k3["bwd"]),
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
        dict(name="kv_attention_fwd_bf16", route="cuda",
             source="vit_reranking_tpu_torch/csrc/kv_attention_bf16.cu",
             replaces="vit_reranking_tpu/ops/attention_pallas.py:48",
             launches=k3_bf16_launches["fwd"], msls_launches=msls_bf16["fwd_bf16"],
             **k3_bf16["fwd"]),
        dict(name="kv_attention_bwd_bf16", route="cuda",
             source="vit_reranking_tpu_torch/csrc/kv_attention_bf16.cu",
             replaces="vit_reranking_tpu/ops/attention_pallas.py:66",
             launches=k3_bf16_launches["bwd"], msls_launches=msls_bf16["bwd_bf16"],
             **k3_bf16["bwd"]),
        dict(name="swin_attention_packed_fwd_bf16", route="cuda",
             source="vit_reranking_tpu_torch/csrc/swin_attention_bf16.cu",
             replaces="vit_reranking_tpu/ops/swin_attention_pallas.py:218",
             launches=k4a_bf16_launches["fwd"], **k4a_bf16["fwd"]),
        dict(name="swin_attention_packed_bwd_bf16", route="cuda",
             source="vit_reranking_tpu_torch/csrc/swin_attention_bf16.cu",
             replaces="vit_reranking_tpu/ops/swin_attention_pallas.py:234",
             launches=k4a_bf16_launches["bwd"], **k4a_bf16["bwd"]),
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
