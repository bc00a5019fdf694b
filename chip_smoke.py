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
    carried by kernel K3 forward and backward.

For each path it checks that its kernels carried it (launch counts set to 0
just before and read just after), and it checks the model's forward and one
train step on the card against the CPU path on a small input.

Every phase prints one line as it ends.  Before the last line come one JSON
line with the kernels' numbers and the card's name and power limit; the last
line is {"ok": true, "device": {...}}.  Any mismatch or error exits non-zero,
and so does a run without a CUDA card.

    python3 chip_smoke.py
"""

import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time

# published H100 SXM peaks, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

K1_TOL = 1e-5  # kernel vs plain scores: f32 mat-vec sums in another order
FWD_TOL = 1e-4  # card vs CPU forward: cuDNN/cuBLAS vs CPU f32 sum order, 13 blocks deep
# K3 vs plain: the online softmax and the 64-wide tiles sum in another order;
# dk and dv sum 3136 rows in another order, so their bound is relative
K3_FWD_TOL = 1e-5
K3_GRAD_RTOL = 1e-4
# card vs CPU train step: the forward's f32 sum-order differences (FWD_TOL
# above) pass through BatchNorm on 4 images and the backward of 13 blocks
STEP_RTOL = 1e-4


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


def bound(bytes_moved, ops):
    """Least time the card could take: bytes over HBM rate vs ops over the
    f32 rate, in ms, and which of the two bounds it."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gpu_name_and_limit():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def phase_host(torch, native):
    nvcc = subprocess.run([native.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    say(f"[host] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"torch.version.cuda {torch.version.cuda}, nvcc: {nvcc}")
    say(f"[host] card: {gpu_name_and_limit()}")
    found = {m: importlib.util.find_spec(m) is not None
             for m in ("triton", "jax", "flax", "PIL", "ninja")}
    say("[host] importable: " + ", ".join(f"{m} {'yes' if ok else 'no'}" for m, ok in found.items()))


def phase_build(native):
    t0 = time.perf_counter()
    secs = native.build()
    wall = time.perf_counter() - t0
    size = sum(p.stat().st_size for p in native.BUILD_DIR.iterdir() if p.is_file())
    say(f"[build] {wall:.3f}s wall ({', '.join(f'{k} {v:.3f}s' for k, v in secs.items())}), "
        f"build/kernels holds {size} bytes")
    for name in native.SOURCES:
        log = native.BUILD_DIR / f"{name}.log"
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    say(f"[build] {name}: {line.strip()}")


def phase_k1(torch):
    """Kernel K1 against its plain version at the main path's shapes
    (Q=128 queries, K=100 candidates, C=128 channels, R=49 patches)."""
    from vit_reranking_tpu_torch.ops.rerank import (
        rollout_marginals, sinkhorn_scores, sinkhorn_scores_plain,
    )

    Q, K, C, R = 128, 100, 128, 49
    gen = torch.Generator().manual_seed(0)
    fb = torch.randn(Q, C, R, generator=gen)
    fb = fb / fb.norm(dim=1, keepdim=True)
    centers = fb.mean(-1)
    centers = centers / centers.norm(dim=-1, keepdim=True)
    roll = torch.randn(Q, R, generator=gen).abs()
    sims = centers @ centers.T
    sims.fill_diagonal_(-100.0)
    top = torch.topk(sims, K, dim=1).indices
    fb, roll, top = fb.cuda(), roll.cuda(), top.cuda()
    S32 = torch.matmul(fb[top].transpose(-1, -2), fb[:, None]).reshape(Q * K, R, R).contiguous()
    u, v = rollout_marginals(roll, roll[top])
    u, v = u.reshape(Q * K, R).contiguous(), v.reshape(Q * K, R).contiguous()

    # the main path's exit threshold (1e-1) stops group exit after 2
    # iterations on these inputs; 1e-3 runs the block-shared loop ~20 deep
    entry = None
    for mode, S, ot_part, group, thresh in (
        ("full OT f32", S32, 1.0, 1, 1e-1),
        ("partial OT 0.5, group exit", S32, 0.5, K, 1e-1),
        ("partial OT 0.5, group exit, thresh 1e-3", S32, 0.5, K, 1e-3),
        ("full OT bf16 stream", S32.to(torch.bfloat16), 1.0, 1, 1e-1),
    ):
        kw = dict(ot_part=ot_part, group=group, thresh=thresh)
        out = sinkhorn_scores(S, u, v, **kw)
        ref, iters = sinkhorn_scores_plain(S, u, v, return_iters=True, **kw)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        same = torch.equal(torch.argsort(-out.view(Q, K), dim=1, stable=True),
                           torch.argsort(-ref.view(Q, K), dim=1, stable=True))
        ms = cuda_ms(torch, lambda: sinkhorn_scores(S, u, v, **kw), reps=10)
        plain_ms = cuda_ms(torch, lambda: sinkhorn_scores_plain(S, u, v, **kw), reps=3)
        RP = R + (ot_part <= 0.999)
        bytes_moved = S.numel() * S.element_size() + (u.numel() + v.numel() + Q * K) * 4
        ops = int(iters.sum()) * 4 * RP * RP + Q * K * (3 * RP * RP + 3 * R * R)
        bound_ms, bound_by = bound(bytes_moved, ops)
        say(f"[K1 {mode}] max_abs_err={err:.3e} ranks_equal={same} "
            f"mean_iters={float(iters.float().mean()):.2f} kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.5f} ({bound_by})")
        if not (err <= K1_TOL and same and math.isfinite(err)):
            raise AssertionError(f"K1 {mode}: kernel disagrees with its plain version")
        if entry is None:  # the main path's mode
            entry = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=None)
    return entry


def phase_k2(torch):
    """Kernel K2 against its plain version on rows of CvT-13's stage-0 and
    stage-1 attention maps at 224 px, batch 32."""
    from vit_reranking_tpu_torch.ops.rollout import filter_threshold, filter_threshold_plain

    gen = torch.Generator(device="cuda").manual_seed(1)
    entry = None
    for stage, (Tq, Tk) in (("stage 0", (3136, 784)), ("stage 1", (784, 196))):
        B, N = 32, Tq * Tk
        flat = torch.randn(B, Tq, Tk, device="cuda", generator=gen).softmax(-1).reshape(B, N)
        k = int(N * 0.1)
        out = filter_threshold(flat, k)
        ref = filter_threshold_plain(flat, k)
        torch.cuda.synchronize()
        same = torch.equal(out, ref)
        ms = cuda_ms(torch, lambda: filter_threshold(flat, k), reps=5)
        plain_ms = cuda_ms(torch, lambda: filter_threshold_plain(flat, k), reps=3)
        # yardstick: one PyTorch call for the threshold alone (no zeroing)
        lib_ms = cuda_ms(torch, lambda: torch.kthvalue(flat, k, dim=1), reps=3)
        bound_ms, bound_by = bound(2 * flat.numel() * 4, 40 * flat.numel())
        say(f"[K2 {stage} B={B} N={N}] bitwise_equal={same} kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} kthvalue_ms={lib_ms:.4f} "
            f"bound_ms={bound_ms:.5f} ({bound_by})")
        if not same:
            raise AssertionError(f"K2 {stage}: kernel output differs from its plain version")
        if entry is None:
            entry = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=lib_ms)
        del flat, out, ref
    return entry


def phase_k3(torch):
    """Kernel K3, forward and backward, against its plain versions at the
    main path's shape: CvT-13 stage 0 at 224 px and batch 112 (BH=112,
    T=3136, Tkv=784, D=64), with the yardstick of
    scaled_dot_product_attention on the same inputs."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

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
    del ref, ref_grads

    backend = None
    for b in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
              SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([b]):
                F.scaled_dot_product_attention(q[:1, None], k[:1, None], v[:1, None], scale=scale)
            backend = b
            break
        except RuntimeError:
            continue
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
    elem = 4
    fwd_bound = bound((q.numel() * 2 + k.numel() * 2) * elem, 4 * T * Tkv * D * BH)
    bwd_bound = bound((q.numel() * 4 + k.numel() * 4) * elem, 10 * T * Tkv * D * BH)
    say(f"[K3 fwd BH={BH} T={T} Tkv={Tkv} D={D}] max_abs_err={fwd_err:.3e} "
        f"kernel_ms={fwd_ms:.4f} plain_ms={fwd_plain_ms:.4f} sdpa_ms={sdpa_fwd_ms:.4f} "
        f"bound_ms={fwd_bound[0]:.5f} ({fwd_bound[1]})")
    say(f"[K3 bwd BH={BH} T={T} Tkv={Tkv} D={D}] max_abs_err={bwd_err:.3e} rel_err "
        + " ".join(f"{n}={e:.3e}" for n, e in rel.items())
        + f" kernel_ms={bwd_ms:.4f} plain_ms={bwd_plain_ms:.4f} sdpa_bwd_ms={sdpa_bwd_ms:.4f} "
        f"bound_ms={bwd_bound[0]:.5f} ({bwd_bound[1]})")
    say(f"[K3] sdpa backend in f32: {backend.name}; sdpa fwd+bwd {sdpa_fb_ms:.4f} ms, "
        f"K3 fwd+bwd {fwd_ms + bwd_ms:.4f} ms")
    if not fwd_err <= K3_FWD_TOL:
        raise AssertionError(f"K3 forward disagrees with its plain version: {fwd_err}")
    bad = {n: e for n, e in rel.items() if not e <= K3_GRAD_RTOL}
    if bad:
        raise AssertionError(f"K3 backward disagrees with autograd of the plain version: {bad}")
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


def run_main_path(torch):
    """The port's run_eval on --dataset synthetic, from a scratch working
    directory (it appends its CSV to test_results/ there); returns the
    results and the wall seconds."""
    from vit_reranking_tpu_torch.cli.test_diml import run_eval
    from vit_reranking_tpu_torch.core.config import from_args

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as work:
        os.chdir(work)
        try:
            t0 = time.perf_counter()
            results = run_eval(from_args(MAIN_ARGS), trunc_nums=(0, 100))
            torch.cuda.synchronize()
            return results, time.perf_counter() - t0
        finally:
            os.chdir(cwd)


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
    for t in (0, 100):
        say(f"[main] trunc {t}: R@1={results['r1'][t]:.4f} RP={results['rp'][t]:.4f} "
            f"MAP@R={results['mapr'][t]:.4f}")
    say(f"[main] run_eval {wall:.3f}s (first run, after the kernel checks), launches {launches}")
    for m in results:
        for t, val in results[m].items():
            if not (math.isfinite(val) and 0.0 <= val <= 100.0):
                raise AssertionError(f"metric {m}@{t} = {val}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    return launches


def phase_profile(torch):
    """A second, warm run of the main path under torch.profiler: the device's
    busy share of the wall time and the kernels that take it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = run_main_path(torch)
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        say(f"[profile] warm run_eval {wall:.3f}s; the profiler recorded no device "
            "events: device busy share not measured")
        return
    busy, end, by_name = 0.0, -math.inf, {}
    for start, stop, name in spans:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
        total, count = by_name.get(name, (0.0, 0))
        by_name[name] = (total + stop - start, count + 1)
    say(f"[profile] warm run_eval {wall:.3f}s under the profiler; device busy "
        f"{busy / 1e3:.3f} ms = {busy / 1e4 / wall:.2f}% of wall")
    for name, (total, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        say(f"[profile] {total / 1e3:9.3f} ms {count:6d}x {name[:100]}")


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


TRAIN_ARGS = [
    "--dataset", "synthetic", "--arch", "cvt_13_normalize", "--loss", "margin",
    "--batch_mining", "distance", "--bs", "112", "--samples_per_class", "2",
    "--n_epochs", "1", "--evalevery", "1", "--synthetic_classes", "8",
    "--synthetic_per_class", "48", "--synthetic_size", "224", "--embed_dim", "128",
    "--seed", "0", "--kernels", "8", "--device", "cuda",
]


def phase_train(torch):
    """The training path: train_baseline.main from a scratch working
    directory with --save_path there (384 images at batch 112: 3 steps, then
    one evaluation of the 384-image test split), kernel K3's launch counts
    set to 0 just before and read just after."""
    from vit_reranking_tpu_torch.cli import train_baseline
    from vit_reranking_tpu_torch.ops.attention import kv_resident_attention

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as work:
        os.chdir(work)
        try:
            kv_resident_attention.fwd_launches = 0
            kv_resident_attention.bwd_launches = 0
            t0 = time.perf_counter()
            summary = train_baseline.main(TRAIN_ARGS + ["--save_path", os.path.join(work, "runs")])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {"fwd": kv_resident_attention.fwd_launches,
                        "bwd": kv_resident_attention.bwd_launches}
        finally:
            os.chdir(cwd)
    losses, secs = summary["step_loss"], summary["step_seconds"]
    n_eval = -(-8 * 48 // 112)
    say("[train] step losses " + " ".join(f"{x:.6f}" for x in losses))
    say(f"[train] step seconds: first {secs[0]:.4f}, warm "
        + " ".join(f"{x:.4f}" for x in secs[1:]))
    say(f"[train] in-train eval R@1={summary['eval'][-1]['r1']:.4f} "
        f"RP={summary['eval'][-1]['rp']:.4f} MAP@R={summary['eval'][-1]['mapr']:.4f}; "
        f"train_baseline.main {wall:.3f}s; K3 launches {launches}")
    if len(losses) != 3 or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train losses {losses}")
    if not (launches["fwd"] >= 3 + n_eval and launches["bwd"] == 3):
        raise AssertionError(f"K3 was not launched as the training path needs: {launches}")
    for m, val in summary["eval"][-1].items():
        if not (math.isfinite(val) and 0.0 <= val <= 100.0):
            raise AssertionError(f"in-train metric {m} = {val}")
    return launches


def phase_train_profile(torch):
    """Warm train steps of the same configuration: K3 against the
    materialising attention (models/cvt.py USE_KV_RESIDENT_ATTENTION off) in
    turns on, off, off, on, each for 3 timed steps with its peak memory;
    then one step under torch.profiler: the device's busy share and the
    kernels that take it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vit_reranking_tpu_torch.cli.common import build_training, run_train_step
    from vit_reranking_tpu_torch.core.config import from_args
    from vit_reranking_tpu_torch.data.loader import build_dataset
    from vit_reranking_tpu_torch.models import cvt

    opt = from_args(TRAIN_ARGS)
    loaders, _ = build_dataset(opt)
    lab, images, _ = next(iter(loaders["training"]))
    _, _, state = build_training(opt, len(loaders["training"]), torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(1)

    def timed_steps(use_kernel, n=3):
        cvt.USE_KV_RESIDENT_ATTENTION = use_kernel
        try:
            run_train_step(state, lab, images, gen, "cuda")  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(n):
                t0 = time.perf_counter()
                float(run_train_step(state, lab, images, gen, "cuda")["loss"])
                times.append(time.perf_counter() - t0)
            return sorted(times)[n // 2], torch.cuda.max_memory_allocated() / 2**30
        finally:
            cvt.USE_KV_RESIDENT_ATTENTION = True

    ab = [(use, *timed_steps(use)) for use in (True, False, False, True)]
    say("[train-ab] warm step median s / peak GiB, K3 on (kv-resident) vs off "
        "(materialising): " + ", ".join(
            f"{'on' if use else 'off'} {t:.4f} s {m:.2f} GiB" for use, t, m in ab))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_train_step(state, lab, images, gen, "cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        say(f"[train-profile] step {wall:.4f}s; the profiler recorded no device events: "
            "device busy share not measured")
        return
    busy, end, by_name = 0.0, -math.inf, {}
    for start, stop, name in spans:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
        total, count = by_name.get(name, (0.0, 0))
        by_name[name] = (total + stop - start, count + 1)
    k3 = sum(t for n, (t, _) in by_name.items() if "dkdv_kernel" in n or "dq_kernel" in n
             or "fwd_kernel" in n or "delta_kernel" in n)
    say(f"[train-profile] one warm step {wall:.4f}s under the profiler; device busy "
        f"{busy / 1e3:.3f} ms = {busy / 1e4 / wall:.2f}% of wall; K3 kernels {k3 / 1e3:.3f} ms")
    for name, (total, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        say(f"[train-profile] {total / 1e3:9.3f} ms {count:6d}x {name[:100]}")


def phase_train_reference(torch):
    """One train step on the card against the same step on the CPU: the
    same full CvT-13 weights (drop-path 0), 4 images at 224 px, fixed
    triplets, Adam with two groups; loss and gradient norm compared."""
    import copy
    from types import SimpleNamespace

    from vit_reranking_tpu_torch.engine.train import init_train_state, make_optimizer, train_step
    from vit_reranking_tpu_torch.losses.margin import MarginLoss
    from vit_reranking_tpu_torch.miners.common import Triplets
    from vit_reranking_tpu_torch.models.cvt import CvTNetwork, CvTSpec

    class FixedMiner:
        name = "distance"

        def __call__(self, batch, labels, generator=None):
            idx = lambda *i: torch.tensor(i, device=batch.device)
            return Triplets(idx(0, 1, 2, 3), idx(1, 0, 3, 2), idx(2, 3, 0, 1),
                            torch.ones(4, dtype=torch.bool, device=batch.device))

    base = CvTNetwork(embed_dim=128, spec=CvTSpec(drop_path_rate=(0.0, 0.0, 0.0)),
                      generator=torch.Generator().manual_seed(0))
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
    say(f"[train-reference] card {card} cpu {cpu} rel_err "
        + " ".join(f"{k}={v:.3e}" for k, v in rel.items()))
    bad = {k: v for k, v in rel.items() if not v <= STEP_RTOL}
    if bad or not all(math.isfinite(v) for v in card.values()):
        raise AssertionError(f"card and CPU train steps disagree beyond {STEP_RTOL}: {bad}")


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
    k1 = phase_k1(torch)
    k2 = phase_k2(torch)
    k3 = phase_k3(torch)
    launches = phase_main(torch)
    phase_profile(torch)
    phase_reference(torch)
    k3_launches = phase_train(torch)
    phase_train_profile(torch)
    phase_train_reference(torch)
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
