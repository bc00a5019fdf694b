"""Smoke run of the PyTorch/CUDA port (vit_reranking_tpu_torch) on one NVIDIA card.

Builds the port's CUDA kernels from vit_reranking_tpu_torch/csrc/, holds each
against its plain PyTorch version at the shapes of the main path, runs the
flagship evaluation through the port's CLI entry point (CvT-13 with
embed_dim 128 at 224 px with attention rollout, exact top-100, Sinkhorn OT
rerank, R@1 / RP / MAP@R on a 128-image synthetic set, random weights from a
seeded generator), checks that both kernels carried it, and checks the
model's output on the card against the CPU path on a small input.

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
    launches = phase_main(torch)
    phase_profile(torch)
    phase_reference(torch)
    kernels = [
        dict(name="sinkhorn_score", route="cuda",
             source="vit_reranking_tpu_torch/csrc/sinkhorn_score.cu",
             replaces="vit_reranking_tpu/ops/rerank_pallas.py:97",
             launches=launches["sinkhorn_score"], **k1),
        dict(name="filter_threshold", route="cuda",
             source="vit_reranking_tpu_torch/csrc/filter_threshold.cu",
             replaces="vit_reranking_tpu/ops/rollout.py:29",
             launches=launches["filter_threshold"], **k2),
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
