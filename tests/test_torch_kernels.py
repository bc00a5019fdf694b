"""The port's CUDA kernels against their plain PyTorch versions, and the
wrappers' dispatch and build plumbing.

This file imports no JAX, so it also runs on the machine with the card,
where the kernel tests run (``python -m pytest --noconftest
tests/test_torch_kernels.py``; the repository's conftest.py imports JAX).
Without a card those tests skip: a CUDA kernel has no CPU mode.  Kernel K1
matches its plain version to 1e-5 on O(1) scores (mat-vec sums in another
order) with identical rankings, with its OT kernel from S or from a separate
cost (mode (d), the qk method), in the warp layout (R <= 83) and the block
layout (R = 84 to 239), and under group exit (partial OT, one query's
candidates freezing together) in the group layouts, every group at the
plain version's exit iteration; kernel K2 is bitwise equal to its plain version,
edge rows included; kernel K3's forward
(3xTF32 tensor-core products) matches its plain version to 1e-5 and its dq,
dk, dv match autograd through the plain version to 1e-4 of their largest
magnitude (online softmax and tiled sums in another order), the same bits
from run to run.  Kernels K4a and K4b (Swin window attention,
3xTF32 tensor-core products) hold the same bounds against their plain
versions, dbias/dadd included, at T 16 to 64 and D 8 to 64, through both
contracts and through the qkv entry that reads the model's projection in
place, and give bitwise the same dbias/dadd from run to run (fixed-order
sums).
"""

import numpy as np
import pytest
import torch

from vit_reranking_tpu_torch.ops import native
from vit_reranking_tpu_torch.ops.attention import (
    cvt_attention, kv_resident_attention, kv_resident_attention_plain,
)
from vit_reranking_tpu_torch.models.swin import _shift_attn_mask
from vit_reranking_tpu_torch.ops import swin_attention as swa
from vit_reranking_tpu_torch.ops.rerank import (
    kernel_layout, sinkhorn_scores, sinkhorn_scores_plain,
)
from vit_reranking_tpu_torch.ops.rollout import filter_threshold, filter_threshold_plain

torch.set_num_threads(2)

K1_TOL = 1e-5


def _pairs(seed, P, C=32, R=49):
    """P pairs of unit-feature patch similarities (|S| ~ 0.2, the regime of
    real features, where full OT needs 20-60 iterations) and marginals."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((P, C, R)).astype(np.float32)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b = rng.standard_normal((P, C, R)).astype(np.float32)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    S = np.einsum("pcs,pcm->psm", b, a)
    u = rng.dirichlet(np.ones(R), P).astype(np.float32)
    v = rng.dirichlet(np.ones(R), P).astype(np.float32)
    return tuple(map(torch.from_numpy, (S, u, v)))


def _softmax_rows(seed, B, N):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal((B, N)).astype(np.float32))
    return torch.softmax(x, dim=-1)


@pytest.mark.parametrize("group,ot_part", [(4, 1.0), (4, 0.9), (6, 0.5)],
                         ids=["full-4", "partial-0.9-4", "partial-0.5-6"])
def test_group_exit_freezes_candidates_together(group, ot_part):
    """A group's pairs stop at the same iteration (the plain version returns
    one count for every pair of a group, and the wrapper the same on the
    CPU); group=1 lets each pair stop on its own."""
    S, u, v = _pairs(4, P=12)
    kw = dict(ot_part=ot_part, thresh=1e-3)
    _, it_group = sinkhorn_scores_plain(S, u, v, group=group, return_iters=True, **kw)
    _, it_pair = sinkhorn_scores_plain(S, u, v, group=1, return_iters=True, **kw)
    per_group = it_group.reshape(12 // group, group)
    assert (per_group == per_group[:, :1]).all()
    assert len(set(it_pair.tolist())) > 1
    scores, it_wrapper = sinkhorn_scores(S, u, v, group=group, return_iters=True, **kw)
    assert torch.equal(it_wrapper, it_group)
    assert torch.equal(scores, sinkhorn_scores_plain(S, u, v, group=group, **kw))


def test_wrappers_take_plain_versions_on_cpu():
    S, u, v = _pairs(5, P=4, R=9)
    before = sinkhorn_scores.launches
    assert torch.equal(sinkhorn_scores(S, u, v, ot_part=0.5, group=2),
                       sinkhorn_scores_plain(S, u, v, ot_part=0.5, group=2))
    assert sinkhorn_scores.launches == before
    flat = _softmax_rows(2, 2, 500)
    before = filter_threshold.launches
    assert torch.equal(filter_threshold(flat, 50), filter_threshold_plain(flat, 50))
    assert filter_threshold.launches == before


def test_cost_wrapper_takes_plain_version_on_cpu():
    S, u, v = _pairs(9, P=4, R=9)
    C, _, _ = _pairs(10, P=4, R=9)
    before = sinkhorn_scores.launches
    assert torch.equal(sinkhorn_scores(S, u, v, cost=C),
                       sinkhorn_scores_plain(S, u, v, cost=C))
    assert sinkhorn_scores.launches == before


def test_wrappers_raise_on_other_devices():
    """No silent fallback: a tensor that is neither on the CPU nor on a CUDA
    card is refused."""
    S = torch.zeros((2, 4, 4), device="meta")
    with pytest.raises(ValueError):
        sinkhorn_scores(S, S[:, :, 0], S[:, :, 0])
    with pytest.raises(ValueError):
        filter_threshold(torch.zeros((2, 8), device="meta"), 2)


def test_build_needs_nvcc(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="nvcc"):
        native.nvcc_path()


def test_library_named_by_source_hash():
    for name in native.SOURCES:
        path = native.library_path(name)
        assert path.parent == native.BUILD_DIR
        assert path.name.startswith(f"lib{name}_") and path.suffix == ".so"
        assert path == native.library_path(name)
    assert "-G" not in native.NVCC_FLAGS and "-g" not in native.NVCC_FLAGS
    assert "--use_fast_math" not in native.NVCC_FLAGS


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize(
    "ot_part,group,dtype",
    [(1.0, 1, torch.float32), (0.5, 100, torch.float32), (0.8, 128, torch.float32),
     (1.0, 1, torch.bfloat16), (0.5, 100, torch.bfloat16)],
    ids=["full", "partial-0.5-group", "partial-0.8-group", "bf16", "bf16-partial-group"],
)
def test_sinkhorn_kernel_matches_plain_on_card(cuda, ot_part, group, dtype):
    S, u, v = (t.to(cuda) for t in _pairs(6, P=6400))
    S = S.to(dtype)
    before = sinkhorn_scores.launches
    out = sinkhorn_scores(S, u, v, ot_part=ot_part, group=group)
    ref = sinkhorn_scores_plain(S, u, v, ot_part=ot_part, group=group)
    torch.cuda.synchronize()
    assert sinkhorn_scores.launches == before + 1
    assert torch.isfinite(out).all()
    assert float((out - ref).abs().max()) <= K1_TOL


@pytest.mark.parametrize(
    "R,ot_part,group,layout",
    [(100, 1.0, 1, "block"), (196, 1.0, 1, "block"), (100, 0.5, 1, "block"),
     (196, 0.5, 1, "block"), (196, 0.5, 100, "group-block"), (83, 1.0, 1, "warp")],
    ids=["a-R100", "a-R196", "c-R100", "c-R196", "c-R196-group", "a-R83-warp"],
)
def test_sinkhorn_kernel_large_r_matches_plain_on_card(cuda, R, ot_part, group, layout):
    """Full OT (mode a) and partial OT (mode c) at R = 100 and 196, which
    no longer fit 8 pairs a block: one block a pair (under group exit too,
    over a team of blocks resident at once).  R = 83 is the largest R the
    warp layout takes.
    Exit threshold 1e-3, so every layout runs its loop many times."""
    S, u, v = (t.to(cuda) for t in _pairs(11, P=200, R=R))
    assert kernel_layout(R, ot_part <= 0.999, group)[0] == layout
    kw = dict(ot_part=ot_part, group=group, thresh=1e-3)
    out = sinkhorn_scores(S, u, v, **kw)
    ref, iters = sinkhorn_scores_plain(S, u, v, return_iters=True, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and int(iters.min()) > 2
    assert float((out - ref).abs().max()) <= K1_TOL
    ranks = lambda x: torch.argsort(-x.view(2, 100), dim=1, stable=True)
    assert torch.equal(ranks(out), ranks(ref))


@pytest.mark.parametrize("R", [49, 196])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_sinkhorn_kernel_cost_mode_matches_plain_on_card(cuda, R, dtype):
    """Mode (d): Km from a separate cost C of S's dtype, the score against
    S; the same kernel without C gives other scores."""
    S, u, v = (t.to(cuda) for t in _pairs(12, P=256, R=R))
    C = _pairs(13, P=256, R=R)[0].to(cuda)
    S, C = S.to(dtype), C.to(dtype)
    before = (sinkhorn_scores.launches, sinkhorn_scores.cost_launches)
    out = sinkhorn_scores(S, u, v, cost=C)
    ref = sinkhorn_scores_plain(S, u, v, cost=C)
    own = sinkhorn_scores(S, u, v)
    torch.cuda.synchronize()
    assert (sinkhorn_scores.launches, sinkhorn_scores.cost_launches) == (
        before[0] + 2, before[1] + 1)
    assert torch.isfinite(out).all()
    assert float((out - ref).abs().max()) <= K1_TOL
    assert float((out - own).abs().max()) > 1e-3
    ranks = lambda x: torch.argsort(-x.view(16, 16), dim=1, stable=True)
    assert torch.equal(ranks(out), ranks(ref))


@pytest.mark.parametrize("R", [49, 64, 83, 84, 196, 239])
@pytest.mark.parametrize("thresh", [1e-1, 0.0], ids=["exit-0.1", "every-iteration"])
@pytest.mark.parametrize("mode", ["S", "cost", "cost-bf16"])
def test_sinkhorn_kernel_per_pair_layouts_match_plain_on_card(cuda, R, thresh, mode):
    """Full OT, each pair on its own exit, at the edges of the per-pair
    layouts (the warp layout to R = 83, the block layout from 84 to 239):
    Km from S or from a separate cost (mode (d)), f32 or a bf16 stream;
    thresh 0 runs all 100 iterations."""
    S, u, v = (t.to(cuda) for t in _pairs(15, P=200, R=R))
    C = None if mode == "S" else _pairs(16, P=200, R=R)[0].to(cuda)
    if mode == "cost-bf16":
        S, C = S.to(torch.bfloat16), C.to(torch.bfloat16)
    assert kernel_layout(R, False, 1)[0] == ("warp" if R <= 83 else "block")
    out = sinkhorn_scores(S, u, v, thresh=thresh, cost=C)
    ref, iters = sinkhorn_scores_plain(S, u, v, thresh=thresh, cost=C, return_iters=True)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    if thresh == 0.0:
        assert int(iters.min()) == 100
    assert float((out - ref).abs().max()) <= K1_TOL
    ranks = lambda x: torch.argsort(-x.view(2, 100), dim=1, stable=True)
    assert torch.equal(ranks(out), ranks(ref))


@pytest.mark.parametrize("R", [49, 64, 83, 84, 100, 196, 239])
@pytest.mark.parametrize("group", [100, 128])
@pytest.mark.parametrize("ot_part", [0.5, 0.9])
@pytest.mark.parametrize("thresh", [1e-1, 1e-3], ids=["exit-0.1", "exit-0.001"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_sinkhorn_group_layouts_match_plain_on_card(cuda, R, group, ot_part, thresh, dtype):
    """Partial OT with group exit: two groups, their pairs spread over teams
    of blocks (group-warp while R plus the dustbin is at most 83, else
    group-block), held to the plain version within 1e-5 with identical
    rankings, and every group frozen at the plain version's iteration."""
    S, u, v = (t.to(cuda) for t in _pairs(17, P=2 * group, R=R))
    S = S.to(dtype)
    kw = dict(ot_part=ot_part, group=group, thresh=thresh)
    assert kernel_layout(R, True, group)[0] == ("group-warp" if R + 1 <= 83 else "group-block")
    before = (sinkhorn_scores.launches, sinkhorn_scores.group_launches)
    out, iters = sinkhorn_scores(S, u, v, return_iters=True, **kw)
    ref, ref_iters = sinkhorn_scores_plain(S, u, v, return_iters=True, **kw)
    torch.cuda.synchronize()
    assert (sinkhorn_scores.launches, sinkhorn_scores.group_launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.isfinite(out).all()
    assert torch.equal(iters, ref_iters)
    assert float((out - ref).abs().max()) <= K1_TOL
    ranks = lambda x: torch.argsort(-x.view(2, group), dim=1, stable=True)
    assert torch.equal(ranks(out), ranks(ref))


@pytest.mark.parametrize("R", [49, 196])
def test_sinkhorn_group_layouts_cost_mode_match_plain_on_card(cuda, R):
    """Mode (d) under group exit: Km from a separate cost, same checks."""
    S, u, v = (t.to(cuda) for t in _pairs(18, P=200, R=R))
    C = _pairs(19, P=200, R=R)[0].to(cuda)
    kw = dict(ot_part=0.9, group=100, thresh=1e-3, cost=C)
    out, iters = sinkhorn_scores(S, u, v, return_iters=True, **kw)
    ref, ref_iters = sinkhorn_scores_plain(S, u, v, return_iters=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(iters, ref_iters) and int(iters.min()) > 2
    assert float((out - ref).abs().max()) <= K1_TOL
    ranks = lambda x: torch.argsort(-x.view(2, 100), dim=1, stable=True)
    assert torch.equal(ranks(out), ranks(ref))


def test_sinkhorn_kernel_refuses_group_beyond_the_card(cuda):
    """A group whose blocks the card cannot hold at once (at R = 196, one
    block a pair, more pairs than resident blocks): ValueError before the
    launch, naming the limit, no launch."""
    from vit_reranking_tpu_torch.ops.rerank import _plan

    layout, smem, limit, max_group = _plan(196, True, 100)
    assert layout == "group-block" and 100 <= max_group < 1000
    group = max_group + 1
    S, u, v = (t.to(cuda) for t in _pairs(20, P=group, R=196))
    assert kernel_layout(196, True, group)[0] is None
    before = sinkhorn_scores.launches
    with pytest.raises(ValueError, match=f"the {max_group} pairs the card holds at once"):
        sinkhorn_scores(S, u, v, ot_part=0.5, group=group)
    assert sinkhorn_scores.launches == before


def test_sinkhorn_kernel_refuses_r_beyond_shared_memory(cuda):
    """R = 240 fits no layout in a 227 KB block (one block a pair needs
    233 KB): ValueError before the launch, naming the limit, no launch."""
    S, u, v = (t.to(cuda) for t in _pairs(14, P=1, R=240))
    layout, smem, limit = kernel_layout(240, False, 1)
    assert layout is None and smem > limit
    assert kernel_layout(239, False, 1)[0] == "block"
    before = sinkhorn_scores.launches
    with pytest.raises(ValueError, match=f"limit is {limit}"):
        sinkhorn_scores(S, u, v)
    with pytest.raises(ValueError, match="cost"):
        sinkhorn_scores(S[:, :10, :10].contiguous(), u[:, :10].contiguous(),
                        v[:, :10].contiguous(), cost=S)
    assert sinkhorn_scores.launches == before


def _filter_rows(kind, B, N, seed):
    rng = np.random.default_rng(seed)
    if kind == "softmax":
        return _softmax_rows(seed, B, N).numpy()
    vals = {
        "ties": [0.0, 1e-3, 2.5e-3, 0.5],
        "signed-zeros": [0.0, -0.0, 1e-30, -1e-30, 3e-4],
        "constant": [0.25],
    }[kind]
    return rng.choice(np.array(vals, dtype=np.float32), (B, N))


@pytest.mark.parametrize(
    "B,N,kind,offset",
    [(3, 70_000, "softmax", 0), (2, 153_664, "softmax", 0), (1, 1_000_003, "softmax", 0),
     (3, 70_001, "softmax", 1), (2, 70_003, "ties", 0), (2, 70_000, "signed-zeros", 1),
     (2, 70_002, "constant", 3)],
    ids=["N70000", "stage1", "N1000003", "off1-N70001", "ties", "signed-zeros-off1",
         "constant-off3"],
)
@pytest.mark.parametrize("which_k", ["tenth", "one", "all"])
def test_filter_kernel_bitwise_matches_plain_on_card(cuda, B, N, kind, offset, which_k):
    """Bitwise equal to the plain version, on softmax rows and on edge rows
    (heavy ties, zeros of both signs, a constant row), for k = N / 10, 1
    and N, with rows on and off 16-byte boundaries (an odd N, and a view
    ``offset`` floats into its buffer)."""
    rows = _filter_rows(kind, B, N, 6)
    buf = np.zeros(B * N + offset, dtype=np.float32)
    buf[offset:] = rows.ravel()
    flat = torch.from_numpy(buf).to(cuda)[offset:].view(B, N)
    k = {"tenth": int(N * 0.1), "one": 1, "all": N}[which_k]
    before = filter_threshold.launches
    out = filter_threshold(flat, k)
    ref = filter_threshold_plain(flat, k)
    torch.cuda.synchronize()
    assert filter_threshold.launches == before + 1
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))
    if kind == "softmax":
        assert int((out == 0).sum()) == B * k


@pytest.mark.parametrize(
    "BH,T,Tkv,D",
    [(2, 3136, 784, 64), (3, 100, 50, 64), (2, 72, 130, 128), (2, 64, 13, 64),
     (2, 72, 130, 192), (2, 3136, 784, 192)],
    ids=["stage0", "ragged", "d128", "tkv13", "d192-t72", "stage0-d192"],
)
def test_kv_attention_kernel_matches_plain_on_card(cuda, BH, T, Tkv, D):
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, do = (torch.randn(BH, T, D, device=cuda, generator=gen) for _ in range(2))
    k, v = (torch.randn(BH, Tkv, D, device=cuda, generator=gen) for _ in range(2))
    scale = D ** -0.5
    before = (kv_resident_attention.fwd_launches, kv_resident_attention.bwd_launches)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = kv_resident_attention(qg, kg, vg, scale)
    grads = torch.autograd.grad(out, (qg, kg, vg), do)
    rq, rk, rv = (t.clone().requires_grad_() for t in (q, k, v))
    ref = kv_resident_attention_plain(rq, rk, rv, scale)
    ref_grads = torch.autograd.grad(ref, (rq, rk, rv), do)
    torch.cuda.synchronize()
    assert (kv_resident_attention.fwd_launches, kv_resident_attention.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    assert float((out - ref).abs().max()) <= 1e-5
    for a, b in zip(grads, ref_grads):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


@pytest.mark.parametrize("T,Tkv,D", [(3136, 784, 64), (100, 13, 192)],
                         ids=["stage0", "ragged-d192"])
def test_kv_attention_backward_is_bitwise_repeatable_on_card(cuda, T, Tkv, D):
    """Fixed-order sums and no atomics: dq, dk and dv are the same bits on
    a second backward of the same inputs."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    q, do = (torch.randn(2, T, D, device=cuda, generator=gen) for _ in range(2))
    k, v = (torch.randn(2, Tkv, D, device=cuda, generator=gen) for _ in range(2))
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = kv_resident_attention(qg, kg, vg, D ** -0.5)
    first = torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True)
    second = torch.autograd.grad(out, (qg, kg, vg), do)
    torch.cuda.synchronize()
    for a, b, name in zip(first, second, ("dq", "dk", "dv")):
        assert torch.equal(a, b), name


def test_kv_attention_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 16, 32, device=cuda)
    with pytest.raises(ValueError):
        kv_resident_attention(q, q, q, 0.1)  # D 32
    q = torch.zeros(1, 16, 64, device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError):
        kv_resident_attention(q, q, q, 0.1)  # float64
    q = torch.zeros(1 * 16 * 64 + 1, device=cuda)[1:].view(1, 16, 64)
    with pytest.raises(ValueError):
        kv_resident_attention(q, q, q, 0.1)  # not 16-byte aligned


@pytest.mark.parametrize("D", [192, 256])
def test_cvt_attention_gate_admits_only_what_k3_takes(cuda, D):
    """The gate's repair: at D = 192 the kernel runs; at D = 256, which K3
    is not built for, the gate returns None and the caller materialises.
    Neither raises, and both match the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    q, k, v, do = (torch.randn(1, 2, 784, D, device=cuda, generator=gen) for _ in range(4))
    scale = D ** -0.5
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    before = kv_resident_attention.fwd_launches
    out = cvt_attention(qg, kg, vg, scale)
    assert (out is None) == (D == 256)
    assert kv_resident_attention.fwd_launches == before + (D != 256)
    if out is None:
        out = kv_resident_attention_plain(qg, kg, vg, scale)
    grads = torch.autograd.grad(out, (qg, kg, vg), do)
    rq, rk, rv = (t.clone().requires_grad_() for t in (q, k, v))
    ref = kv_resident_attention_plain(rq, rk, rv, scale)
    ref_grads = torch.autograd.grad(ref, (rq, rk, rv), do)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= 1e-5
    for a, b in zip(grads, ref_grads):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def _swin_inputs(device, G, nW, T, D, H, with_mask, seed=9):
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v, do = (torch.randn(G, nW, T, D, device=device, generator=gen) for _ in range(4))
    bias = torch.randn(H, T, T, device=device, generator=gen)
    mask = None
    if with_mask:
        region = torch.randint(0, 2, (nW, T, 1), device=device, generator=gen)
        mask = torch.where(region == region.transpose(1, 2), 0.0, -100.0)
    return q, k, v, do, bias, mask


def _swin_run(fn, q, k, v, do, bias, mask, scale):
    args = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    out = fn(*args, mask, scale)
    return out, torch.autograd.grad(out, args, do)


# Swin-T's stages 0 and 2 at batch 112 (their shifted-window masks), and
# windows of 16 and 64 tokens at head dims 8 to 64, masked and not
SWIN_CASES = [(336, 64, 49, 32, 3, True), (1344, 4, 49, 32, 12, True),
              (24, 4, 16, 8, 3, True), (12, 4, 49, 32, 4, False), (8, 4, 16, 16, 2, False),
              (8, 4, 64, 64, 2, True), (6, 4, 64, 16, 3, False), (8, 8, 16, 64, 2, True)]
SWIN_IDS = ["stage0", "stage2", "ragged-T16-D8", "T49-nomask", "T16-D16", "T64-D64",
            "T64-D16-nomask", "T16-D64"]


def _swin_mask(cuda, nW, T, mask):
    """Swin-T's shifted-window mask where the shape is a Swin-T stage's."""
    if mask is not None and T == 49:
        res = {64: 56, 16: 28, 4: 14}[nW]
        return torch.from_numpy(_shift_attn_mask(res, res, 7, 3)).to(cuda)
    return mask


@pytest.mark.parametrize("packed", [True, False], ids=["K4a-packed", "K4b-batched"])
@pytest.mark.parametrize("G,nW,T,D,H,with_mask", SWIN_CASES, ids=SWIN_IDS)
def test_swin_kernels_match_plain_on_card(cuda, packed, G, nW, T, D, H, with_mask):
    q, k, v, do, bias, mask = _swin_inputs(cuda, G, nW, T, D, H, with_mask)
    mask = _swin_mask(cuda, nW, T, mask)
    fn = swa.swin_window_attention_packed if packed else swa.swin_window_attention
    scale = D ** -0.5
    before = (fn.fwd_launches, fn.bwd_launches)
    out, grads = _swin_run(fn, q, k, v, do, bias, mask, scale)
    ref, ref_grads = _swin_run(swa.swin_window_attention_plain, q, k, v, do, bias, mask, scale)
    torch.cuda.synchronize()
    assert (fn.fwd_launches, fn.bwd_launches) == (before[0] + 1, before[1] + 1)
    assert float((out - ref).abs().max()) <= 1e-5
    for a, b, name in zip(grads, ref_grads, ("dq", "dk", "dv", "dbias")):
        assert torch.isfinite(a).all(), name
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()), name
    _, again = _swin_run(fn, q, k, v, do, bias, mask, scale)
    assert torch.equal(again[3], grads[3])  # dbias the same bits from run to run


@pytest.mark.parametrize("packed", [True, False], ids=["K4a-packed", "K4b-batched"])
@pytest.mark.parametrize("G,nW,T,D,H,with_mask", SWIN_CASES, ids=SWIN_IDS)
def test_swin_qkv_entry_matches_plain_on_card(cuda, monkeypatch, packed, G, nW, T, D, H,
                                              with_mask):
    """The qkv entry reads the (B nW, T, 3 H D) projection in place and
    writes (B nW, T, H D) and one dqkv: against its plain version, the
    launches counted once each way, dbias the same bits on a rerun."""
    monkeypatch.setattr(swa, "SWIN_KERNEL_PACKED", packed)
    _, _, _, _, bias, mask = _swin_inputs(cuda, H, nW, T, D, H, with_mask)
    mask = _swin_mask(cuda, nW, T, mask)
    Bw, C = (G // H) * nW, H * D
    gen = torch.Generator(device=cuda).manual_seed(11)
    qkv = torch.randn(Bw, T, 3 * C, device=cuda, generator=gen)
    do = torch.randn(Bw, T, C, device=cuda, generator=gen)
    scale = D ** -0.5
    fn = swa.swin_window_attention_packed if packed else swa.swin_window_attention

    def run(entry):
        leaves = [t.clone().requires_grad_() for t in (qkv, bias)]
        out = entry(*leaves, mask, scale, H, n_windows=nW)
        return out, torch.autograd.grad(out, leaves, do)

    before = (fn.fwd_launches, fn.bwd_launches)
    out, grads = run(swa.swin_attention_qkv)
    ref, ref_grads = run(swa.swin_attention_qkv_plain)
    torch.cuda.synchronize()
    assert (fn.fwd_launches, fn.bwd_launches) == (before[0] + 1, before[1] + 1)
    assert out.shape == (Bw, T, C) and out.is_contiguous()
    assert float((out - ref).abs().max()) <= 1e-5
    for a, b, name in zip(grads, ref_grads, ("dqkv", "dbias")):
        assert torch.isfinite(a).all(), name
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()), name
    _, again = run(swa.swin_attention_qkv)
    assert torch.equal(again[1], grads[1])  # dbias the same bits from run to run


def test_packed_kernel_dadd_is_bitwise_repeatable_and_block_diagonal(cuda):
    q, k, v, do, bias, mask = _swin_inputs(cuda, 24, 16, 49, 32, 3, True)
    P = swa._pick_pack_packed(16, 49)
    shape = (24, 16 // P, P * 49, 32)
    add = swa._packed_add_term(bias, mask, P, 16 // P).contiguous()

    def dadd():
        a = add.clone().requires_grad_()
        out = swa._packed_attention(q.reshape(shape), k.reshape(shape), v.reshape(shape), a,
                                    0.2, 8, 49)
        return torch.autograd.grad(out, a, do.reshape(shape))[0]

    first, second = dadd(), dadd()
    a = add.clone().requires_grad_()
    ref = torch.autograd.grad(swa.packed_attention_plain(
        q.reshape(shape), k.reshape(shape), v.reshape(shape), a, 0.2, 8), a, do.reshape(shape))[0]
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert float((first - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    off = torch.ones(P, P, device=cuda) - torch.eye(P, device=cuda)
    off = off.repeat_interleave(49, 0).repeat_interleave(49, 1).bool()
    assert torch.count_nonzero(first[:, :, off]) == 0


def test_swin_qkv_entry_refuses_misaligned_rows(cuda):
    qkv = torch.zeros(8, 16, 3 * 16 + 1, device=cuda)[:, :, 1:]  # rows off 16 bytes
    with pytest.raises(ValueError):
        swa.swin_attention_qkv(qkv, torch.zeros(2, 16, 16, device=cuda), None, 0.1, 2,
                               n_windows=4)


def test_swin_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros(2, 4, 80, 8, device=cuda)  # T 80 > 64
    with pytest.raises(ValueError):
        swa.swin_window_attention(q, q, q, torch.zeros(1, 80, 80, device=cuda), None, 0.1)
    q = torch.zeros(2, 4, 16, 12, device=cuda)  # D 12
    with pytest.raises(ValueError):
        swa.swin_window_attention(q, q, q, torch.zeros(1, 16, 16, device=cuda), None, 0.1)
