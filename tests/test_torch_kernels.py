"""The port's CUDA kernels against their plain PyTorch versions, and the
wrappers' dispatch and build plumbing.

This file imports no JAX, so it also runs on the machine with the card,
where the kernel tests run (``python -m pytest --noconftest
tests/test_torch_kernels.py``; the repository's conftest.py imports JAX).
Without a card those tests skip: a CUDA kernel has no CPU mode.  Kernel K1
matches its plain version to 1e-5 on O(1) scores (mat-vec sums in another
order); kernel K2 is bitwise equal to its plain version; kernel K3's forward
matches its plain version to 1e-5 and its dq, dk, dv match autograd through
the plain version to 1e-4 of their largest magnitude (online softmax and
tiled sums in another order).
"""

import numpy as np
import pytest
import torch

from vit_reranking_tpu_torch.ops import native
from vit_reranking_tpu_torch.ops.attention import (
    kv_resident_attention, kv_resident_attention_plain,
)
from vit_reranking_tpu_torch.ops.rerank import sinkhorn_scores, sinkhorn_scores_plain
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


def test_group_exit_freezes_candidates_together():
    """group=4 stops the 4 pairs of a group at the same iteration; group=1
    lets each pair stop on its own."""
    S, u, v = _pairs(4, P=12)
    _, it_group = sinkhorn_scores_plain(S, u, v, group=4, return_iters=True)
    _, it_pair = sinkhorn_scores_plain(S, u, v, group=1, return_iters=True)
    assert (it_group.reshape(3, 4) == it_group.reshape(3, 4)[:, :1]).all()
    assert len(set(it_pair.tolist())) > 1


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


@pytest.mark.parametrize("B,N", [(3, 70_000), (2, 153_664), (1, 1_000_003)])
def test_filter_kernel_bitwise_matches_plain_on_card(cuda, B, N):
    flat = _softmax_rows(6, B, N).to(cuda)
    k = int(N * 0.1)
    before = filter_threshold.launches
    out = filter_threshold(flat, k)
    ref = filter_threshold_plain(flat, k)
    torch.cuda.synchronize()
    assert filter_threshold.launches == before + 1
    assert torch.equal(out, ref)
    assert int((out == 0).sum()) == B * k


@pytest.mark.parametrize(
    "BH,T,Tkv,D",
    [(2, 3136, 784, 64), (3, 100, 50, 64), (2, 72, 130, 128)],
    ids=["stage0", "ragged", "d128"],
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


def test_kv_attention_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 16, 32, device=cuda)
    with pytest.raises(ValueError):
        kv_resident_attention(q, q, q, 0.1)  # D 32
    q = torch.zeros(1, 16, 64, device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError):
        kv_resident_attention(q, q, q, 0.1)  # float64
