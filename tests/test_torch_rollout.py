"""The port's rollout ops (kernel K2's caller) and pooling against the JAX
package's, on the same numpy inputs.

The attention filter must be bitwise equal on both branches: exact selection
for maps of at most 65536 entries, the 40-step value bisection above that
(the arithmetic of the JAX XLA branch and of the TPU kernel in interpret
mode).  Pooling and rollout products agree to 1e-6 relative (f32 sums in
another order).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vit_reranking_tpu.ops.pooling import (
    adaptive_avg_pool2d as jax_adaptive_avg_pool2d,
    grid_resize_tokens as jax_grid_resize_tokens,
    upsample_bilinear_ac as jax_upsample_bilinear_ac,
)
from vit_reranking_tpu.ops.rollout import (
    attention_rollout as jax_attention_rollout,
    block_rollout_map as jax_block_rollout_map,
    filter_attention_map as jax_filter_attention_map,
    filter_threshold_pallas as jax_filter_threshold_pallas,
    rollout_saliency as jax_rollout_saliency,
)
from vit_reranking_tpu_torch.ops.pooling import (
    adaptive_avg_pool2d,
    grid_resize_tokens,
    upsample_bilinear_ac,
)
from vit_reranking_tpu_torch.ops.rollout import (
    attention_rollout,
    block_rollout_map,
    filter_attention_map,
    filter_threshold_plain,
    rollout_saliency,
)

torch.set_num_threads(2)


def _attn(seed, shape):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return np.array(jax.nn.softmax(jnp.asarray(x), axis=-1))


@pytest.mark.parametrize("head_fusion", ["min", "max", "mean"])
@pytest.mark.parametrize("compat", [False, True], ids=["per-sample", "crossbatch"])
@pytest.mark.parametrize(
    "shape", [(2, 3, 48, 48), (2, 2, 350, 200)], ids=["topk-branch", "bisection-branch"]
)
def test_filter_attention_map_bitwise(shape, head_fusion, compat):
    raw = _attn(0, shape)
    ref = np.asarray(jax_filter_attention_map(
        jnp.asarray(raw), head_fusion=head_fusion, compat_crossbatch=compat
    ))
    out = filter_attention_map(
        torch.from_numpy(raw), head_fusion=head_fusion, compat_crossbatch=compat
    ).numpy()
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert np.array_equal(out, ref)


@pytest.mark.parametrize("B,N", [(3, 1024), (2, 700)], ids=["lane-multiple", "padded"])
def test_plain_bisection_matches_tpu_kernel_interpret(B, N):
    """The port's plain version (what the CUDA kernel must reproduce) is
    bitwise the TPU kernel run in interpret mode."""
    flat = np.random.default_rng(1).standard_normal((B, N)).astype(np.float32)
    k = int(N * 0.1)
    ref = np.asarray(jax_filter_threshold_pallas(jnp.asarray(flat), k, interpret=True))
    out = filter_threshold_plain(torch.from_numpy(flat), k).numpy()
    assert np.array_equal(out, ref)
    assert ((out == 0).sum(1) == k).all()


@pytest.mark.parametrize("has_cls,T,Tk", [(False, 28 * 28, 14 * 14), (True, 1 + 14 * 14, 1 + 49)])
def test_block_rollout_map_matches_jax(has_cls, T, Tk):
    raw = _attn(3, (2, 2, T, Tk))
    ref = np.asarray(jax_block_rollout_map(jnp.asarray(raw), 7, has_cls))
    out = block_rollout_map(torch.from_numpy(raw), 7, has_cls).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-9)


def test_attention_rollout_and_saliency_match_jax():
    maps = np.abs(np.random.default_rng(4).standard_normal((5, 3, 16, 16))).astype(np.float32)
    t = torch.from_numpy(maps)
    for keep in (False, True):
        ref = np.asarray(jax_attention_rollout(jnp.asarray(maps), keep_all_layers=keep))
        out = attention_rollout(t, keep_all_layers=keep).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-9)
    ref = np.asarray(jax_rollout_saliency(jnp.asarray(maps), use_res=False))
    np.testing.assert_allclose(rollout_saliency(t, use_res=False).numpy(), ref, rtol=1e-5)


@pytest.mark.parametrize("size,grid", [(14, 7), (7, 7), (12, 7), (28, 4)])
def test_pooling_matches_jax(size, grid):
    x = np.random.default_rng(5).standard_normal((2, 3, size, size)).astype(np.float32)
    t = torch.from_numpy(x)
    pairs = [
        (jax_grid_resize_tokens(jnp.asarray(x), grid), grid_resize_tokens(t, grid)),
        (jax_adaptive_avg_pool2d(jnp.asarray(x), grid), adaptive_avg_pool2d(t, grid)),
        (jax_upsample_bilinear_ac(jnp.asarray(x), 4 * grid), upsample_bilinear_ac(t, 4 * grid)),
    ]
    for ref, out in pairs:
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    # the separable matrices are torch's own pooling
    torch.testing.assert_close(
        adaptive_avg_pool2d(t, grid), torch.nn.functional.adaptive_avg_pool2d(t, grid)
    )
