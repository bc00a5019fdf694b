"""The port's DeiT/ViT (vit_reranking_tpu_torch/models/vit.py) against the JAX
package's, on the CPU.

A small ViT (embed 16, dim 48, depth 2, 3 heads of 16, patch 8, 32 px, so
T = 16 patch tokens) on weights drawn in the Flax layout and carried across:
the embedding, cls and patch tokens, head tokens and block ``qk_block``'s
q and k agree within 1e-5 (f32 convolution, products, LayerNorms and softmax
sum in another order).  Also: the loader consumes every Flax leaf, the
registry builds DeiT-S at its published widths and sizes ``pos_embed`` from
the input, and the frozen mask matches the JAX package's.
"""

import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import vit_reranking_tpu.models.vit as jax_vit
from vit_reranking_tpu.models import frozen_param_mask as jax_frozen_param_mask

from vit_reranking_tpu_torch.models import frozen_param_mask, select
from vit_reranking_tpu_torch.models.vit import ViTNetwork
from vit_reranking_tpu_torch.weights import flax_name, load_jax_params

torch.set_num_threads(2)

SMALL = dict(embed_dim=16, dim=48, depth=2, num_heads=3, patch=8)
SIZE = 32
TOL = 1e-5


def _flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}"
        out.update(_flat(v, name) if hasattr(v, "items") else {name: np.asarray(v)})
    return out


def _random_tree(shapes, rng):
    """Flax-layout weights drawn with numpy: kernels N(0, 1/fan_in),
    LayerNorm scales 1 + 0.1 N, everything else (biases, cls token, position
    embedding) 0.02 N."""
    def draw(path, s):
        leaf = path[-1].key
        if leaf == "kernel":
            std = float(np.prod(s.shape[:-1])) ** -0.5
        elif leaf == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        else:
            std = 0.02
        return (std * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def jax_vit_variables(jm, size, seed):
    x0 = jnp.zeros((2, size, size, 3), jnp.float32)
    shapes = jax.eval_shape(lambda k: jm.init(k, x0, train=False), jax.random.PRNGKey(0))
    return _random_tree(shapes, np.random.default_rng(seed))


@pytest.fixture(scope="module")
def small():
    jm = jax_vit.ViTNetwork(**SMALL, qk_block=1)
    variables = jax_vit_variables(jm, SIZE, 1)
    tm = load_jax_params(ViTNetwork(**SMALL, qk_block=1, img_size=SIZE), variables).eval()
    return jm, variables, tm


def test_small_forward_matches_jax(small):
    jm, variables, tm = small
    x = np.random.default_rng(2).standard_normal((3, SIZE, SIZE, 3)).astype(np.float32)
    je, (jenc, jtok), jaux = jax.jit(lambda v, x: jm.apply(v, x, train=False, ret_attn=True))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        te, (tenc, ttok), taux = tm(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
                                    ret_attn=True)
    assert taux["q"].shape == (3, 3, 17, 16) and taux["head_tokens"].shape == (3, 16, 16)
    pairs = {"embed": (je, te), "enc_out": (jenc, tenc), "token_map": (jtok, ttok),
             "head_tokens": (jaux["head_tokens"], taux["head_tokens"]),
             "q": (jaux["q"], taux["q"]), "k": (jaux["k"], taux["k"])}
    for name, (ref, out) in pairs.items():
        assert tuple(out.shape) == tuple(ref.shape), name
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL,
                                   err_msg=name)


def test_no_qk_without_ret_attn(small):
    _, _, tm = small
    with torch.no_grad():
        _, _, aux = tm(torch.zeros(1, 3, SIZE, SIZE))
    assert set(aux) == {"head_tokens"}


def test_load_jax_params_fills_every_vit_leaf(small):
    """Every Flax leaf (patch-embedding conv, cls token, position embedding,
    each block's qkv ...) lands in one module entry, and back."""
    _, variables, tm = small
    leaves = _flat(variables["params"], "params")
    mine = {flax_name(n, p.ndim): p for n, p in tm.state_dict().items()}
    assert set(mine) == set(leaves)
    for name in ("params/cls_token", "params/pos_embed", "params/block0/attn/qkv/kernel",
                 "params/patch_embed_proj/kernel"):
        assert name in leaves
    np.testing.assert_array_equal(tm.pos_embed.detach().numpy(), leaves["params/pos_embed"])
    np.testing.assert_array_equal(tm.patch_embed_proj.weight.detach().numpy(),
                                  leaves["params/patch_embed_proj/kernel"].transpose(3, 2, 0, 1))


def test_pos_embed_sized_from_the_input():
    m = ViTNetwork(**SMALL, img_size=48)
    assert m.pos_embed.shape == (1, 37, 48)
    with pytest.raises(ValueError, match="img_size"):
        m(torch.zeros(1, 3, SIZE, SIZE))


@pytest.mark.parametrize("arch", ["vit_normalize", "deit_small", "vit_frozen_normalize"])
def test_select_builds_deit_s(arch):
    opt = types.SimpleNamespace(embed_dim=128, blk_ind=3)
    m = select(arch, opt, generator=torch.Generator().manual_seed(0), img_size=224)
    assert isinstance(m, ViTNetwork) and m.normalize == ("normalize" in arch)
    assert m.qk_block == 3 and m.depth == 12
    assert m.pos_embed.shape == (1, 197, 384) and m.block11.attn.num_heads == 6
    assert m.head.out_features == 128 and m.block0.mlp.fc1.out_features == 1536
    assert select(arch, opt, img_size=112).pos_embed.shape == (1, 50, 384)


@pytest.mark.parametrize("arch", ["vit_normalize", "vit_frozen_normalize", "deit_frozen"])
def test_frozen_param_mask_matches_jax(small, arch):
    _, variables, tm = small
    ref = _flat(jax_frozen_param_mask(arch, variables["params"]), "params")
    ours = {flax_name(n, p.ndim): ok
            for (n, ok), p in zip(frozen_param_mask(arch, tm).items(), tm.parameters())}
    assert set(ours) == set(ref)
    assert {k for k, v in ours.items() if not v} == {k for k, v in ref.items() if not bool(v)}
