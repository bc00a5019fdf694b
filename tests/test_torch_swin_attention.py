"""The port's Swin window attention (vit_reranking_tpu_torch/ops/
swin_attention.py) against the JAX package's (ops/swin_attention_pallas.py,
kernels in interpret mode), case by case as tests/test_swin_attention_pallas.py
holds the JAX kernels against XLA: forward parity for both contracts, masked
and unmasked, at stage-1-like, stage-2-like and tiny shapes (atol 2e-5);
dq, dk, dv and dbias (atol 1e-4, the JAX test's tolerances); the packed
additive term; the dispatcher's layout and its None returns; the qkv entry
(swin_attention_qkv, which reads the model's qkv projection) against the JAX
dispatcher fed the same projection, forward and the gradients of qkv and
bias (atol 1e-5).

On the CPU the port runs each contract's plain version, differentiated by
autograd; the CUDA kernels are held against those plain versions on the card
(tests/test_torch_kernels.py).  The JAX file's bf16 gradient case waits for
the port's bf16 training, which has no bf16 kernel yet.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import vit_reranking_tpu.ops.swin_attention_pallas as jswa
import vit_reranking_tpu_torch.ops.swin_attention as swa

torch.set_num_threads(2)

VARIANTS = ("batched", "packed")


def _port(variant):
    return {"batched": swa.swin_window_attention,
            "packed": swa.swin_window_attention_packed}[variant]


def _jax(variant):
    return {"batched": jswa.swin_window_attention,
            "packed": jswa.swin_window_attention_packed}[variant]


def _mk(rng, G, nW, T, D, H, with_mask=True):
    """numpy inputs as the JAX test makes them: region masks of 0 / -100."""
    q, k, v = (rng.standard_normal((G, nW, T, D)).astype(np.float32) for _ in range(3))
    bias = rng.standard_normal((H, T, T)).astype(np.float32)
    mask = None
    if with_mask:
        m = rng.integers(0, 2, size=(nW, T, 1))
        mask = np.where(m == m.transpose(0, 2, 1), 0.0, -100.0).astype(np.float32)
    return q, k, v, bias, mask


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("with_mask", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize(
    "nW,T,D,H,B", [(16, 49, 32, 3, 2), (4, 49, 32, 2, 3), (8, 16, 8, 2, 2)],
    ids=["stage1-like", "stage2-like", "tiny"],
)
def test_forward_matches_jax(nW, T, D, H, B, with_mask, variant):
    q, k, v, bias, mask = _mk(np.random.default_rng(0), H * B, nW, T, D, H, with_mask)
    scale = D ** -0.5
    ref = _jax(variant)(*map(_j, (q, k, v, bias, mask)), scale, True)
    ours = _port(variant)(*map(_t, (q, k, v, bias, mask)), scale)
    assert ours.shape == (H * B, nW, T, D)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("with_mask", [False, True], ids=["nomask", "mask"])
def test_gradients_match_jax(with_mask, variant):
    """dq, dk, dv and dbias of sum(out * w), the JAX test's case."""
    rng = np.random.default_rng(1)
    nW, T, D, H, B = 8, 49, 32, 2, 2
    q, k, v, bias, mask = _mk(rng, H * B, nW, T, D, H, with_mask)
    w = rng.standard_normal(q.shape).astype(np.float32)
    scale = D ** -0.5
    jm = _j(mask)
    ref = jax.grad(
        lambda q, k, v, b: jnp.sum(_jax(variant)(q, k, v, b, jm, scale, True) * jnp.asarray(w)),
        argnums=(0, 1, 2, 3),
    )(*map(jnp.asarray, (q, k, v, bias)))
    args = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias)]
    out = _port(variant)(*args, _t(mask), scale)
    ours = torch.autograd.grad((out * torch.from_numpy(w)).sum(), args)
    for a, b, name in zip(ours, ref, ("dq", "dk", "dv", "dbias")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, err_msg=name)


@pytest.mark.parametrize("with_mask", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("nW,T", [(64, 49), (4, 49), (8, 16)])
def test_packed_add_term_matches_jax(nW, T, with_mask):
    rng = np.random.default_rng(2)
    _, _, _, bias, mask = _mk(rng, 1, nW, T, 8, 3, with_mask)
    P = swa._pick_pack_packed(nW, T)
    assert P == jswa._pick_pack_packed(nW, T)
    ref = jswa._packed_add_term(jnp.asarray(bias), _j(mask), P, nW // P)
    ours = swa._packed_add_term(torch.from_numpy(bias), _t(mask), P, nW // P)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_packed_attention_matches_jax():
    """The packed entry itself on an additive term from _packed_add_term,
    forward and the gradient of the additive term (atol 1e-4)."""
    rng = np.random.default_rng(3)
    nW, T, D, H, B = 8, 16, 8, 2, 2
    q, k, v, bias, mask = _mk(rng, H * B, nW, T, D, H)
    P = swa._pick_pack_packed(nW, T)
    nblk, PT = nW // P, P * T
    shape = (H * B, nblk, PT, D)
    add = swa._packed_add_term(torch.from_numpy(bias), torch.from_numpy(mask), P, nblk)
    add = add.contiguous().numpy()
    w = rng.standard_normal(shape).astype(np.float32)
    qp, kp, vp = (a.reshape(shape) for a in (q, k, v))
    scale = D ** -0.5

    def jloss(a):
        out = jswa._packed_attention(*map(jnp.asarray, (qp, kp, vp)), a, scale, B, True)
        return jnp.sum(out * jnp.asarray(w)), out

    (_, jout), jdadd = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(add))
    ta = torch.from_numpy(add).requires_grad_()
    out = swa._packed_attention(*map(torch.from_numpy, (qp, kp, vp)), ta, scale, B, T)
    (dadd,) = torch.autograd.grad((out * torch.from_numpy(w)).sum(), ta)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=2e-5)
    np.testing.assert_allclose(dadd.numpy(), np.asarray(jdadd), atol=1e-4)


def test_dispatcher_layout_matches_jax():
    """swin_attention's (Bw, H, T, D) <-> kernel layout round trip, masked
    and unmasked, for both contracts, against the JAX dispatcher."""
    rng = np.random.default_rng(4)
    B, nW, H, T, D = 2, 4, 3, 49, 32
    q, k, v = (rng.standard_normal((B * nW, H, T, D)).astype(np.float32) for _ in range(3))
    bias = rng.standard_normal((H, T, T)).astype(np.float32)
    m = rng.integers(0, 2, size=(nW, T, 1))
    mask = np.where(m == m.transpose(0, 2, 1), 0.0, -100.0).astype(np.float32)
    scale = D ** -0.5
    mp = pytest.MonkeyPatch()
    try:
        for packed in (True, False):
            mp.setattr(swa, "SWIN_KERNEL_PACKED", packed)
            mp.setattr(jswa, "SWIN_KERNEL_PACKED", packed)
            for mk in (mask, None):
                ref = jswa.swin_attention(*map(_j, (q, k, v, bias, mk)), scale, n_windows=nW,
                                          interpret=True)
                ours = swa.swin_attention(*map(_t, (q, k, v, bias, mk)), scale, n_windows=nW)
                np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-5)
    finally:
        mp.undo()


def test_dispatcher_returns_none_where_jax_does():
    """One window an image (nW < 4), D not a multiple of 8, and a T
    mismatch: both dispatchers return None."""
    rng = np.random.default_rng(5)
    bias = np.zeros((2, 49, 49), np.float32)
    cases = [
        (rng.standard_normal((2, 2, 49, 32)), 1),        # stage-3-like global attention
        (rng.standard_normal((8, 2, 49, 12)), 4),        # D % 8
    ]
    for q, nW in cases:
        q = q.astype(np.float32)
        assert jswa.swin_attention(jnp.asarray(q), jnp.asarray(q), jnp.asarray(q),
                                   jnp.asarray(bias), None, 0.1, n_windows=nW,
                                   interpret=True) is None
        tq = torch.from_numpy(q)
        assert swa.swin_attention(tq, tq, tq, torch.from_numpy(bias), None, 0.1,
                                  n_windows=nW) is None
    q = torch.zeros((8, 2, 49, 32))
    assert swa.swin_attention(q, q[:, :, :48], q, torch.from_numpy(bias), None, 0.1,
                              n_windows=4) is None
    # beyond the card kernel's window and head limits the port materialises
    q = torch.zeros((8, 1, 81, 8))
    assert swa.swin_attention(q, q, q, torch.zeros((1, 81, 81)), None, 0.1, n_windows=4) is None


def test_wrappers_take_plain_versions_on_cpu_and_refuse_other_devices():
    rng = np.random.default_rng(6)
    q, k, v, bias, mask = map(_t, _mk(rng, 4, 4, 16, 8, 2))
    before = (swa.swin_window_attention.fwd_launches,
              swa.swin_window_attention_packed.fwd_launches)
    assert torch.equal(swa.swin_window_attention(q, k, v, bias, mask, 0.3),
                       swa.swin_window_attention_plain(q, k, v, bias, mask, 0.3))
    swa.swin_window_attention_packed(q, k, v, bias, mask, 0.3)
    assert (swa.swin_window_attention.fwd_launches,
            swa.swin_window_attention_packed.fwd_launches) == before
    meta = torch.zeros((4, 4, 16, 8), device="meta")
    with pytest.raises(ValueError):
        swa.swin_window_attention(meta, meta, meta, bias.to("meta"), None, 0.3)
    with pytest.raises(ValueError):
        swa.swin_window_attention_packed(meta, meta, meta, bias.to("meta"), None, 0.3)


def _qkv_case(rng, B, nW, H, T, D, with_mask):
    Bw, C = B * nW, H * D
    qkv = rng.standard_normal((Bw, T, 3 * C)).astype(np.float32)
    bias = rng.standard_normal((H, T, T)).astype(np.float32)
    mask = None
    if with_mask:
        m = rng.integers(0, 2, size=(nW, T, 1))
        mask = np.where(m == m.transpose(0, 2, 1), 0.0, -100.0).astype(np.float32)
    return qkv, bias, mask


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "batched"])
@pytest.mark.parametrize("with_mask", [False, True], ids=["nomask", "mask"])
def test_qkv_entry_matches_jax(packed, with_mask):
    """swin_attention_qkv on the model's (Bw, T, 3C) projection against the
    JAX dispatcher given the same projection split as
    vit_reranking_tpu/models/swin.py:154 splits it (kernels in interpret
    mode): the output as proj takes it and the gradients of qkv and bias."""
    rng = np.random.default_rng(7)
    B, nW, H, T, D = 2, 4, 2, 16, 8
    Bw, C = B * nW, H * D
    qkv, bias, mask = _qkv_case(rng, B, nW, H, T, D, with_mask)
    w = rng.standard_normal((Bw, T, C)).astype(np.float32)
    scale = D ** -0.5

    def jout(x, b):
        q, k, v = x.reshape(Bw, T, 3, H, D).transpose(2, 0, 3, 1, 4)
        out = jswa.swin_attention(q, k, v, b, _j(mask), scale, n_windows=nW, interpret=True)
        return out.transpose(0, 2, 1, 3).reshape(Bw, T, C)

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(swa, "SWIN_KERNEL_PACKED", packed)
        mp.setattr(jswa, "SWIN_KERNEL_PACKED", packed)
        ref, jgrads = jax.value_and_grad(
            lambda x, b: (lambda o: (jnp.sum(o * jnp.asarray(w)), o))(jout(x, b)),
            argnums=(0, 1), has_aux=True)(jnp.asarray(qkv), jnp.asarray(bias))
        ref = ref[1]
        tq, tb = (torch.from_numpy(a).requires_grad_() for a in (qkv, bias))
        out = swa.swin_attention_qkv(tq, tb, _t(mask), scale, H, n_windows=nW)
        grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (tq, tb))
    finally:
        mp.undo()
    assert out.shape == (Bw, T, C)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5)
    for a, b, name in zip(grads, jgrads, ("dqkv", "dbias")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, err_msg=name)


def test_qkv_entry_returns_none_where_swin_attention_does():
    """One window an image, D not a multiple of 8, and a window beyond the
    card kernel's 64 tokens: the qkv entry returns None, as swin_attention
    does for the same q, k, v."""
    rng = np.random.default_rng(8)
    for B, nW, H, T, D in ((2, 1, 2, 49, 32), (2, 4, 2, 49, 12), (2, 4, 1, 81, 8)):
        qkv, bias, _ = _qkv_case(rng, B, nW, H, T, D, False)
        tq, tb = torch.from_numpy(qkv), torch.from_numpy(bias)
        q, k, v = tq.reshape(B * nW, T, 3, H, D).permute(2, 0, 3, 1, 4)
        assert swa.swin_attention(q, k, v, tb, None, 0.1, n_windows=nW) is None
        assert swa.swin_attention_qkv(tq, tb, None, 0.1, H, n_windows=nW) is None
