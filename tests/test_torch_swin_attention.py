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

On the card the qkv entry runs the packed contract as the batched function
(bias and mask, no (H, nblk, P T, P T) additive term): the diagonal blocks
of _packed_add_term are bias[h] + mask[w] to the bit, and the batched plain
version fed bias and mask matches the JAX packed kernel, forward and
gradients with dbias against the bias gradient of the JAX packed path (its
bf16 form in tests/test_torch_bf16.py).  The bf16 core's runs of images
(_persistent_runs) are held to their choice, and the design choices that
chip_k4_variants.py builds undone, edits of the kept sources' text, to
texts the sources hold.

On the CPU the port runs each contract's plain version, differentiated by
autograd; the CUDA kernels are held against those plain versions on the card
(tests/test_torch_kernels.py).
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import vit_reranking_tpu.ops.swin_attention_pallas as jswa
import vit_reranking_tpu_torch.ops.swin_attention as swa
from vit_reranking_tpu_torch.models.swin import _shift_attn_mask

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


@pytest.mark.parametrize("with_mask", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("nW,T", [(64, 49), (16, 49), (4, 49), (8, 16)])
def test_packed_add_term_diagonal_is_bias_plus_mask(nW, T, with_mask):
    """Every diagonal (T, T) block of the packed additive term is bias[h] +
    mask[w] to the bit (its off-diagonal -1e9 is a -0.0 there), so the card
    may run the packed contract from bias and mask."""
    rng = np.random.default_rng(9)
    _, _, _, bias, mask = _mk(rng, 1, nW, T, 8, 3, with_mask)
    if with_mask and T == 49:
        mask = _shift_attn_mask(*(int(round((nW * 49) ** 0.5)),) * 2, 7, 3)
    P = swa._pick_pack_packed(nW, T)
    add = swa._packed_add_term(_t(bias), _t(mask), P, nW // P)
    for w in range(nW):
        blk, p = divmod(w, P)
        diag = add[:, blk, p * T:(p + 1) * T, p * T:(p + 1) * T]
        want = _t(bias) + (0.0 if mask is None else _t(mask)[w])
        assert torch.equal(diag, want), w


@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
def test_batched_plain_matches_jax_packed_kernel(shifted):
    """The function the card runs for the packed qkv entry (the batched
    plain version on bias and mask) against the JAX packed kernel in
    interpret mode on Swin-T's windows (stage 2, shifted or not): the output
    (atol 2e-5) and dq, dk, dv and dbias against the JAX packed path's
    gradients, dbias through its additive term (atol 1e-4)."""
    rng = np.random.default_rng(10)
    nW, T, D, H, B = 4, 49, 32, 2, 2
    q, k, v, bias, _ = _mk(rng, H * B, nW, T, D, H, False)
    mask = _shift_attn_mask(14, 14, 7, 3) if shifted else None
    w = rng.standard_normal(q.shape).astype(np.float32)
    scale = D ** -0.5
    jm = _j(mask)
    ref, ref_grads = jax.value_and_grad(
        lambda q, k, v, b: jnp.sum(jswa.swin_window_attention_packed(q, k, v, b, jm, scale, True)
                                   * jnp.asarray(w)),
        argnums=(0, 1, 2, 3))(*map(jnp.asarray, (q, k, v, bias)))
    jout = jswa.swin_window_attention_packed(*map(jnp.asarray, (q, k, v, bias)), jm, scale, True)
    args = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias)]
    out = swa.swin_window_attention_plain(*args, _t(mask), scale)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), args)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=2e-5)
    for a, b, name in zip(grads, ref_grads, ("dq", "dk", "dv", "dbias")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, err_msg=name)


@pytest.mark.parametrize("B,H,nW,slots,want", [
    (112, 3, 64, 396, (56, 2)),   # Swin-T stage 0, forward (3 blocks an SM on 132 SMs)
    (112, 3, 64, 264, (28, 4)),   # and backward (2 an SM)
    (112, 6, 16, 264, (14, 8)),   # stage 1, backward
    (112, 12, 4, 396, (14, 8)),   # stage 2, forward
    (13, 12, 4, 396, (2, 7)),     # a last run shorter than the others
    (1, 2, 4, 264, (1, 1)),
])
def test_persistent_runs_choice(B, H, nW, slots, want):
    """The bf16 core's runs of images: the least work on the busiest of the
    persistent blocks, a unit's own cost counted as one image, and of equal
    choices the longest runs; every image in exactly one run."""
    chunk, runs = swa._persistent_runs(B, H, nW, slots)
    assert (chunk, runs) == want
    assert chunk * (runs - 1) < B <= chunk * runs


def test_qkv_entry_packed_on_cpu_runs_the_packed_plain_version(monkeypatch):
    """On the CPU the packed qkv entry stays the JAX package's arithmetic:
    the full (P T, P T) packed function on _packed_add_term."""
    rng = np.random.default_rng(11)
    qkv, bias, mask = _qkv_case(rng, 2, 4, 2, 16, 8, True)
    calls = []
    real = swa.packed_attention_plain

    def spy(*args):
        calls.append(args[3].shape)
        return real(*args)

    monkeypatch.setattr(swa, "SWIN_KERNEL_PACKED", True)
    monkeypatch.setattr(swa, "packed_attention_plain", spy)
    out = swa.swin_attention_qkv(_t(qkv), _t(bias), _t(mask), 0.3, 2, n_windows=4)
    P = swa._pick_pack_packed(4, 16)
    assert calls == [(2, 4 // P, P * 16, P * 16)] and out.shape == (8, 16, 16)


def _k4_variants():
    """chip_k4_variants.py (a card script at the repository's root), loaded
    without running it."""
    root = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        spec = importlib.util.spec_from_file_location("chip_k4_variants",
                                                      Path(root) / "chip_k4_variants.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path.remove(root)
    return module


K4_VARIANTS = _k4_variants()


@pytest.mark.parametrize("source,table,name", [
    *(("swin_attention", "VARIANTS", n) for n in K4_VARIANTS.VARIANTS),
    *(("swin_attention_bf16", "BF16_VARIANTS", n) for n in K4_VARIANTS.BF16_VARIANTS),
])
def test_k4_variant_edits_apply_to_the_kept_source(source, table, name):
    """Each variant the card script builds is the kept source with (old,
    new) edits applied in order (the routes that lost are kept only as
    such edits): every old text must be in the text it edits, so that the
    variant is what its name says (the script's build stops otherwise)."""
    from vit_reranking_tpu_torch.ops import native

    kept = (native.CSRC / f"{source}.cu").read_text()
    text = kept
    for old, new in getattr(K4_VARIANTS, table)[name]:
        assert old in text, f"{name}: {old[:60]!r} is not in {source}.cu"
        text = text.replace(old, new)
    assert text != kept
