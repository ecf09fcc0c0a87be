"""K3, the direct conv weight gradient, against the JAX package.

The plain version is held against the Pallas kernel
``ealv_tpu.ops.pallas_wgrad.conv_wgrad_direct`` in interpret mode (its HWIO
result transposed to OIHW); the autograd function against autograd of
``F.conv2d``; and the whole CVAE with ``fast_encoder_grads="pallas"``
against the JAX CVAE with the same switch, in the form of
``tests/test_kernels.py::TestFastConv``. f32, TF32 off. On the CPU the
port takes the kernel's plain version; the kernel itself is held against it
in ``test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ealv_tpu.models import CVAE as JCVAE, cvae_loss as j_loss
from ealv_tpu.ops.pallas_wgrad import conv_wgrad_direct as j_wgrad
from ealv_tpu_torch.models import CVAE, cvae_loss
from ealv_tpu_torch.ops import conv2d_valid_direct, conv_wgrad_direct
from ealv_tpu_torch.utils.convert import params_from_jax
from test_torch_trainer import one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# (B, H, W, Cin, Cout, k, s): the probe shapes of tests/test_kernels.py
# (the s2d pad, k = s, k > s and 1x1 cases)
PROBES = [(2, 17, 17, 3, 5, 3, 2), (1, 20, 20, 4, 6, 5, 3),
          (2, 16, 16, 2, 3, 3, 3), (1, 13, 11, 1, 2, 1, 1)]


def _inputs(shape, seed=0):
    B, H, W, cin, cout, k, s = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, W, cin)).astype(np.float32)
    cot = rng.normal(size=(B, (H - k) // s + 1, (W - k) // s + 1, cout)).astype(np.float32)
    return x, cot


@pytest.mark.parametrize("shape", PROBES)
def test_plain_matches_pallas_kernel(shape):
    """f32 sums in another order: rtol 1e-5, atol 1e-4."""
    x, cot = _inputs(shape)
    k, s = shape[5], shape[6]
    want = np.asarray(j_wgrad(jnp.asarray(x), jnp.asarray(cot), k=k, stride=s,
                              interpret=True)).transpose(3, 2, 0, 1)
    got = conv_wgrad_direct(torch.from_numpy(x).permute(0, 3, 1, 2),
                            torch.from_numpy(cot).permute(0, 3, 1, 2), k, s)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    assert conv_wgrad_direct.launches == 0  # CPU tensors never reach the kernel


def test_plain_reads_bf16_inputs():
    """bf16 inputs are upcast and summed in f32, as the TPU kernel does:
    against the Pallas kernel on the same bf16 values, rtol 1e-5, atol 1e-4."""
    shape = PROBES[0]
    x, cot = _inputs(shape, seed=1)
    xb, cb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(cot, jnp.bfloat16)
    want = np.asarray(j_wgrad(xb, cb, k=3, stride=2, interpret=True)).transpose(3, 2, 0, 1)
    tx = torch.tensor(np.asarray(xb.astype(jnp.float32))).bfloat16().permute(0, 3, 1, 2)
    tc = torch.tensor(np.asarray(cb.astype(jnp.float32))).bfloat16().permute(0, 3, 1, 2)
    got = conv_wgrad_direct(tx, tc, 3, 2)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape", PROBES)
def test_autograd_function_matches_conv2d(shape):
    """Forward bit-equal to F.conv2d; dx (the floor-divided tail rows and
    columns zero) and dW against autograd of F.conv2d: rtol 1e-5, atol
    1e-5. dx is not computed when x needs no gradient."""
    x, cot = _inputs(shape, seed=2)
    B, H, W, cin, cout, k, s = shape
    w = np.random.default_rng(3).normal(size=(cout, cin, k, k)).astype(np.float32)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    tc = torch.from_numpy(cot).permute(0, 3, 1, 2)
    xa, wa = tx.clone().requires_grad_(), torch.tensor(w, requires_grad=True)
    xb, wb = tx.clone().requires_grad_(), torch.tensor(w, requires_grad=True)
    ya, yb = conv2d_valid_direct(xa, wa, s), F.conv2d(xb, wb, stride=s)
    assert torch.equal(ya, yb)
    (ya * tc).sum().backward()
    (yb * tc).sum().backward()
    torch.testing.assert_close(xa.grad, xb.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(wa.grad, wb.grad, rtol=1e-5, atol=1e-5)
    wc = torch.tensor(w, requires_grad=True)
    (conv2d_valid_direct(tx, wc, s) * tc).sum().backward()
    torch.testing.assert_close(wc.grad, wb.grad, rtol=1e-5, atol=1e-5)


KW = dict(img_dim=(24, 24, 3), z_dim=8, s_dim=2, hidden_dim=(32, 16),
          cnn_kernels=(3, 3), cnn_strides=(2, 2), cnn_channels=(4, 6))


def test_model_grads_match_jax_pallas_variant():
    """Whole-model loss and gradients with fast_encoder_grads="pallas" on
    both sides (JAX's Pallas wgrad in interpret mode), from the same
    weights and batch: loss at 1e-5, gradients at atol 1e-6."""
    rng = np.random.default_rng(0)
    jm = JCVAE(fast_encoder_grads="pallas", **KW)
    jp = jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 2)),
                 jnp.zeros((1, 24, 24, 3)), train=False)
    x = rng.normal(size=(4, 2)).astype(np.float32)
    y = rng.uniform(size=(4, 24, 24, 3)).astype(np.float32)

    def jloss(p):
        out = jm.apply(p, jnp.asarray(x), jnp.asarray(y), train=False)
        return j_loss(out, jnp.asarray(y), beta=0.01, gamma=0.1, gamma_weight=0.1,
                      learn_force=False, other_locs=False)[0]

    jl, jg = jax.value_and_grad(jloss)(jp)
    tm = CVAE(fast_encoder_grads="pallas", **KW)
    tm.load_state_dict(params_from_jax(jp, tm))
    out = tm(torch.from_numpy(x), torch.from_numpy(y))
    tl, _ = cvae_loss(out, torch.from_numpy(y), beta=0.01, gamma=0.1, gamma_weight=0.1,
                      other_locs=False)
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) < 1e-5
    want = params_from_jax(jg, tm)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=1e-6,
                                   err_msg=name)


def test_model_switch_keeps_parameters_and_values():
    """fast_encoder_grads="pallas" changes no parameter key and no value:
    the same weights give the same loss and gradients as the plain encoder
    (f32: rtol 1e-5, atol 1e-6)."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(3, 2)).astype(np.float32))
    y = torch.from_numpy(rng.uniform(size=(3, 24, 24, 3)).astype(np.float32))
    models = [CVAE(fast_encoder_grads=v, **KW) for v in (False, "pallas")]
    models[0].reset_parameters(torch.Generator().manual_seed(0))
    models[1].load_state_dict(models[0].state_dict())
    losses = []
    for m in models:
        loss, _ = cvae_loss(m(x, y), y, beta=0.01, gamma=0.1, other_locs=False)
        loss.backward()
        losses.append(loss)
    torch.testing.assert_close(losses[1], losses[0], rtol=1e-5, atol=1e-6)
    for (n0, p0), (n1, p1) in zip(*(m.named_parameters() for m in models)):
        assert n0 == n1
        torch.testing.assert_close(p1.grad, p0.grad, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("variant", [True, "im2col"])
def test_other_variants_raise(variant):
    with pytest.raises(NotImplementedError):
        CVAE(fast_encoder_grads=variant, **KW)
