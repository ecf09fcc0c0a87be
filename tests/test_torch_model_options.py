"""The CVAE's options at the layer level, the port against the JAX package:
the encoder's weight-gradient schedules (``ops/fast_conv.py``), the
subpixel transposed conv (``models/subpixel.py``), the resize of the
``"resize_conv"`` decoder, and the ``"subpixel"`` decoder's edge pad.

Inputs come from numpy with a seed; f32 with TF32 off. Tolerances: the
forward and dx at 1e-5 (the same conv on both sides, summed in another
order), dW at rtol 1e-5, atol 1e-4 (sums of up to 1k products, in another
grouping), as ``tests/test_kernels.py::TestFastConv`` holds the JAX
schedules against autodiff.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn

from ealv_tpu.models import CVAE as JCVAE
from ealv_tpu.models.subpixel import (subpixel_conv_transpose as j_subpixel,
                                      subpixel_conv_transpose_d2s as j_subpixel_d2s)
from ealv_tpu.ops.fast_conv import CONV_VARIANTS as J_VARIANTS
from ealv_tpu_torch.models import CVAE
from ealv_tpu_torch.models.subpixel import (subpixel_conv_transpose,
                                            subpixel_conv_transpose_d2s)
from ealv_tpu_torch.ops.fast_conv import CONV_VARIANTS, tap_index
from ealv_tpu_torch.utils.convert import params_from_jax
from test_torch_trainer import one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# (B, H, W, Cin, Cout, k, s): tests/test_kernels.py::TestFastConv's shapes
# (the s2d pad, k = s, k > s and 1x1 cases)
SHAPES = [(2, 17, 17, 3, 5, 3, 2), (1, 20, 20, 4, 6, 5, 3),
          (2, 16, 16, 2, 3, 3, 3), (1, 13, 11, 1, 2, 1, 1)]
# (H, k, s, Cin, Cout): tests/test_cvae.py::TestDecoderModes's decoder shapes
SUBPIXEL = [(14, 5, 3, 20, 10), (44, 3, 2, 10, 10), (7, 4, 2, 3, 5)]


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("variant", [True, "s2d", "im2col"])
@pytest.mark.parametrize("shape", SHAPES)
def test_schedule_matches_jax(shape, variant):
    """Forward, dx and dW of each schedule against the JAX schedule's
    custom VJP on the same x, w and cotangent."""
    B, H, W, cin, cout, k, s = shape
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=(B, H, W, cin)).astype(np.float32)
    w = rng.normal(size=(k, k, cin, cout)).astype(np.float32)
    cot = rng.normal(size=(B, (H - k) // s + 1, (W - k) // s + 1, cout)).astype(np.float32)
    jconv = J_VARIANTS[variant]
    want, vjp = jax.vjp(lambda x, w: jconv(x, w, s), jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(cot))

    xt = _nchw(x).requires_grad_()
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))).requires_grad_()
    taps = tap_index(k, s, cin) if variant in (True, "s2d") else None
    got = CONV_VARIANTS[variant](xt, wt, s, taps)
    got.backward(_nchw(cot))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(jdx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(wt.grad.permute(2, 3, 1, 0).numpy(), np.asarray(jdw),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape", SHAPES)
def test_s2d_taps_built_on_the_fly_match(shape):
    """Without ``taps`` the s2d backward builds its gather itself and
    gives the same bits; bf16 inputs give dW in bf16 and dx in bf16."""
    B, H, W, cin, cout, k, s = shape
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(B, cin, H, W)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(cout, cin, k, k)).astype(np.float32))
    grads = []
    for taps in (tap_index(k, s, cin), None):
        xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
        CONV_VARIANTS["s2d"](xs, ws, s, taps).sum().backward()
        grads.append((xs.grad, ws.grad))
    assert torch.equal(grads[0][0], grads[1][0]) and torch.equal(grads[0][1], grads[1][1])
    xb, wb = x.bfloat16().requires_grad_(), w.bfloat16().requires_grad_()
    for variant in ("s2d", "im2col"):
        CONV_VARIANTS[variant](xb, wb, s).float().sum().backward()
        assert xb.grad.dtype == wb.grad.dtype == torch.bfloat16
        xb.grad = wb.grad = None


@pytest.mark.parametrize("shape", SUBPIXEL)
def test_subpixel_forms_match_jax_and_conv_transpose(shape):
    """Both subpixel forms against the JAX functions on the flax kernel and
    against F.conv_transpose2d on the port's weight (``params_from_jax``'s
    flip), f32 at 1e-4 as tests/test_cvae.py holds the JAX forms; the
    gradients of the d2s form against conv_transpose2d's at 1e-4."""
    h, k, s, cin, cout = shape
    rng = np.random.default_rng(h)
    x = rng.standard_normal((2, h, h, cin)).astype(np.float32)
    K = rng.standard_normal((k, k, cin, cout)).astype(np.float32)
    Wt = torch.from_numpy(np.ascontiguousarray(K[::-1, ::-1].transpose(2, 3, 0, 1)))
    xt = _nchw(x)
    ref = F.conv_transpose2d(xt, Wt, stride=s)
    flax_ref = nn.ConvTranspose(cout, (k, k), strides=(s, s), padding="VALID",
                                use_bias=False).apply({"params": {"kernel": K}}, x)
    np.testing.assert_allclose(_nhwc(ref), np.asarray(flax_ref), rtol=1e-4, atol=1e-4)
    for jf, tf in ((j_subpixel, subpixel_conv_transpose),
                   (j_subpixel_d2s, subpixel_conv_transpose_d2s)):
        got = tf(xt, Wt, s)
        assert got.shape == ref.shape
        np.testing.assert_allclose(_nhwc(got), np.asarray(jf(jnp.asarray(x), K, s)),
                                   rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    cot = torch.from_numpy(rng.standard_normal(tuple(ref.shape)).astype(np.float32))
    grads = []
    for f in (F.conv_transpose2d, subpixel_conv_transpose_d2s):
        a, b = xt.clone().requires_grad_(), Wt.clone().requires_grad_()
        f(a, b, stride=s).backward(cot)
        grads.append((a.grad, b.grad))
    for g0, g1 in zip(*grads):
        torch.testing.assert_close(g1, g0, rtol=1e-4, atol=1e-4)


def test_subpixel_phase_without_taps():
    """k < s leaves phases with no tap: their outputs are zeros in both
    forms, as F.conv_transpose2d gives."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 2, 5, 6)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((2, 3, 2, 2)).astype(np.float32))
    ref = F.conv_transpose2d(x, w, stride=3)
    for f in (subpixel_conv_transpose, subpixel_conv_transpose_d2s):
        torch.testing.assert_close(f(x, w, 3), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("size", [(14, 44), (44, 89), (89, 180), (2, 10), (10, 22),
                                  (22, 45), (1, 5), (5, 11), (11, 24)])
def test_nearest_exact_is_jax_nearest(size):
    """The resize_conv decoder's upsampling at the production model's sizes
    and the test models' (45x45 and 24x24): jax.image.resize "nearest" is
    torch's "nearest-exact", bit for bit."""
    a, b = size
    x = np.random.default_rng(a).standard_normal((2, a, a, 3)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, b, b, 3), "nearest")
    got = F.interpolate(_nchw(x), size=(b, b), mode="nearest-exact")
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want))


def test_resize_conv_init_follows_flax_conv_law():
    """The resize_conv decoder's Conv2d weights: truncated lecun-normal with
    fan-in k * k * Cin, zero biases, as flax's nn.Conv."""
    tm = CVAE(img_dim=(45, 45, 3), z_dim=8, hidden_dim=(32, 16), decoder_mode="resize_conv",
              cnn_channels=(40, 40, 40))
    tm.reset_parameters(torch.Generator().manual_seed(0))
    convs = [m for m in tm.img_decoder if isinstance(m, torch.nn.Conv2d)]
    assert [tuple(m.weight.shape) for m in convs] == [(40, 40, 5, 5), (40, 40, 3, 3),
                                                       (3, 40, 3, 3)]
    for m in convs:
        w = m.weight.detach()
        fan_in = w.shape[1] * w.shape[2] * w.shape[3]
        std = (1 / fan_in) ** 0.5 / 0.87962566103423978
        assert float(w.abs().max()) <= 2 * std + 1e-6
        assert abs(float(w.std()) - (1 / fan_in) ** 0.5) < 0.1 * (1 / fan_in) ** 0.5
        assert float(m.bias.detach().abs().max()) == 0.0


def test_unknown_options_raise():
    """An unknown decoder_mode raises ValueError, as the JAX CVAE's setup
    does; an unknown schedule raises too (the JAX module's lookup fails)."""
    with pytest.raises(ValueError, match="decoder_mode"):
        CVAE(img_dim=(24, 24, 3), decoder_mode="bogus")
    with pytest.raises(ValueError, match="fast_encoder_grads"):
        CVAE(img_dim=(24, 24, 3), fast_encoder_grads="bogus")


def _decoders(img_dim):
    """The JAX and port CVAEs under "conv_transpose" and "subpixel", all
    four from one set of JAX weights."""
    kw = dict(img_dim=img_dim, z_dim=6, s_dim=2, hidden_dim=(32, 16))
    jms = {m: JCVAE(decoder_mode=m, **kw) for m in ("conv_transpose", "subpixel")}
    jp = jms["conv_transpose"].init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 2)),
                                    jnp.zeros((1, *img_dim)), train=False)
    tms = {}
    for m in jms:
        tms[m] = CVAE(decoder_mode=m, **kw)
        tms[m].load_state_dict(params_from_jax(jp, tms[m]))
    return jms, jp, tms


@pytest.mark.parametrize("img_dim", [(45, 45, 3), (24, 24, 3)])
def test_subpixel_decoder_differs_where_jax_does(img_dim):
    """The reference quirk: the JAX "subpixel" decoder edge-pads a short
    layer where "conv_transpose" zero-extends it, so the two modes compute
    different functions from the same weights. The port's two modes differ
    at exactly the pixels where the JAX modes do (f32; a pixel "differs"
    above 1e-4), and each port mode agrees with its JAX mode at 1e-4."""
    jms, jp, tms = _decoders(img_dim)
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (3, 2)).astype(np.float32)
    y = rng.uniform(0, 1, (3, *img_dim)).astype(np.float32)
    want = {m: np.asarray(jms[m].apply(jp, jnp.asarray(x), jnp.asarray(y))["img_pred"])
            for m in jms}
    got = {m: tms[m](torch.from_numpy(x), torch.from_numpy(y))["img_pred"].detach().numpy()
           for m in tms}
    for m in jms:
        np.testing.assert_allclose(got[m], want[m], rtol=1e-4, atol=1e-4)
    j_diff = np.abs(want["subpixel"] - want["conv_transpose"]) > 1e-4
    t_diff = np.abs(got["subpixel"] - got["conv_transpose"]) > 1e-4
    assert j_diff.any()
    np.testing.assert_array_equal(t_diff, j_diff)


def test_subpixel_decoder_differs_at_the_last_row_at_180():
    """At the production frame (180x180, the default encoder) only the
    last decoder layer falls short (179 rows): "subpixel" copies row and
    column 178 into 179, "conv_transpose" leaves them bias only. The port's
    two modes agree everywhere else (f32, 1e-4)."""
    kw = dict(img_dim=(180, 180, 3), z_dim=4, s_dim=2, hidden_dim=(16, 8))
    models = {m: CVAE(decoder_mode=m, **kw) for m in ("conv_transpose", "subpixel")}
    models["conv_transpose"].reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in models["conv_transpose"].parameters():
            p.add_(0.05)  # nonzero biases
    models["subpixel"].load_state_dict(models["conv_transpose"].state_dict())
    assert [o for o in models["conv_transpose"].output_padding] == [(0, 0), (0, 0), (1, 1)]
    feat = torch.randn(2, models["subpixel"].feat_dim, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ct, sp = (models[m].img_decode(feat) for m in ("conv_transpose", "subpixel"))
    torch.testing.assert_close(sp[:, :179, :179], ct[:, :179, :179], rtol=1e-4, atol=1e-4)
    assert torch.equal(sp[:, 179], sp[:, 178]) and torch.equal(sp[:, :, 179], sp[:, :, 178])
    bias = models["conv_transpose"].img_decoder[5].bias
    torch.testing.assert_close(ct[:, 179], bias.expand(2, 180, 3), rtol=0, atol=0)
    assert not torch.allclose(sp[:, 179], ct[:, 179], atol=1e-3)


@pytest.mark.parametrize("mode", ["resize_conv", "subpixel"])
def test_adam_moments_cross_for_each_decoder(mode):
    """``opt_state_from_jax`` maps an optax Adam state's moments through
    ``params_from_jax``: a resize_conv decoder's flax Conv kernels as plain
    convs (HWIO -> OIHW, no flip), a subpixel decoder's as transposed convs
    (flipped), bit for bit."""
    import optax
    from ealv_tpu_torch.utils.convert import opt_state_from_jax

    kw = dict(img_dim=(24, 24, 3), z_dim=6, s_dim=2, hidden_dim=(32, 16), decoder_mode=mode)
    jm = JCVAE(**kw)
    jp = jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 2)), jnp.zeros((1, 24, 24, 3)),
                 train=False)
    grads = jax.tree.map(lambda a: jnp.ones_like(a) * 0.3 + a, jp)
    tx = optax.adam(1e-3)
    _, state = tx.update(grads, tx.init(jp), jp)
    tm = CVAE(**kw)
    opt = torch.optim.Adam(tm.parameters(), lr=1e-3)
    sd = opt_state_from_jax(state, tm, opt)
    opt.load_state_dict(sd)
    names = [n for n, _ in tm.named_parameters()]
    mu = state[0].mu["params"]
    for j, li in enumerate((1, 3, 5)):
        K = np.asarray(mu[f"dec_conv{j}"]["kernel"])
        want = (K.transpose(3, 2, 0, 1) if mode == "resize_conv"
                else K[::-1, ::-1].transpose(2, 3, 0, 1))
        got = opt.state_dict()["state"][names.index(f"img_decoder.{li}.weight")]["exp_avg"]
        np.testing.assert_array_equal(got.numpy(), want)
        assert int(opt.state_dict()["state"][0]["step"]) == 1
