"""The yardstick's counts against hand counts."""

import dataclasses

import pytest

from port_bench import counts
from port_bench.drive import reference_config


def _cfg(**kw):
    return dataclasses.asdict(reference_config({**kw}))


def test_cvae_flops_at_a_toy_shape_by_hand():
    cfg = _cfg(states="xy", image_dim=(8, 8, 1), cnn_kernels=(3,), cnn_strides=(2,),
               cnn_channels=(2,), hidden_dim=(4,), z_dim=2, y_logvar_dim=1)
    # conv 8x8x1 -> 3x3x2 (k 3, s 2): 9 pixels x 2 out x 1 in x 9 taps x 2
    conv = 9 * 2 * 1 * 9 * 2
    feat = 3 * 3 * 2
    enc = conv + 2 * (feat + 2) * 4 + 2 * 4 * (2 * 2)
    dec_mlp = 2 * (2 + 2) * 4 + 2 * 4 * (1 + feat)
    deconv = 9 * 2 * 1 * 9 * 2  # every input pixel scatters k*k*c_out products
    assert counts.cvae_flops(cfg) == dict(encode=enc, decode_mlp=dec_mlp, img_decode=deconv)


def test_cvae_flops_at_production_shapes_by_hand():
    cfg = _cfg()
    # 180 -> 89 -> 44 -> 14 (k 3, 3, 5; s 2, 2, 3); channels 3 -> 10 -> 10 -> 20
    conv = 2 * (89 * 89 * 10 * 3 * 9 + 44 * 44 * 10 * 10 * 9 + 14 * 14 * 20 * 10 * 25)
    feat = 14 * 14 * 20
    enc = conv + 2 * ((feat + 3) * 512 + 512 * 256 + 256 * 32)
    dec_mlp = 2 * ((16 + 3) * 256 + 256 * 512 + 512 * (1 + feat))
    assert counts.cvae_flops(cfg) == dict(encode=enc, decode_mlp=dec_mlp, img_decode=conv)
    # a trainer call: 25 steps x 3 x (64 encodes + 128 decodes)
    per_step = 64 * enc + 128 * (dec_mlp + conv)
    assert counts.trainer_call_flops(cfg) == 25 * 3 * per_step
    assert counts.tick_flops(cfg, learning=True, trained=True) == \
        2000 * dec_mlp + enc + dec_mlp + conv + 25 * 3 * per_step
    assert counts.tick_flops(cfg, learning=False, trained=False) == 2000 * dec_mlp


def test_hidden_widths_expand_as_the_configuration_does():
    from port_bench.reference.config import ExperimentConfig
    for image in ((180, 180, 3), (360, 360, 3), (64, 64, 1)):
        c = ExperimentConfig(image_dim=image)
        assert counts.hidden_widths(dataclasses.asdict(c)) == c.model_hidden()


@pytest.mark.parametrize("decoder_mode", ["conv_transpose", "subpixel", "resize_conv"])
@pytest.mark.parametrize("fast_encoder_grads", [False, True, "s2d", "im2col", "pallas"])
def test_counts_do_not_follow_the_program_paths(decoder_mode, fast_encoder_grads):
    base = _cfg()
    cfg = {**base, "decoder_mode": decoder_mode, "fast_encoder_grads": fast_encoder_grads,
           "lane_pad": 8}
    for learning, trained in ((True, True), (True, False), (False, False)):
        assert counts.tick_flops(cfg, learning, trained) == \
            counts.tick_flops(base, learning, trained)


def test_k1_bound_against_a_hand_count():
    # 2000 x 3000 x 3, all unmasked: 6e6 pairs x 14 operations at 67 TFLOP/s
    s, what = counts.k1_bound_s(2000, 3000, 3, 3000)
    assert what == "operations" and s == pytest.approx(6e6 * 14 / 67e12)
    # 2000 x 10 x 6: the bytes bound (4 bytes x (12000 + 60 + 6 + 10 + 4000))
    s, what = counts.k1_bound_s(2000, 10, 6, 10)
    assert what == "bytes" and s == pytest.approx(4 * 16076 / 3.35e12)
    # nothing unmasked: the bytes alone
    assert counts.k1_bound_s(2000, 3000, 3, 0)[1] == "bytes"


def test_k1_launches_of_a_planner_call():
    cfg = _cfg()
    learn = counts.k1_tick_launches(cfg, learning=True, fill=120)
    assert len(learn) == 13  # spread, base, initial cost, 2 x 5 inner iterations
    assert learn[0] == (2000, 3000, 3, 120) and learn[1] == (2000, 3000, 3, 120)
    assert learn[2:] == [(2000, 10, 3, 10)] * 11
    assert len(counts.k1_tick_launches(cfg, learning=False, fill=5000)) == 12
    assert counts.k1_tick_launches(cfg, learning=False, fill=5000)[0] == (2000, 3000, 3, 3000)


@pytest.mark.parametrize("config,learning,trained,flops", [
    ("xyw", True, True, 210375028536), ("xyw", True, False, 8601978936),
    ("xyw", False, False, 8573952000), ("xyzrpw", True, True, 210407596344),
    ("xyzrpw", True, False, 8605055544), ("xyzrpw", False, False, 8577024000),
])
def test_the_cells_tick_flops_are_pinned(config, learning, trained, flops):
    """The four cells' configurations run neither variant: their counts stay
    as they were before ``learn_force`` and ``use_z_ensemble`` were read."""
    from port_bench import harness
    cfg = harness.load_json(harness.ROOT / "configs" / f"{config}.json")["config"]
    assert not cfg["learn_force"] and not cfg["use_z_ensemble"]
    assert counts.tick_flops(cfg, learning, trained) == flops


def test_learn_force_widens_the_dense_layers_by_hand():
    cfg = _cfg(states="xy", image_dim=(8, 8, 1), cnn_kernels=(3,), cnn_strides=(2,),
               cnn_channels=(2,), hidden_dim=(4,), z_dim=2, y_logvar_dim=1, learn_force=True)
    conv = 9 * 2 * 1 * 9 * 2
    feat = 3 * 3 * 2
    # the encoder takes [feat, force, pose]; the head gives [y_logvar, force_pred, feat]
    enc = conv + 2 * (feat + 1 + 2) * 4 + 2 * 4 * (2 * 2)
    dec_mlp = 2 * (2 + 2) * 4 + 2 * 4 * (1 + 1 + feat)
    assert counts.cvae_flops(cfg) == dict(encode=enc, decode_mlp=dec_mlp, img_decode=conv)


def test_the_z_ensemble_decodes_under_each_latent_by_hand():
    base = _cfg()
    f = counts.cvae_flops(base)
    cfg = {**base, "use_z_ensemble": True}
    assert counts.cvae_flops(cfg) == f
    assert counts.tick_flops(cfg, learning=False, trained=False) == 5 * 2000 * f["decode_mlp"]
    assert counts.tick_flops(cfg, learning=True, trained=False) == \
        5 * 2000 * f["decode_mlp"] + f["encode"] + f["decode_mlp"] + f["img_decode"]
    # a trainer call's entropy grade decodes the target samples afresh,
    # plainly, where the planner's decode is an ensemble's
    assert counts.tick_flops(cfg, learning=True, trained=True) == \
        5 * 2000 * f["decode_mlp"] + f["encode"] + f["decode_mlp"] + f["img_decode"] \
        + counts.trainer_call_flops(base) + 2000 * f["decode_mlp"]
    fresh = {**base, "hyper_from_planner": False}
    assert counts.tick_flops(fresh, True, True) == \
        counts.tick_flops(base, True, True) + 2000 * f["decode_mlp"]
