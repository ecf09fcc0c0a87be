"""The explore-and-learn tick under each CVAE option, the port against the
JAX ``Experiment`` at the toy size, step-matched: two ticks from the same
weights with the JAX ticks' draws fed to the port (the second tick trains),
at the tolerances of ``test_torch_tick.py::test_two_ticks_step_matched``.
f32, TF32 off.
"""

import pytest

from test_torch_tick import TOY, _two_ticks_step_matched
from test_torch_trainer import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("opts", [dict(decoder_mode="subpixel"),
                                  dict(decoder_mode="resize_conv"),
                                  dict(fast_encoder_grads="s2d"),
                                  dict(fast_encoder_grads="im2col"),
                                  dict(lane_pad=8),
                                  dict(lane_pad=8, fast_encoder_grads=True)],
                         ids=["subpixel", "resize_conv", "s2d", "im2col", "lane8",
                              "lane8_s2d"])
def test_two_ticks_step_matched(opts):
    _two_ticks_step_matched({**TOY, **opts})
