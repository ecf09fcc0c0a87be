"""The whole step's model FLOPs over the window, as a share of the H100's
dense bf16 peak, in %: ``counts.tick_flops`` of every tick of the window
(the CVAE's convs and dense layers, a trainer step three times its
forward) over the window's seconds."""

from port_bench import counts


def read(run):
    return run["flops"] / run["window_s"] / counts.PEAK_BF16_FLOPS * 100.0
