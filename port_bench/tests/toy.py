"""A mix cut to a size a CPU test run holds: the configuration's widths
kept where the toy allows, the images, samples, rings and batch small."""

from __future__ import annotations

from port_bench import harness


def toy_mix(cell: str, **overrides) -> dict:
    """The cell ``<config>.<traffic>`` at a toy size, held to its limits."""
    config, traffic = cell.split(".")
    limits = harness.load_json(harness.ROOT / "limits" / f"{cell}.json")
    files = harness.mix_files(harness.ROOT / "configs" / f"{config}.json", traffic, limits)
    files["config"].update(image_dim=[24, 24, 3], hidden_dim=[32, 16],
                           num_target_samples=64, num_traj_samples=50,
                           traj_buffer_capacity=100, buffer_capacity=100, batch_size=8,
                           num_learning_opt=3, num_steps=90, **overrides)
    files["traffic"].update(chunk=5, settle=2)
    files["traffic"]["compare"].update(within=40)
    return files

