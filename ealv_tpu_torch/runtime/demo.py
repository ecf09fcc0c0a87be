"""Short demo: explore and learn on the synthetic scene (port of
``ealv_tpu/runtime/demo.py``).

    python -m ealv_tpu_torch.runtime.demo [--steps N] [--backend free|arm]

Runs the ``Experiment`` at the run entry's ``--small`` preset in chunks of
ticks on the card (``--device cpu`` to run it on the CPU) and prints the
learning curve and the step rate; the first chunk is warm-up and stays out
of the rate. The full entry point, with checkpoints, figures and the host
loop, is ``python -m ealv_tpu_torch.scripts.run_experiment``.
"""

from __future__ import annotations

import argparse
import time

import torch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m ealv_tpu_torch.runtime.demo",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--chunk", type=int, default=40, help="steps per chunk")
    ap.add_argument("--backend", choices=["free", "arm"], default="free")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device of the run")
    return ap


def main(argv=None):
    """Run the demo; returns (final state, steady-state steps per second,
    or None with a single chunk)."""
    args = build_parser().parse_args(argv)

    from ..utils.config import ExperimentConfig
    from .agent import Experiment

    cfg = ExperimentConfig(
        explr_method="entklerg", states="xyw", num_steps=args.steps,
        seed=args.seed, sim_backend=args.backend,
        image_dim=(48, 48, 3), cnn_kernels=(3, 3), cnn_strides=(2, 2),
        cnn_channels=(10, 10), hidden_dim=(256, 128), z_dim=12,
        num_target_samples=512, num_traj_samples=512,
        traj_buffer_capacity=1024, buffer_capacity=1024, batch_size=32,
        num_learning_opt=10,
    )
    exp = Experiment(cfg, train_calls_per_tick=1, device=args.device)
    es = exp.init(seed=args.seed)
    where = (torch.cuda.get_device_name(exp.device) if exp.device.type == "cuda"
             else str(exp.device))
    print(f"[demo] backend={args.backend} states={cfg.states} steps={args.steps} "
          f"(chunks of {args.chunk}) on {where}")
    done, timed_steps, timed_s = 0, 0, 0.0
    while done < args.steps:
        n = min(args.chunk, args.steps - done)
        t0 = time.perf_counter()
        es, infos = exp.run_chunk(es, n)
        loss = float(infos["loss"][-1])  # waits for the chunk
        erg = float(infos["ergodic_cost"][-1])
        dt = time.perf_counter() - t0
        if done:  # the first chunk is warm-up
            timed_steps, timed_s = timed_steps + n, timed_s + dt
        done += n
        print(f"[demo] step {done:4d}  loss {loss:+8.3f}  ergodic {erg:6.3f}  "
              f"({n / dt:5.1f} Hz)")
    rate = timed_steps / timed_s if timed_s > 0 else None
    if rate is not None:
        print(f"[demo] steady-state: {rate:.1f} explore+learn steps/s "
              f"(reference hardware loop: 5 Hz)")
    print("[demo] done. Next: python -m ealv_tpu_torch.scripts.run_experiment (full CLI), "
          "python -m ealv_tpu_torch.scripts.run_fingerprint_matrix (fingerprint pipeline).")
    return es, rate


if __name__ == "__main__":
    main()
