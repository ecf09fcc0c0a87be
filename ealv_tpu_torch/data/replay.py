"""Replay and trajectory rings on the device (port of
``ealv_tpu/data/replay.py``).

The rings are preallocated tensors updated in place: a functional update
would copy the whole image ring (583 MB at production size in bf16) on
every push. The replay ring's head and fill counters are host ints, since
every push lands unconditionally; the hyperparameter ring and the
trajectory ring are advanced under data-dependent guards (non-finite
values, NaN measurements) and so keep their counters as device tensors,
updated with ``torch.where`` and no host sync. Draws without replacement
use the Gumbel top-k trick with an explicit ``torch.Generator``; its bits
differ from JAX's, the law is the same.
"""

from __future__ import annotations

import dataclasses

import torch


def _gumbel(n, generator, device):
    u = torch.rand(n, generator=generator, device=device)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


@dataclasses.dataclass
class ReplayBuffer:
    x: torch.Tensor  # (cap, s_dim)
    y: torch.Tensor  # (cap, H, W, C)
    force: torch.Tensor  # (cap, 1)
    y_var: torch.Tensor  # (cap,) per-sample image variance
    beta: torch.Tensor  # (beta_cap,) hyperparam ring ("grade")
    gamma: torch.Tensor  # (beta_cap,) ("spread")
    beta_pos: torch.Tensor  # () int64
    beta_size: torch.Tensor  # () int64
    explr_ind: torch.Tensor  # () int64
    pos: int = 0  # ring head
    size: int = 0  # valid rows
    total: int = 0  # total pushes

    @classmethod
    def create(cls, capacity: int, s_dim: int, img_dim, device,
               beta_capacity: int = 25, img_dtype=torch.float32):
        """``img_dtype=torch.bfloat16`` halves the image ring; poses,
        forces and weights stay f32."""
        h, w, c = img_dim
        zero = lambda: torch.zeros((), dtype=torch.int64, device=device)
        return cls(
            x=torch.zeros((capacity, s_dim), device=device),
            y=torch.zeros((capacity, h, w, c), dtype=img_dtype, device=device),
            force=torch.zeros((capacity, 1), device=device),
            y_var=torch.zeros(capacity, device=device),
            beta=torch.zeros(beta_capacity, device=device),
            gamma=torch.zeros(beta_capacity, device=device),
            beta_pos=zero(), beta_size=zero(), explr_ind=zero(),
        )

    @property
    def capacity(self) -> int:
        return self.x.shape[0]

    def push(self, x, y, force=None) -> "ReplayBuffer":
        """Write one sample at the head, in place."""
        i = self.pos
        self.x[i] = x
        self.y[i] = y.to(self.y.dtype)
        self.force[i] = force if force is not None else 0.0
        self.y_var[i] = y.float().var(correction=0)
        self.pos = (i + 1) % self.capacity
        self.size = min(self.size + 1, self.capacity)
        self.total += 1
        return self

    def update_hyperparams(self, explr_ind: int, grade, spread) -> "ReplayBuffer":
        """Push (grade -> beta, spread -> gamma); non-finite pushes are
        dropped."""
        ok = torch.isfinite(grade) & torch.isfinite(spread)
        cap = self.beta.shape[0]
        slot = ok & (torch.arange(cap, device=self.beta.device) == self.beta_pos)
        self.beta = torch.where(slot, grade, self.beta)
        self.gamma = torch.where(slot, spread, self.gamma)
        self.beta_pos = torch.where(ok, (self.beta_pos + 1) % cap, self.beta_pos)
        self.beta_size = torch.where(ok, (self.beta_size + 1).clamp(max=cap),
                                     self.beta_size)
        self.explr_ind = torch.where(ok, torch.full_like(self.explr_ind, explr_ind),
                                     self.explr_ind)
        return self

    def valid_mask(self):
        return (torch.arange(self.capacity, device=self.x.device) < self.size).float()

    def _weights(self, weighted: bool):
        """Sampling weights over slots, zero on invalid ones. Weighted mode
        is the recency ramp clamp(rank, min=n/2) over push order, with each
        slot's rank taken from its age relative to the ring head, so it
        holds after a wrap."""
        cap = self.capacity
        slots = torch.arange(cap, device=self.x.device)
        n = float(self.size)
        age = ((self.pos - 1 - slots) % cap).float()
        rank = n - 1.0 - age  # 0 = oldest valid push, n-1 = newest
        valid = rank >= 0.0
        w = rank.clamp(min=n / 2.0) if weighted else torch.ones_like(rank)
        return torch.where(valid, w, torch.zeros_like(w))

    def _weights_log(self, weighted: bool):
        w = self._weights(weighted)
        return torch.log(w.clamp(min=1e-30)) + torch.where(w > 0, 0.0, -1e30)

    def sample_indices(self, batch_size: int, weighted: bool = False,
                       generator: torch.Generator | None = None):
        """Without-replacement weighted draw (Gumbel top-k). A batch larger
        than the fill repeats the valid draws."""
        logw = self._weights_log(weighted)
        g = _gumbel(self.capacity, generator, self.x.device)
        idx = torch.topk(logw + g, batch_size).indices
        return idx[torch.arange(batch_size, device=idx.device) % max(self.size, 1)]

    def get_all_x(self):
        """(x (cap, s_dim), validity mask (cap,))."""
        return self.x, self.valid_mask()


@dataclasses.dataclass
class TrajMemory:
    """Visited-state ring of the planner's trajectory history."""

    buf: torch.Tensor  # (cap, n)
    pos: torch.Tensor  # () int64
    size: torch.Tensor  # () int64

    @classmethod
    def create(cls, capacity: int, state_dim: int, device):
        zero = lambda: torch.zeros((), dtype=torch.int64, device=device)
        return cls(buf=torch.zeros((capacity, state_dim), device=device),
                   pos=zero(), size=zero())

    @property
    def capacity(self) -> int:
        return self.buf.shape[0]

    def push(self, state, skip=None) -> "TrajMemory":
        """Write ``state`` at the head, unless the () bool ``skip`` holds."""
        cap = self.capacity
        write = torch.arange(cap, device=self.buf.device) == self.pos
        step = torch.ones_like(self.pos)
        if skip is not None:
            write = write & ~skip
            step = (~skip).long()
        self.buf = torch.where(write[:, None], state[None, :], self.buf)
        self.pos = (self.pos + step) % cap
        self.size = (self.size + step).clamp(max=cap)
        return self

    def sample_indices(self, batch_size: int,
                       generator: torch.Generator | None = None):
        """Uniform without-replacement draw over the valid rows (Gumbel
        top-k); draws past the fill land on invalid rows."""
        cap = self.capacity
        valid = torch.arange(cap, device=self.buf.device) < self.size
        logw = torch.where(valid, 0.0, -1e30)
        g = _gumbel(cap, generator, self.buf.device)
        return torch.topk(logw + g, batch_size).indices

    def sample(self, batch_size: int, generator: torch.Generator | None = None,
               idx=None):
        """(states (batch, n), mask (batch,)): the mask marks the first
        min(batch, fill) draws, the distinct valid ones. ``idx`` feeds the
        draw instead of taking it from ``generator``."""
        if idx is None:
            idx = self.sample_indices(batch_size, generator)
        mask = (torch.arange(batch_size, device=self.buf.device) < self.size).float()
        return self.buf[idx], mask

    def get_recent(self, k: int):
        """The last k pushed states, newest first, as a fixed-shape (k, n)
        plus a mask of the rows that were pushed."""
        ks = torch.arange(k, device=self.buf.device)
        return self.buf[(self.pos - 1 - ks) % self.capacity], (ks < self.size).float()

    def get_all(self):
        return self.buf, (torch.arange(self.capacity, device=self.buf.device)
                          < self.size).float()
