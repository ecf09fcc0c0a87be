"""Replay and trajectory rings on the device (port of
``ealv_tpu/data/replay.py``).

The rings are preallocated tensors updated in place: a functional update
would copy the whole image ring (583 MB at production size in bf16) on
every push. Every counter (the replay ring's head, fill and push count, the
hyperparameter ring's, the trajectory ring's) is a () int64 tensor on the
ring's device, as in the JAX package: a push writes its row at the device
index and advances the counters in place (the hyperparameter ring's rows
and counters too), so no call reads a value back and
a captured CUDA graph that reads the rings sees each replay's counters (a
host int would be frozen into the graph). The hyperparameter ring and the
trajectory ring advance under data-dependent guards (non-finite values,
NaN measurements) with ``torch.where``. Host readers take ``int()`` of a
counter. Draws without replacement use the Gumbel top-k trick with an
explicit ``torch.Generator``; its bits differ from JAX's, the law is the
same.
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
    pos: torch.Tensor  # () int64 ring head
    size: torch.Tensor  # () int64 valid rows
    total: torch.Tensor  # () int64 total pushes

    @property
    def capacity(self) -> int:
        return self.x.shape[0]

    def push(self, x, y, force=None) -> "ReplayBuffer":
        """Write one sample at the head and advance the counters, in place."""
        i = self.pos.reshape(1)
        self.x.index_copy_(0, i, x.to(self.x.dtype).reshape(1, -1))
        self.y.index_copy_(0, i, y.to(self.y.dtype)[None])
        if force is None:
            self.force.index_fill_(0, i, 0.0)
        else:
            self.force.index_copy_(0, i, force.to(self.force.dtype).reshape(1, 1))
        self.y_var.index_copy_(0, i, y.float().var(correction=0).reshape(1))
        self.pos.copy_((self.pos + 1) % self.capacity)
        self.size.copy_((self.size + 1).clamp(max=self.capacity))
        self.total.add_(1)
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
        n = self.size.float()
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
        return idx[torch.arange(batch_size, device=idx.device) % self.size.clamp(min=1)]

    def get_all_x(self):
        """(x (cap, s_dim), validity mask (cap,))."""
        return self.x, self.valid_mask()


@dataclasses.dataclass
class TrajMemory:
    """Visited-state ring of the planner's trajectory history."""

    buf: torch.Tensor  # (cap, n)
    pos: torch.Tensor  # () int64
    size: torch.Tensor  # () int64

    @property
    def capacity(self) -> int:
        return self.buf.shape[0]

    def push(self, state, skip=None) -> "TrajMemory":
        """Write ``state`` at the head, unless the () bool ``skip`` holds;
        the row and the counters are written in place."""
        cap = self.capacity
        i = self.pos.reshape(1)
        row = state.to(self.buf.dtype)[None, :]
        step = torch.ones_like(self.pos)
        if skip is not None:
            row = torch.where(skip, self.buf.index_select(0, i), row)
            step = (~skip).long()
        self.buf.index_copy_(0, i, row)
        self.pos.copy_((self.pos + step) % cap)
        self.size.copy_((self.size + step).clamp(max=cap))
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
