"""A tensor's copy to host memory that the caller reads later."""

from __future__ import annotations

import numpy as np
import torch


class HostCopy:
    """A tensor's copy to host memory, started without waiting: on the card
    a non-blocking copy into pinned memory and an event recorded after it;
    ``numpy()`` waits for the event, never for the rest of the stream."""

    def __init__(self, t: torch.Tensor):
        t = t.detach()
        self._event = None
        if t.is_cuda:
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = t

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()
