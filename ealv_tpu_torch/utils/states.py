"""State-string helpers and workspace conversion (port of
``ealv_tpu/utils/states.py``)."""

from __future__ import annotations

import torch


def ws_conversion(pt, in_lim, out_lim):
    """Affine map between workspace boxes (e.g. metric "tray" coords and
    normalized [-1, 1] "robot" coords). ``pt`` is one point (d,) or a batch
    (N, d); trailing dims beyond ``len(in_lim)`` are dropped. Limits are
    (n, 2) tensors on the point's device."""
    if in_lim.ndim == 1:
        in_lim = in_lim[None, :]
    if out_lim.ndim == 1:
        out_lim = out_lim[None, :]
    ilim = in_lim[:, 1] - in_lim[:, 0]
    olim = out_lim[:, 1] - out_lim[:, 0]
    pts = pt[..., : ilim.shape[0]]
    return (pts - in_lim[:, 0]) / ilim * olim + out_lim[:, 0]


def is_vel_state(ch: str) -> bool:
    """Upper-case state characters denote velocities."""
    return ch == ch.upper() and ch != ch.lower()


def find_non_vel_locs(states: str):
    """(non_vel_locs, vel_locs, non_vel_states) of a state string."""
    non_vel_locs = [i for i, s in enumerate(states) if s == s.lower()]
    vel_locs = [i for i, s in enumerate(states) if s == s.upper()]
    non_vel_states = "".join(states[i] for i in non_vel_locs)
    return non_vel_locs, vel_locs, non_vel_states


def state_indices(states: str, query: str):
    """Index of each character of ``query`` inside ``states`` (rfind)."""
    return [states.rfind(s) for s in query]


def expand_states_double_integrator(states: str) -> str:
    """Double-integrator state string: positions then matching velocities."""
    return states.lower() + states.upper()
