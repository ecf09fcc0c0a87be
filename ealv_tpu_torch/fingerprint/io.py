"""Fingerprint and belief files (port of ``ealv_tpu/fingerprint/io.py``).

A capture is an npz of {z_mu, z_var, x, center, center_img}; a belief
snapshot an npz of grids, priors, prior_vars, lims, counts and names.
Reference ``.pickle`` captures load through an unpickler that admits numpy
array reconstruction and nothing else, so a hostile pickle cannot run code
here. Numpy-only but for ``load_beliefs``, which rebuilds the port's
beliefs on a given device.
"""

from __future__ import annotations

import dataclasses
import io as _io
import os
import pickle
import warnings

import numpy as np

_FP_KEYS = ("z_mu", "z_var", "x", "center", "center_img")


class _NumpyOnlyUnpickler(pickle.Unpickler):
    """Numpy arrays, scalars and dtypes; every other global is refused."""

    _ALLOWED = {
        ("numpy.core.multiarray", "_reconstruct"),
        ("numpy._core.multiarray", "_reconstruct"),
        ("numpy.core.multiarray", "scalar"),
        ("numpy._core.multiarray", "scalar"),
        ("numpy", "ndarray"),
        ("numpy", "dtype"),
        ("numpy.dtypes", "Float32DType"),
        ("numpy.dtypes", "Float64DType"),
        ("numpy.dtypes", "Int64DType"),
        ("numpy.dtypes", "Int32DType"),
        ("numpy.dtypes", "UInt8DType"),
        ("numpy.dtypes", "BoolDType"),
    }

    def find_class(self, module, name):
        if (module, name) in self._ALLOWED:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"refusing to unpickle {module}.{name}: fingerprint pickles may "
            f"only contain numpy arrays (restricted loader)")


def _safe_pickle_load(path):
    with open(path, "rb") as f:
        return _NumpyOnlyUnpickler(_io.BytesIO(f.read())).load()


def save_fingerprint(path: str, fp: dict) -> str:
    """Write one capture; appends .npz if missing. Returns the path."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **{k: np.asarray(fp[k]) for k in _FP_KEYS})
    return path


def load_fingerprints(paths):
    """Captures -> list of dicts (``FingerprintSet.from_lists``' input),
    from a directory (every *.npz and *.pickle in it) or a list of paths.
    In a directory, pickles that are not captures are skipped with a
    warning; a listed one raises."""
    directory_mode = isinstance(paths, (str, os.PathLike))
    if directory_mode:
        d = str(paths)
        paths = sorted(os.path.join(d, f) for f in os.listdir(d)
                       if f.endswith((".npz", ".pickle")))
    out = []
    for p in paths:
        if str(p).endswith(".pickle"):
            try:
                out.append(_load_reference_pickle(p))
            except (KeyError, ValueError, pickle.UnpicklingError) as e:
                if not directory_mode:
                    raise
                warnings.warn(f"skipping {p}: not a fingerprint capture pickle ({e})",
                              stacklevel=2)
        else:
            data = np.load(p)
            out.append({k: data[k] for k in _FP_KEYS})
    return out


def _load_reference_pickle(path):
    """One reference capture pickle in this package's convention: its
    ``z_var`` is the variance, stored here as the logvar; a channel-first
    ``center_img`` becomes (H, W, C)."""
    d = _safe_pickle_load(path)
    if not isinstance(d, dict) or not all(k in d for k in _FP_KEYS):
        missing = _FP_KEYS if not isinstance(d, dict) else [k for k in _FP_KEYS if k not in d]
        raise KeyError(f"missing fingerprint keys {missing}")
    d = {k: np.asarray(v, np.float32) for k, v in d.items() if not isinstance(v, (str, bytes))}
    img = d["center_img"]
    if img.ndim == 3 and img.shape[0] in (1, 3) and img.shape[-1] not in (1, 3):
        img = img.transpose(1, 2, 0)
    out = {"z_mu": d["z_mu"], "z_var": np.log(np.clip(d["z_var"], 1e-12, None)),
           "x": d["x"], "center": d["center"], "center_img": img}
    if "force" in d:
        out["force"] = d["force"]
    return out


def save_beliefs(path: str, beliefs, names=None) -> str:
    """Snapshot belief grids: grids (K, G, d), priors (K, G), prior_vars
    (K, G), lims (K, d, 2), counts (K,), names (K,). Appends .npz if
    missing. Returns the path."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    host = lambda name: np.stack([getattr(b, name).detach().cpu().numpy() for b in beliefs])
    np.savez_compressed(
        path, grids=host("grid"), priors=host("prior"), prior_vars=host("prior_var"),
        lims=host("lims"), counts=np.asarray([int(b.count) for b in beliefs]),
        names=np.asarray(names if names is not None
                         else [f"fp{i}" for i in range(len(beliefs))]))
    return path


def load_beliefs(path: str, explr_states: str, device="cuda", **belief_kwargs):
    """Beliefs from a snapshot, on ``device``: each is rebuilt at the
    snapshot's grid resolution, then takes its grid, limits, prior, prior
    variance and count. Returns (beliefs, names)."""
    import torch
    from .belief import FingerprintBelief

    data = np.load(path, allow_pickle=False)
    grids = data["grids"]
    ns = round(grids.shape[1] ** (1.0 / grids.shape[2]))
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    out = []
    for k in range(grids.shape[0]):
        b = FingerprintBelief.create(explr_states, _unexpand_lims(explr_states, data["lims"][k]),
                                     num_samples=ns, device=device, **belief_kwargs)
        out.append(dataclasses.replace(
            b, grid=t(grids[k]), lims=t(data["lims"][k]), prior=t(data["priors"][k]),
            prior_var=t(data["prior_vars"][k]),
            count=torch.tensor(int(data["counts"][k]), dtype=torch.int64, device=device)))
    return out, [str(n) for n in data["names"]]


def _unexpand_lims(explr_states: str, lims):
    """Invert ``FingerprintBelief.create``'s widening (x1.15, yaw x1.33)."""
    lims = np.asarray(lims, np.float64) / 1.15
    if "w" in explr_states:
        lims[explr_states.rfind("w")] /= 1.33
    return lims
