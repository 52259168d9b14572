"""Checkpoint/resume for long event streams (counterpart of
evflow_tpu/utils/checkpoint.py).

The engine's recurrent states (cluster sets, tracker tracks, SAE surface)
are NamedTuples of tensors. `save_npz` writes their leaves in
jax.tree_util order (`interop.to_leaves`) as `leaf_{i}`, beside `meta_{k}`
scalars, the JAX package's npz format key for key: a checkpoint saved by
either package restores in the other, which is how a stream's state is
handed between them mid-stream. `save_torch` / `restore_torch` hold the
same leaves in a `torch.save` file, read back with `weights_only=True`.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..interop import from_leaves, to_leaves


def save_npz(path: str, state: Any, meta: dict | None = None) -> None:
    arrays = {f"leaf_{i}": leaf for i, leaf in enumerate(to_leaves(state))}
    for k, v in (meta or {}).items():
        arrays[f"meta_{k}"] = np.asarray(v)
    np.savez_compressed(path, **arrays)


def load_meta(path: str) -> dict:
    """The meta_* scalars stored alongside a save_npz checkpoint (e.g. the
    stream's t0 time rebase for the corner pipeline's SAE)."""
    with np.load(path) as z:
        return {k[len("meta_"):]: z[k] for k in z.files if k.startswith("meta_")}


def _restore(leaves, template: Any) -> Any:
    """`template` with its leaves replaced by `leaves`, each checked for
    shape and cast to the template leaf's dtype, on the template's device."""
    out = []
    for i, (a, t) in enumerate(zip(leaves, to_leaves(template))):
        a = np.asarray(a)
        assert a.shape == t.shape, \
            f"leaf {i}: checkpoint shape {a.shape} != template {t.shape}"
        out.append(a.astype(t.dtype))
    return from_leaves(template, out)


def restore_npz(path: str, template: Any) -> Any:
    with np.load(path) as z:
        n = len(to_leaves(template))
        return _restore([z[f"leaf_{i}"] for i in range(n)], template)


def save_torch(path: str, state: Any) -> None:
    torch.save([torch.from_numpy(np.array(leaf)) for leaf in to_leaves(state)], path)


def restore_torch(path: str, template: Any) -> Any:
    leaves = torch.load(path, map_location="cpu", weights_only=True)
    return _restore([t.numpy() for t in leaves], template)
