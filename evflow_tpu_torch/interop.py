"""Carry state between the JAX package and the port.

The port's state NamedTuples mirror the JAX package's field for field and
dtype for dtype, so a state's leaves, taken in field order with nested
NamedTuples flattened in place (the order of jax.tree_util), are the same
list in both packages. This system has no weights; its state is what is
carried across: run k slices in JAX, hand the state over, continue here —
or back.

No JAX is imported: a JAX state's leaves are read through np.asarray.
"""

from __future__ import annotations

from typing import Iterable, List

import numpy as np
import torch


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def to_leaves(state) -> List[np.ndarray]:
    """The leaves of a state of either package as numpy arrays, in
    jax.tree_util order."""
    if _is_namedtuple(state) or isinstance(state, (tuple, list)):
        return [leaf for node in state for leaf in to_leaves(node)]
    if isinstance(state, torch.Tensor):
        return [state.detach().cpu().numpy()]
    return [np.asarray(state)]


def from_leaves(template, leaves: Iterable, device=None):
    """A port state shaped like `template` (e.g. a fresh `init_state`) with
    its leaves replaced, in order, by `leaves` (numpy arrays or anything
    np.asarray takes), on `device` (the template's by default). Each leaf
    must match the template's shape and dtype."""
    it = iter(leaves)

    def build(node):
        if _is_namedtuple(node):
            return type(node)(*[build(f) for f in node])
        if isinstance(node, tuple):
            return tuple(build(f) for f in node)
        arr = np.asarray(next(it))
        t = torch.from_numpy(np.array(arr, copy=True))
        if t.dtype != node.dtype or tuple(t.shape) != tuple(node.shape):
            raise ValueError(f"leaf {t.dtype}{tuple(t.shape)} does not match "
                             f"{node.dtype}{tuple(node.shape)}")
        return t.to(node.device if device is None else device)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def from_jax(template, jax_state, device=None):
    """A JAX state (FastState, TrackState, CornerTrackState, or a tuple of
    them) as the port's state shaped like `template`."""
    return from_leaves(template, to_leaves(jax_state), device)


def named_leaves(tree, prefix: str = ""):
    """(dotted field path, numpy leaf) pairs of a state or output tree of
    either package, in jax.tree_util order."""
    if isinstance(tree, (tuple, list)):
        names = getattr(tree, "_fields", range(len(tree)))
        for name, node in zip(names, tree):
            yield from named_leaves(node, f"{prefix}.{name}")
    else:
        yield prefix, to_leaves(tree)[0]


def assert_trees_close(got, want, rtol: float, atol: float, what: str = "") -> None:
    """Leaf-by-leaf comparison of two trees of either package: the same
    structure, shapes and dtypes; bool and integer leaves equal; float
    leaves within rtol/atol."""
    got, want = list(named_leaves(got)), list(named_leaves(want))
    assert [n for n, _ in got] == [n for n, _ in want], (what, "structure differs")
    for (name, a), (_, b) in zip(got, want):
        where = f"{what}{name}"
        assert a.dtype == b.dtype and a.shape == b.shape, \
            (where, a.dtype, a.shape, b.dtype, b.shape)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=where)
        else:
            np.testing.assert_array_equal(a, b, err_msg=where)
