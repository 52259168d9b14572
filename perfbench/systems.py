"""Helpers the path modules share: the program's EngineConfig from a
configuration file, copies of a state, and outputs moved to the host."""

from __future__ import annotations

import dataclasses

import torch


def engine_config(cfg: dict, groups: tuple):
    """The program's EngineConfig: its defaults with each of `groups` of the
    configuration file replaced field by field; a field the program lacks
    raises."""
    from evflow_tpu_torch import DEFAULT
    out = {}
    for g in groups:
        base = getattr(DEFAULT, g)
        unknown = set(cfg[g]) - {f.name for f in dataclasses.fields(base)}
        if unknown:
            raise KeyError(f"the program's {g} config has no {sorted(unknown)}")
        out[g] = dataclasses.replace(base, **cfg[g])
    return DEFAULT.replace(**out)


def clone(tree):
    """A copy of a state: tensors, tuples and NamedTuples of them."""
    if isinstance(tree, tuple):
        items = [clone(t) for t in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree.clone()


def to_host(leaves: dict) -> dict:
    """Device tensors -> NumPy: each copied without a wait, then one wait."""
    out = {k: v.to("cpu", non_blocking=True) for k, v in leaves.items()}
    dev = next(iter(leaves.values())).device
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()
    return {k: v.numpy() for k, v in out.items()}
