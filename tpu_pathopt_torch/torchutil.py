"""Small PyTorch helpers shared by the port (counterpart of ``jaxutil``)."""

from __future__ import annotations

import contextlib
import dataclasses

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. With no GPU present a CUDA request raises; nothing falls
    back to the CPU silently."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return device


def tree_map(fn, obj):
    """Apply ``fn`` to every tensor inside nested dataclasses / tuples /
    lists (the pytree ``tree_map`` of the JAX package, for this port's
    dataclasses). Non-tensor leaves are kept as they are."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: tree_map(fn, getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, (tuple, list)):
        return type(obj)(tree_map(fn, o) for o in obj)
    return obj


def tree_leaves(obj) -> list:
    """Every tensor inside ``obj``, in :func:`tree_map`'s order."""
    out = []
    tree_map(out.append, obj)
    return out


def to_device(obj, device):
    """Move every tensor of ``obj`` to ``device`` (no copy where it lies)."""
    return tree_map(lambda t: t.to(device), obj)


def take(arr, idx):
    """``jnp.take(arr, idx)`` along the last axis for one index per row:
    arr (..., n), idx (...) -> (...). Negative indices wrap as in JAX; an
    index is never out of range on the device."""
    n = arr.shape[-1]
    i = torch.remainder(idx.long(), n).clamp(max=n - 1)
    return torch.gather(arr, -1, i.unsqueeze(-1)).squeeze(-1)


@contextlib.contextmanager
def highest_precision():
    """Full float32 products (no TF32) inside the block, the previous
    setting restored after it: the counterpart of JAX's
    ``default_matmul_precision("highest")``."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)
