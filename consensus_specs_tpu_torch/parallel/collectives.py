"""A single-controller device mesh and its three collectives
(counterpart of the `lax.psum`, `lax.psum_scatter`, `lax.all_gather` and
`lax.axis_index` that the JAX package's `shard_map` bodies call, and of
`utils/jaxtools.py:93 shard_map_compat`).

One process drives every shard, as one JAX process drives a `Mesh` over
`jax.devices()`: a `Mesh` is a tuple of `torch.device`s, shard d's
tensors live on `mesh.devices[d]`, the caller launches each shard's
kernels on its own device (`on(device)`), and a collective takes the
list of per-shard tensors and returns a list of new ones.  A virtual mesh
lists one device several times (`cuda:0` four times on a one-card
machine, `cpu` in the tests), as the JAX tests force 8 host devices.

The collectives move data and add integers; they are not ports of a TPU
kernel.  They are peer copies (`Tensor.to`) and torch adds, exact on the
int64 bit patterns of uint64 values: wrapping addition gives the bits of
JAX's uint64 `psum`.  Every output is a new tensor, never a view of an
input or of another output, so a virtual mesh, whose shards share one
device, can hand the results to kernels that write in place.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

DATA_AXIS = "data"


class Mesh(NamedTuple):
    """A one-axis device mesh: shard d runs on `devices[d]`."""

    devices: tuple
    axis: str = DATA_AXIS

    @property
    def size(self) -> int:
        return len(self.devices)


def on(device):
    """Context in which launches go to `device` (its CUDA context; nothing
    for the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _check(parts) -> None:
    if not parts:
        raise ValueError("a collective needs at least one shard")
    shape, dtype = parts[0].shape, parts[0].dtype
    for p in parts:
        if p.shape != shape or p.dtype != dtype:
            raise ValueError(f"shards differ: {tuple(p.shape)} {p.dtype} vs "
                             f"{tuple(shape)} {dtype}")


def gather(parts, device) -> torch.Tensor:
    """The D shards stacked, (D, ...), on `device`."""
    _check(parts)
    with on(device):
        return torch.stack([p.to(device) for p in parts])


def all_gather(parts) -> list:
    """`lax.all_gather`: shard d receives the (D, ...) stack of every
    shard, on its own device; D separate copies."""
    return [gather(parts, p.device) for p in parts]


def _sum_on(parts, device, lo=None, hi=None) -> torch.Tensor:
    with on(device):
        acc = torch.zeros_like(parts[0][lo:hi], device=device)
        for p in parts:
            acc += p[lo:hi].to(device)
        return acc


def all_reduce_sum(parts) -> list:
    """`lax.psum`: shard d receives the elementwise sum of every shard."""
    _check(parts)
    return [_sum_on(parts, p.device) for p in parts]


def reduce_scatter_sum(parts) -> list:
    """`lax.psum_scatter(..., scatter_dimension=0, tiled=True)`: every
    shard holds D * n rows; shard d receives the sum over shards of rows
    [d n, (d + 1) n)."""
    _check(parts)
    d_count = len(parts)
    rows = parts[0].shape[0]
    if rows % d_count:
        raise ValueError(f"{rows} rows do not split over {d_count} shards")
    n = rows // d_count
    return [_sum_on(parts, p.device, d * n, (d + 1) * n)
            for d, p in enumerate(parts)]
