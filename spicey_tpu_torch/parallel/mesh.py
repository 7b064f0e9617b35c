"""Device-mesh sharding for batched sweeps.

Contract: spicey_tpu/parallel/mesh.py. The meaningful multi-device axes of
a circuit simulator are the embarrassingly parallel ones: the Monte-Carlo
``batch`` and the AC ``freq`` grid. Sharding is a placement concern, not a
code-path concern: each device's piece runs the route and the kernels
that an unsharded call would run on that piece.

Torch has no GSPMD and no shard_map, so the port shards in one process.
``sharder(mesh)`` returns ``put(t, axes)``, which cuts a tensor into
contiguous pieces along the named axes and moves each piece to its
device. An entry point given ``device_put=put`` (``mc_ac_stats``,
``mc_tran_stats``, ``simulate_ac_batch``, ``simulate_tran_batch``) runs
its route once per block of the mesh (``map_blocks``), gathers the
per-variant outputs onto the mesh's first device and reduces there once,
so a quantile sees exactly the batch an unsharded call sees.

Order of work: the blocks run device after device from one
thread. The Newton loops read the host every pass, so blocks on different
cards run one after the other, not at once; a thread or stream per device
is not implemented.

Typical use:
    mesh = make_mesh()                        # every CUDA device on 'batch'
    res = simulate_ac_batch(net, overrides, device_put=sharder(mesh))
or a 2D layout for AC sweeps:
    mesh = make_mesh(axes={"batch": 4, "freq": 2})
A mesh may repeat a device (``make_mesh({"batch": 8}, devices=["cpu"] *
8)``); its blocks then run on that device in turn.
"""

from __future__ import annotations

import dataclasses
import itertools
from collections.abc import Callable, Iterable

import numpy as np
import torch

# a ``map_blocks`` spec: every tensor of the tree with two or more
# dimensions that leads with the variants is split on the "batch" axis
VARIANTS = "variants"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A named grid of devices: ``devices`` is an object ndarray of
    ``torch.device`` shaped by the axes, ``axis_names`` names them."""

    devices: np.ndarray
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape`` reads."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def first(self) -> torch.device:
        """The device the results gather on."""
        return self.devices.flat[0]


def as_device(device: torch.device | str) -> torch.device:
    """``device`` as a ``torch.device``, a CUDA device without an index
    taking the current one (so two names of one card compare equal)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(axes: dict[str, int] | None = None,
              devices: Iterable | None = None) -> Mesh:
    """Build a Mesh. Default: 1D ('batch',) over every CUDA device,
    ``cuda:0`` .. ``cuda:{n-1}``; with no card it raises ``RuntimeError``
    rather than falling back to the CPU. ``devices`` (``torch.device`` or
    names) may repeat a device."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() spans the CUDA devices by default and none is "
                "available; pass devices=['cpu'] * n for a CPU mesh")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [as_device(d) for d in np.asarray(devices, dtype=object).ravel()]
    if axes is None:
        axes = {"batch": len(devs)}
    shape = tuple(axes.values())
    if int(np.prod(shape)) != len(devs):
        raise ValueError(
            f"mesh axes {axes} need {int(np.prod(shape))} devices, "
            f"got {len(devs)}"
        )
    grid = np.empty(len(devs), dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(shape), tuple(axes.keys()))


def sharder(mesh: Mesh) -> Callable:
    """Return a device_put callable for the batch APIs.

    ``put(t, axes)`` returns ``t``'s per-device pieces: an object ndarray
    shaped like ``mesh.devices`` whose entry at each position is the piece
    that device holds, moved there. ``axes`` entries name mesh axes or are
    None; along a named axis ``t`` is cut into as many contiguous
    ``torch.tensor_split`` pieces as the axis has devices (uneven, or
    empty, where the size does not divide), along the others it is
    replicated. Axes not present in the mesh degrade to replication, so
    the same call sites work on 1D and 2D meshes. ``put.mesh`` is the mesh
    itself, which the entry points need.
    """
    def put(t: torch.Tensor, axes: tuple) -> np.ndarray:
        cuts = [(dim, mesh.axis_names.index(a))
                for dim, a in enumerate(axes) if a in mesh.axis_names]
        out = np.empty(mesh.devices.shape, dtype=object)
        for pos in np.ndindex(*mesh.devices.shape):
            piece = t
            for dim, k in cuts:
                piece = torch.tensor_split(piece, mesh.devices.shape[k],
                                           dim=dim)[pos[k]]
            out[pos] = piece.to(mesh.devices[pos])
        return out

    put.mesh = mesh
    return put


def mesh_of(device_put: Callable) -> Mesh:
    """The Mesh behind a ``sharder(mesh)`` callable."""
    mesh = getattr(device_put, "mesh", None)
    if not isinstance(mesh, Mesh):
        raise TypeError("device_put must be a spicey_tpu_torch sharder(mesh)"
                        " callable")
    return mesh


@dataclasses.dataclass
class _Pieces:
    """A split tensor: ``put``'s pieces and the mesh axis that cuts each
    tensor dimension (``dims``: dimension -> axis)."""

    pieces: np.ndarray
    dims: dict[int, str]


def _split(device_put: Callable, tree: object, spec: object,
           n_variants: int) -> object:
    """``tree`` with every tensor that ``spec`` splits replaced by its
    pieces (see ``map_blocks``)."""
    names = mesh_of(device_put).axis_names
    if isinstance(spec, tuple):
        return _Pieces(device_put(tree, spec),
                       {d: a for d, a in enumerate(spec) if a in names})
    if spec != VARIANTS:
        return tree
    if isinstance(tree, dict):
        return {k: (v if k.endswith(("idx", "pairs"))
                    else _split(device_put, v, spec, n_variants))
                for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.ndim >= 2 \
            and tree.shape[0] == n_variants:
        return _split(device_put, tree,
                      ("batch",) + (None,) * (tree.ndim - 1), n_variants)
    return tree


def _at(tree: object, pos: tuple, device: torch.device) -> object:
    """The block at mesh position ``pos`` of a split tree: each split
    tensor's piece there, every other tensor (and the tensors of a
    dataclass, such as a packed stamp pattern) moved to ``device``."""
    if isinstance(tree, _Pieces):
        return tree.pieces[pos]
    if isinstance(tree, dict):
        return {k: _at(v, pos, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: getattr(tree, f.name).to(device)
            for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name), torch.Tensor)})
    return tree


def _leaves(tree: object):
    if isinstance(tree, _Pieces):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)


def _cat(parts: list[torch.Tensor], dim: int) -> torch.Tensor:
    """``torch.cat`` that keeps the parts' memory layout (transposed views
    gather into a transposed tensor), so that a reduction over the result
    reads it in the order it reads one unsplit output."""
    ref = max(parts, key=torch.Tensor.numel)
    perm = sorted(range(ref.ndim), key=lambda d: -ref.stride(d))
    out = torch.cat([p.permute(perm) for p in parts], dim=perm.index(dim))
    return out.permute([perm.index(d) for d in range(ref.ndim)])


def map_blocks(device_put: Callable | None, fn: Callable, args: dict,
               specs: dict, out_axes: tuple[dict[str, int], ...],
               n_variants: int) -> tuple[torch.Tensor, ...]:
    """Run ``fn(**block)`` once per block of the mesh behind
    ``device_put`` and gather its outputs on the mesh's first device
    (with no ``device_put``: ``fn(**args)``, unsplit).

    ``specs`` maps keys of ``args`` to how each is placed: a tuple of mesh
    axes (the tensor is split as ``device_put`` splits it), ``VARIANTS``
    (a tensor or dict tree whose tensors of two or more dimensions leading
    with the ``n_variants`` variants split on "batch"; index tables, keys
    ending in "idx" or "pairs", and the rest move whole), or None / absent
    (moved whole to each block's device). There is one block per
    combination of coordinates on the mesh axes that split something, at
    coordinate 0 on every other axis (the pieces there are replicas and
    would compute the same block again). A block whose piece is empty on a
    split axis is skipped and launches nothing (if every block is empty,
    the first runs, as an unsharded call on no variants would). ``fn``
    returns a tuple of tensors; ``out_axes[k]`` maps each splitting axis
    to the dimension of output k it tiles, and the pieces concatenate in
    mesh order, in the memory layout the block outputs have.
    """
    if device_put is None:
        return fn(**args)
    mesh = mesh_of(device_put)
    split = {k: _split(device_put, v, specs.get(k), n_variants)
             for k, v in args.items()}
    leaves = list(_leaves(split))
    used = [a for a in mesh.axis_names
            if any(a in p.dims.values() for p in leaves)]
    ranges = [range(mesh.shape[a]) if a in used else range(1)
              for a in mesh.axis_names]
    blocks = list(itertools.product(*ranges))
    live = [pos for pos in blocks
            if all(p.pieces[pos].shape[d] > 0
                   for p in leaves for d in p.dims)] or blocks[:1]
    outs = {pos: fn(**_at(split, pos, mesh.devices[pos])) for pos in live}
    first = mesh.first
    ks = [mesh.axis_names.index(a) for a in used]

    def gather(entries: list, level: int, i: int) -> torch.Tensor:
        if level == len(used):
            return entries[0][1][i].to(first)
        k = ks[level]
        parts = [gather(list(g), level + 1, i)
                 for _, g in itertools.groupby(entries,
                                               key=lambda e: e[0][k])]
        return parts[0] if len(parts) == 1 else _cat(
            parts, out_axes[i][used[level]])

    entries = list(outs.items())  # in mesh order, as product made them
    return tuple(gather(entries, 0, i) for i in range(len(out_axes)))
