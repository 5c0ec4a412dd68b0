"""Device meshes, sharding and collectives for one controlling process.

Counterpart of `openfhe_tpu/parallel/__init__.py` (reference analog:
parallel.h's OpenFHEParallelControls and the OpenMP loops over RNS
towers). The JAX package runs one process that drives every device of a
`Mesh` through `shard_map`; the port keeps that model. A `Mesh` is a grid
of `torch.device`s with named axes ("dp" for batches of ciphertexts,
"limb" for RNS towers); a device may appear more than once, so a limb axis
of 4 on one card puts four shards on it. A sharded value is a list of
per-device blocks in mesh order (row-major over the axes). A collective is
a copy between devices plus `torch.cat` or a split:

  all_gather  every shard of a group gets the concatenation of the group's
              blocks (jax.lax.all_gather, tiled); shards on one device
              share one gathered tensor
  all_to_all  shard j gets block j of every shard's split, concatenated
              in shard order (jax.lax.all_to_all, tiled)
  broadcast   one shard's block on every device of the group (the owner's
              row that the JAX package spreads with a masked psum)

A body with collectives in the middle runs as stages: each stage loops
over a group's shards, each shard's kernels launch on its own device, and
the collective sits between stages.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

AXES = ("dp", "limb")


def cards() -> list:
    """The visible CUDA cards; raises when there is none."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("no CUDA device: build the Mesh from an explicit "
                           "device list (e.g. CPU devices) instead")
    return [torch.device("cuda", i) for i in range(n)]


class Mesh:
    """A grid of devices with named axes (jax.sharding.Mesh's role).

    `devices` is a nested list (or array) of devices or device names
    whose nesting depth is the number of axes."""

    def __init__(self, devices, axis_names=AXES):
        grid = np.array(devices, dtype=object)
        if grid.ndim != len(axis_names) or grid.size == 0:
            raise ValueError(f"devices of shape {grid.shape} do not fit "
                             f"axes {axis_names}")
        self.axis_names = tuple(axis_names)
        self.devices = np.empty(grid.shape, dtype=object)
        for idx in np.ndindex(grid.shape):
            self.devices[idx] = torch.device(grid[idx])
        self.shape = dict(zip(self.axis_names, grid.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def flat(self) -> list:
        """The devices in mesh order."""
        return list(self.devices.reshape(-1))

    def coords(self) -> list:
        """{axis: index} of every position, in mesh order."""
        return [dict(zip(self.axis_names, idx))
                for idx in np.ndindex(self.devices.shape)]

    def groups(self, axis: str = "limb") -> list:
        """The positions along `axis`, one list for each index of the
        other axes (the shards that one collective over `axis` joins)."""
        pos = np.moveaxis(np.arange(self.size).reshape(self.devices.shape),
                          self.axis_names.index(axis), -1)
        return [[int(p) for p in pos[idx]]
                for idx in np.ndindex(pos.shape[:-1])]

    def __repr__(self) -> str:
        rows = [[str(d) for d in row] for row in
                self.devices.reshape(-1, self.devices.shape[-1])]
        return f"Mesh({self.shape}, {rows})"


def make_mesh(limb: int = 1, dp: int = 1, devices=None) -> Mesh:
    """A (dp, limb) mesh over `devices` (default: the visible cards, which
    raises when there is none), assigned round-robin in mesh order, so a
    device repeats when there are fewer devices than positions."""
    devs = list(devices) if devices is not None else cards()
    flat = [devs[i % len(devs)] for i in range(dp * limb)]
    return Mesh([flat[d * limb:(d + 1) * limb] for d in range(dp)])


class ParallelControls:
    """Process-wide mesh (reference: OpenFHEParallelControls): by default
    all visible cards on a (dp, limb) grid."""

    def __init__(self):
        self._mesh = None

    def set_mesh(self, mesh: Mesh) -> None:
        self._mesh = mesh

    def get_mesh(self, limb: int | None = None) -> Mesh:
        """The process's mesh, built from the visible cards on first use;
        raises when `limb` is given and the mesh has another limb axis."""
        if self._mesh is None:
            n = len(cards())
            if limb is None:
                limb = 2 if n % 2 == 0 and n > 1 else 1
            self._mesh = make_mesh(limb, max(1, n // limb))
        elif limb is not None and self._mesh.shape.get("limb") != limb:
            raise ValueError(f"the mesh has limb axis "
                             f"{self._mesh.shape.get('limb')}, not {limb}: "
                             f"set_mesh a new one")
        return self._mesh

    def enable(self) -> bool:
        """More than one card visible."""
        return torch.cuda.is_available() and torch.cuda.device_count() > 1


OpenFHEParallelControls = ParallelControls()


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def shard(x: torch.Tensor, mesh: Mesh, spec=()) -> list:
    """Cut x over the mesh: spec[i] names the mesh axis that dim i is cut
    over (None or missing: not cut), as a PartitionSpec does. Every axis
    that cuts no dim replicates. Returns the blocks in mesh order, each on
    its device."""
    spec = tuple(spec) + (None,) * (x.dim() - len(spec))
    for dim, axis in enumerate(spec):
        if axis is not None and x.shape[dim] % mesh.shape[axis]:
            raise ValueError(f"dim {dim} of size {x.shape[dim]} does not "
                             f"divide over axis {axis} of size "
                             f"{mesh.shape[axis]}")
    parts = []
    for dev, coords in zip(mesh.flat, mesh.coords()):
        block = x
        for dim, axis in enumerate(spec):
            if axis is not None:
                size = x.shape[dim] // mesh.shape[axis]
                block = block.narrow(dim, coords[axis] * size, size)
        parts.append(block.to(dev).contiguous())
    return parts


def unshard(parts: list, mesh: Mesh, spec=(), device=None) -> torch.Tensor:
    """The inverse of `shard`: the blocks (one replica of each) joined on
    `device` (default: the first block's)."""
    dev = device if device is not None else parts[0].device
    used = [a for a in spec if a is not None]
    blocks = {}
    for part, coords in zip(parts, mesh.coords()):
        if any(coords[a] for a in mesh.axis_names if a not in used):
            continue                              # a replica
        blocks[tuple(coords[a] for a in used)] = part

    def join(prefix):
        if len(prefix) == len(used):
            return blocks[prefix].to(dev)
        axis = used[len(prefix)]
        return torch.cat([join(prefix + (j,))
                          for j in range(mesh.shape[axis])],
                         list(spec).index(axis))
    return join(())


def ciphertext_spec(k: int, mesh: Mesh) -> tuple:
    """Towers cut over "limb" when k divides, else replicated (the JAX
    package's rule for mid-chain levels)."""
    limb = mesh.shape.get("limb", 1)
    return ("limb", None) if limb > 1 and k % limb == 0 else ()


def shard_ciphertext(ct, mesh: Mesh | None = None):
    """The ciphertext with each [k, N] element as a sharded value."""
    mesh = mesh or OpenFHEParallelControls.get_mesh()
    spec = ciphertext_spec(ct.elements[0].shape[-2], mesh)
    return dataclasses.replace(ct, elements=tuple(
        shard(e, mesh, spec) for e in ct.elements))


def shard_batch(x: torch.Tensor, mesh: Mesh | None = None) -> list:
    """A [batch, ...] tensor cut over "dp"."""
    mesh = mesh or OpenFHEParallelControls.get_mesh()
    return shard(x, mesh, ("dp",))


def replicate(x: torch.Tensor, mesh: Mesh | None = None) -> list:
    """x on every device of the mesh (keys, tables)."""
    mesh = mesh or OpenFHEParallelControls.get_mesh()
    return shard(x, mesh, ())


# ---------------------------------------------------------------------------
# collectives over one group of shards
# ---------------------------------------------------------------------------

def _per_device(parts: list, make) -> list:
    """make(device) for each shard's device, once per distinct device."""
    made = {}
    for p in parts:
        if p.device not in made:
            made[p.device] = make(p.device)
    return [made[p.device] for p in parts]


def all_gather(parts: list, dim: int = 0) -> list:
    """Tiled all_gather: every shard gets torch.cat(parts, dim) on its
    device."""
    return _per_device(parts, lambda d: torch.cat([p.to(d) for p in parts],
                                                  dim))


def all_to_all(parts: list, split_dim: int, concat_dim: int) -> list:
    """Tiled all_to_all: shard j gets chunk j (along split_dim) of every
    shard's block, concatenated along concat_dim in shard order."""
    n = len(parts)
    if any(p.shape[split_dim] % n for p in parts):
        raise ValueError(f"dim {split_dim} does not split into {n}")
    chunks = [p.chunk(n, split_dim) for p in parts]
    return [torch.cat([chunks[i][j].to(parts[j].device) for i in range(n)],
                      concat_dim) for j in range(n)]


def broadcast(x: torch.Tensor, parts: list) -> list:
    """x on the device of every shard of `parts`."""
    return _per_device(parts, lambda d: x.to(d))


def run_groups(body, args: tuple, mesh: Mesh, axis: str = "limb") -> tuple:
    """Run `body` over each group of shards along `axis`.

    args are sharded values whose blocks are [k_loc, N] or [b, k_loc, N];
    body(positions, *group_args) takes, per arg, the list of the group's
    [k_loc, N] blocks and returns a tuple of such lists. A leading batch
    axis of the blocks is run item by item and stacked again. Returns a
    tuple of sharded values in mesh order."""
    outs = None
    for group in mesh.groups(axis):
        lead = args[0][group[0]].shape[:-2]
        items = [()] if not lead else [(i,) for i in range(lead[0])]
        per_item = [body(group, *([a[p][i] for p in group] for a in args))
                    for i in items]
        if outs is None:
            outs = [[None] * mesh.size for _ in per_item[0]]
        for o, res in enumerate(zip(*per_item)):
            for s, pos in enumerate(group):
                blocks = [r[s] for r in res]
                outs[o][pos] = torch.stack(blocks) if lead else blocks[0]
    return tuple(outs)


__all__ = ["AXES", "Mesh", "OpenFHEParallelControls", "ParallelControls",
           "all_gather", "all_to_all", "broadcast", "cards",
           "ciphertext_spec", "make_mesh", "replicate", "run_groups", "shard",
           "shard_batch", "shard_ciphertext", "unshard"]
