"""Mesh construction: named axes over the virtual ranks of one card.

Counterpart of accl_tpu/parallel/mesh.py. The reference names a mesh of
devices and runs a body per device under shard_map; the port keeps its
one-card model and names axes over the rank axis of its stacked
tensors. A mesh {"dp": 2, "sp": 2, "tp": 2} is R = 8 virtual ranks in
the reference's row-major device order (rank r has the coordinates
np.unravel_index(r, (2, 2, 2))), and every per-rank tensor of the
reference, of shape S, is a stacked (R, *S) tensor here.

What a shard_map body reads from its mesh, the Mesh gives per rank:
`axis_index(name)` (the (R,) coordinates, lax.axis_index's counterpart),
`axis_size(name)`, and `ring(name)`, the (pos, perm) embedding of one
axis's ring onto the rank axis that the sequencer's ring schedules take
(sequencer/schedules.py `_ring_ctx`). `shard`/`unshard` are the
counterparts of placing a global array under a PartitionSpec and of
reading a shard_map's output back.

A departure: the reference's make_mesh({"dp": 3}) raises because three
devices do not cover its eight. Virtual ranks are as many as the axes
ask for, so the port's check is `world=`: a mesh whose axes do not cover
`world` ranks raises, and `axes=None` factorizes `world`.
"""

from __future__ import annotations

import math

import torch


def factorize_devices(n: int, names=("dp", "sp", "tp")) -> dict[str, int]:
    """Split n devices over parallelism axes, preferring tp (highest
    bandwidth demand) then sp then dp, in powers of two."""
    sizes = {name: 1 for name in names}
    # growth priority: tp, then sp, then dp when present; custom axis
    # names fall back to the given order
    preferred = [m for m in ("tp", "sp", "dp") if m in sizes]
    order = preferred + [m for m in names if m not in preferred]
    remaining = n
    # round-robin factors of two so every axis participates before any
    # axis grows (8 devices -> tp2 x sp2 x dp2)
    while remaining % 2 == 0 and remaining > 1:
        for name in order:
            if remaining % 2 != 0 or remaining <= 1:
                break
            sizes[name] *= 2
            remaining //= 2
    if remaining > 1:  # odd leftover rides the first axis
        sizes[order[0]] *= remaining
    assert math.prod(sizes.values()) == n
    return sizes


class PartitionSpec(tuple):
    """The port's PartitionSpec: one entry per leading dimension, an axis
    name, a tuple of axis names (the dimension split over all of them,
    the first outermost) or None (not split). P() is replicated."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _axes_of(part) -> tuple:
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


class Mesh:
    """Named axes over R = prod(sizes) virtual ranks on `device`, rank r
    at the row-major coordinates of r. Hashable by identity (closures and
    caches key on it)."""

    def __init__(self, axes: dict[str, int], device):
        self.shape = dict(axes)
        self.axis_names = tuple(self.shape)
        self.size = math.prod(self.shape.values())
        self.device = torch.device(device)
        sizes = tuple(self.shape.values())
        self._strides = tuple(math.prod(sizes[i + 1:])
                              for i in range(len(sizes)))
        self.coords = [tuple((r // st) % n for st, n in
                             zip(self._strides, sizes))
                       for r in range(self.size)]
        # per axis, made once on the device (a capture copies no index)
        self._index = {a: torch.tensor([c[i] for c in self.coords],
                                       dtype=torch.int64, device=self.device)
                       for i, a in enumerate(self.axis_names)}
        self._rings = {a: (self._index[a], self.axis_perm(
            a, [(c, (c + 1) % n) for c in range(n)]))
            for a, n in self.shape.items()}
        self._shift = {a: torch.tensor(
            [self._moved(r, a, (self.coord(r, a) - 1) % n)
             for r in range(self.size)], dtype=torch.int64,
            device=self.device) for a, n in self.shape.items()}

    def axis_size(self, name: str) -> int:
        return self.shape[name]

    def _dim(self, name: str) -> int:
        try:
            return self.axis_names.index(name)
        except ValueError:
            raise KeyError(f"no axis {name!r} in mesh {self.shape}") from None

    def coord(self, r: int, name: str) -> int:
        return self.coords[r][self._dim(name)]

    def _moved(self, r: int, name: str, c: int) -> int:
        """The rank with r's coordinates but `c` on axis `name`."""
        i = self._dim(name)
        return r + (c - self.coords[r][i]) * self._strides[i]

    def axis_index(self, name: str) -> torch.Tensor:
        """Every rank's coordinate on `name`, an (R,) int64 tensor on the
        mesh's device (lax.axis_index's counterpart)."""
        self._dim(name)
        return self._index[name]

    def axis_perm(self, name: str, pairs) -> list[tuple[int, int]]:
        """Axis-local (src, dst) coordinate pairs as global rank pairs:
        every line of ranks along `name` takes the same hop."""
        i = self._dim(name)
        return [(r, self._moved(r, name, d)) for s, d in pairs
                for r in range(self.size) if self.coords[r][i] == s]

    def ring(self, name: str):
        """The (pos, perm) embedding of `name`'s ring onto the rank axis:
        pos, each rank's coordinate; perm, the global pairs of one hop
        c -> c+1 along the axis (sequencer/schedules.py `_ring_ctx`)."""
        self._dim(name)
        return self._rings[name]

    def shift_source(self, name: str) -> torch.Tensor:
        """(R,) index: row r of `x[index]` is the row of the rank one step
        before r along `name` (the arrival of the hop c -> c+1)."""
        self._dim(name)
        return self._shift[name]

    def to_front(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """(R, *rest) -> (n, R/n, *rest): the ranks along `name` first,
        the other axes' ranks (row-major) second, so a schedule over a
        rank axis of n runs every line of the axis at once."""
        sizes = tuple(self.shape.values())
        i = self._dim(name)
        rest = x.shape[1:]
        return x.reshape(*sizes, *rest).movedim(i, 0).reshape(
            self.shape[name], self.size // self.shape[name], *rest)

    def from_front(self, y: torch.Tensor, name: str) -> torch.Tensor:
        """Inverse of to_front."""
        sizes = tuple(self.shape.values())
        i = self._dim(name)
        others = sizes[:i] + sizes[i + 1:]
        rest = y.shape[2:]
        return y.reshape(sizes[i], *others, *rest).movedim(0, i).reshape(
            self.size, *rest)

    def _block_slices(self, r: int, spec, shape) -> tuple:
        idx = []
        for d, n in enumerate(shape):
            axes = _axes_of(spec[d]) if d < len(spec) else ()
            blocks, blk = 1, 0
            for a in axes:
                blk = blk * self.shape[a] + self.coord(r, a)
                blocks *= self.shape[a]
            if n % blocks:
                raise ValueError(f"dimension {d} of {tuple(shape)} does not "
                                 f"divide over {axes} ({blocks})")
            w = n // blocks
            idx.append(slice(blk * w, (blk + 1) * w))
        return tuple(idx)

    def local_shape(self, spec, shape) -> tuple:
        """A rank's block shape of a global `shape` placed under `spec`."""
        return tuple(sl.stop - sl.start
                     for sl in self._block_slices(0, spec, shape))

    def shard(self, x, spec=P()) -> torch.Tensor:
        """A global tensor placed under `spec`: the stacked (R, *local)
        tensor on the mesh's device whose row r is rank r's block (a
        replicated dimension gives every rank its own copy)."""
        x = torch.as_tensor(x, device=self.device)
        return torch.stack([x[self._block_slices(r, spec, x.shape)]
                            for r in range(self.size)])

    def unshard(self, y: torch.Tensor, spec=P()) -> torch.Tensor:
        """Inverse of shard: the global tensor from the stacked (R,
        *local) one, each block read from the first rank that holds it
        (coordinate 0 on every axis the spec does not name), as a
        shard_map's out_specs reads a replicated axis."""
        local = y.shape[1:]
        shape = list(local)
        for d, part in enumerate(spec):
            shape[d] *= math.prod(self.shape[a] for a in _axes_of(part))
        named = {a for part in spec for a in _axes_of(part)}
        out = y.new_empty(shape)
        for r in range(self.size):
            if all(self.coords[r][i] == 0 for i, a in
                   enumerate(self.axis_names) if a not in named):
                out[self._block_slices(r, spec, shape)] = y[r]
        return out


def make_mesh(axes: dict[str, int] | None = None, *, world: int | None = None,
              device=None) -> Mesh:
    """Build a named mesh of virtual ranks: make_mesh({'dp': 2, 'tp': 4}).

    `world`, when given, is the number of ranks the axes must cover (the
    reference's device count); `axes=None` factorizes it. The ranks live
    on the card unless `device` names another: with no card and no
    device named, this raises, as ACCL does."""
    if axes is None:
        if world is None:
            raise ValueError("make_mesh needs axes or a world to factorize")
        axes = factorize_devices(world)
    if world is not None and math.prod(axes.values()) != world:
        raise ValueError(f"axes {axes} do not cover {world} devices")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the mesh's ranks live on a CUDA device and none is "
                "available; pass device='cpu' to run on the CPU")
        device = "cuda"
    return Mesh(axes, device)
