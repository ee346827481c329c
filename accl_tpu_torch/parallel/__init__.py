"""Parallelism layer: meshes of virtual ranks, long-context sequence
parallelism, the GPipe pipeline and the differentiable axis collectives
they stand on, built from the sequencer's own schedules.

Counterpart of accl_tpu/parallel/. The reference's bodies run per device
under shard_map over a named mesh; here a mesh names axes over the rank
axis of one card's stacked (R, ...) tensors (mesh.py), and a collective
over one axis is the sequencer's schedule embedded on that axis
(collectives.py, which has no reference file: it is the port's
counterpart of JAX's automatic transposes).
"""

from .mesh import factorize_devices, make_mesh  # noqa: F401
from .pipeline import gpipe_schedule  # noqa: F401
from .ring_attention import ring_attention  # noqa: F401
from .ulysses import ulysses_attention  # noqa: F401
