"""Data and strip parallelism over ``torch.distributed``.

Port of ``parallel/``: ``mesh`` (a (data, tile) layout of ranks),
``distributed`` (process-group set-up and host agreement), ``train_step``
(the data-parallel step over a camera batch, ``DPTrainer``,
``training_dp``) and ``render_sp`` (one frame rendered in horizontal
strips). The JAX package runs one controller over a device mesh; the port
runs one process per device, each holding a replica of the Gaussians.
"""

from neuralgaussiansplatting_torch.parallel.mesh import make_mesh  # noqa: F401
