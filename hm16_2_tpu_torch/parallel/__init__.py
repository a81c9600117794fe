"""Row-banded device programs: the counterpart of `hm16_2_tpu/parallel/`.

A mesh here is a tuple of torch devices in one process (`frame_shard.
make_row_mesh`, `mesh.make_mesh`), where the reference's is a JAX `Mesh`
driven by `shard_map`.  Each band's tensors live on its device; halos,
references and results move with `Tensor.to(device, non_blocking=True)`,
which between two GPUs is a peer copy that PyTorch orders against both
devices' current streams with events.  A device may appear more than once:
its bands then run one after another on that device's stream, which checks
every band kernel, halo and zero fill on one card.  On the CPU the mesh is
`[torch.device("cpu")] * n`.
"""
