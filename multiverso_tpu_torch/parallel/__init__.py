"""Device placement and the world's rank mesh (:mod:`.mesh`), and
sequence/context parallelism over a process group (:mod:`.ring`: ring
attention and the Ulysses all-to-all)."""

from multiverso_tpu_torch.parallel.mesh import (RankMesh, build_device,
                                                build_mesh, pad_to_multiple,
                                                padded_cols, parse_mesh_shape,
                                                replicated, shard_ranges,
                                                table_sharding)
from multiverso_tpu_torch.parallel.ring import (reference_attention,
                                                ring_attention,
                                                ulysses_all_to_all)

__all__ = ["RankMesh", "build_device", "build_mesh", "pad_to_multiple",
           "padded_cols", "parse_mesh_shape", "replicated", "shard_ranges",
           "table_sharding", "reference_attention", "ring_attention",
           "ulysses_all_to_all"]
