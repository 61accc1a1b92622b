"""Device placement and the world's rank mesh (:mod:`.mesh`)."""

from multiverso_tpu_torch.parallel.mesh import (RankMesh, build_device,
                                                build_mesh, pad_to_multiple,
                                                padded_cols, parse_mesh_shape,
                                                replicated, shard_ranges,
                                                table_sharding)

__all__ = ["RankMesh", "build_device", "build_mesh", "pad_to_multiple",
           "padded_cols", "parse_mesh_shape", "replicated", "shard_ranges",
           "table_sharding"]
