"""Multi-GPU rendering: the tile-sharded frame (sharding.py), the sharded
fused frame (sharded_fused.py); the variant-sharded batch is
raster/batch.VariantBatch.render_sharded."""
