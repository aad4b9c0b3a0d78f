"""colormipsearch_tpu — an accelerator-native color depth MIP search (CDS) framework.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
JaneliaSciComp/colormipsearch (the NeuronBridge CDS precompute toolset):

- pixel-match color depth search scoring (dense, batched, on-device)
- gradient/shape score re-ranking (dense fused kernels)
- score normalization
- MIP import/export pipelines with JSON (and pluggable) persistence
- mesh-sharded mask x target pair sweeps via shard_map/pjit

The compute layer is dense and batch-first: images are fixed-size
[H, W] channel planes, scoring is pixelwise map+reduce, and the
mask x target pair grid is block-partitioned over a jax.sharding.Mesh.
"""

__version__ = "0.4.0"
