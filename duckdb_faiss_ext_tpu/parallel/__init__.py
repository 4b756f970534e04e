"""Multi-chip / multi-host execution: mesh construction, sharded search,
distributed top-k merge, index placement.

The reference is single-node (SURVEY.md §2.3: no distributed backend); this
tier is where the rebuild scales instead — corpus sharded over a
``jax.sharding.Mesh``, queries fanned out, per-shard top-k merged with XLA
collectives over ICI/DCN.
"""
