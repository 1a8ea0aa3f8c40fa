"""PyTorch and CUDA port of the JAX package ``transformer_mm_explainability_tpu``

ViT-B/16 relevancy (``models.vit``: the capture chain, the streamed
chains and the three fused kernel paths), with every Pallas kernel on
those paths rewritten by hand in CUDA for Hopper: the block kernels of
``ops/attn_block_pallas.py`` and the fused attention of
``ops/flash_attention.py`` (``ops/attn_block.py``,
``ops/flash_attention.py``, ``csrc/attn_block.cu``) and the relevancy chain
of ``ops/relevancy_pallas.py`` (``ops/relevancy_pallas.py``,
``csrc/relevancy_chain.cu``).
Importing the package imports neither JAX nor the JAX package.
"""
