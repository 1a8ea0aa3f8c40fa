"""Frozen work counts, one file per model family.

Each counts the floating-point operations of the matrix products that the
function needs (2·M·N·K a product), whatever implements it: the forward,
the cotangents of the activations that the map needs (no weight
gradients, no recomputation), and the relevancy fold. Elementwise work,
softmax and LayerNorm are not counted. A kernel's bytes count each input
read once and each output written once. The shares built on them
(``metrics/``) therefore cannot pass 100 % of a peak that bounds every
implementation of the configuration's precision.
"""
