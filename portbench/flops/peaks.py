"""The peaks every share is taken against (NVIDIA H100 SXM data sheet,
dense, at the 700 W power limit).

``FLOPS``: 495 TFLOP/s, the TF32 tensor-core rate. The fp32
configurations promise fp32 results (TF32 off); no implementation that
keeps that promise computes its products faster than single-pass TF32
(3xTF32, two TF32 products or a bf16 split all take longer), so no sound
change can read above 100 % of it. ``BYTES``: 3.35 TB/s of HBM3.
"""

FLOPS = 495e12
BYTES = 3.35e12
