"""Plain PyTorch references, one file per model family.

They import nothing of the port and take nothing the port made: each draws
its own weights from the run's seed (``weights``) and works out again what
the port derives (answers, kept boxes). Products run in fp32 with TF32 off,
or, as the control of ``correct``, in TF32 (``common.matmul``).
"""
