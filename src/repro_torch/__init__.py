"""FastVA on PyTorch and CUDA: the port of the ``repro`` package to one
NVIDIA H100.

Same layout as the reference (``core/``, ``kernels/``, ``quant/``,
``models/``, ``configs/``, ``serving/``, ``train/``, ``launch/``,
``session.py``, ``arch.py``).  Entry points run on ``device="cuda"`` unless
the caller asks for the CPU.  The NPU path's int8 GEMM is a hand-written
Hopper kernel (``kernels/npu_matmul/csrc/int8_matmul.cu``), built with
``nvcc`` at first use.
"""
