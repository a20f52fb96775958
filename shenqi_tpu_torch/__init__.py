"""shenqi_tpu_torch — the PyTorch/CUDA port of shenqi_tpu.

A second package beside the JAX one, for one NVIDIA H100.  Module and
function names follow `shenqi_tpu` so each module's counterpart is easy
to find; inside, plain functions on torch tensors and dataclasses of
tensors.  Positions stay uint32 fixed point, stored as int32 bit
patterns (torch has no uint32 arithmetic; see core/particles.py).

The one hand-written kernel of this slice is the short-range pair
interaction (`ops/p2p.py`, `csrc/p2p.cu`), built with nvcc into a
C-ABI library and bound with ctypes (`_build.py`).  The package never
imports JAX or `shenqi_tpu`.
"""

__version__ = "0.1.0"
