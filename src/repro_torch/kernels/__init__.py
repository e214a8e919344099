"""Hand-written CUDA kernels of the port, their plain PyTorch versions
(``ref``) and the device dispatch (``ops``).

- ``fused_verify`` — gather-score-reduce candidate verification with a
  deduplicated top-k (``csrc/fused_verify.cu``), float32 and bfloat16 tables.

Nothing here compiles or imports CUDA tooling at import time: the kernel is
built by ``build.load_library`` on its first launch.
"""
