"""Hand-written CUDA kernels of the port, their plain PyTorch versions
(``ref``) and the device dispatch (``ops``).

- ``fused_verify`` — gather-score-reduce candidate verification with a
  deduplicated top-k (``csrc/fused_verify.cu``): float32, bfloat16, int8
  and packed-int4 tables.
- ``sketch_prefilter`` — the 1-bit Hamming first pass over sign sketches
  (``csrc/sketch_prefilter.cu``).
- ``fused_verify_grouped`` — the cluster-major first pass, one cluster tile
  against a tile of queries (``csrc/fused_verify_grouped.cu``).
- ``lsh_hash`` — the sign bits of a float32 projection packed into keys
  (``csrc/lsh_hash.cu``): every build, refit and query hash.
- ``kmeans_assign`` — nearest-centroid assignment with a running first
  argmin (``csrc/kmeans_assign.cu``): every Lloyd step and upsert.

``quant`` holds the storage schemes, ``schedule`` the cluster-major host
schedule. Nothing here compiles or imports CUDA tooling at import time: a
kernel is built by ``build.load_library`` on its first launch.
"""
