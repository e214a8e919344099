"""PyTorch/CUDA port of the LIDER learned index (the JAX package ``repro``
is the reference it is tested against).

Entry points: :func:`repro_torch.core.lider.build_lider` and
:func:`repro_torch.core.lider.search_lider`. They run on the CUDA device
unless the caller passes ``device="cpu"``; verification goes through the
hand-written CUDA kernels on the card (``fused_verify``, and on quantized
banks ``sketch_prefilter`` and ``fused_verify_grouped``) and through their
plain PyTorch versions on the CPU.
"""
