"""PyTorch/CUDA port of the LIDER learned index (the JAX package ``repro``
is the reference it is tested against).

Entry points: :func:`repro_torch.core.lider.build_lider` and
:func:`repro_torch.core.lider.search_lider`; the index lifecycle
:func:`repro_torch.core.update.upsert` and :func:`repro_torch.core.update.delete`;
checkpoints :func:`repro_torch.training.checkpoint.save_index` and
:func:`repro_torch.training.checkpoint.load_index`. They run on the CUDA
device unless the caller passes ``device="cpu"``. On the card the build
hashes with the ``lsh_hash`` CUDA kernel and clusters with
``kmeans_assign``; verification goes through ``fused_verify``, and on
quantized banks ``sketch_prefilter`` and ``fused_verify_grouped``. On the
CPU each runs as its plain PyTorch version.
"""
