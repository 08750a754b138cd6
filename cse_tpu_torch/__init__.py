"""PyTorch/CUDA port of :mod:`cse_tpu` for NVIDIA Hopper (H100).

The JAX package stays the reference. This package imports ``torch`` only:
never ``jax``, ``flax`` or anything of ``cse_tpu``. Its entry points run on
``cuda`` unless the caller asks for ``device="cpu"``; when CUDA is asked for
and absent they raise.

It carries the serving path (:class:`cse_tpu_torch.serving.ServingEngine`)
with a hand-written CUDA port of ``cse_tpu/ops/fused_stack.py::_stack_kernel``
(``csrc/fused_stack.cu``), and the fused training step
(:func:`cse_tpu_torch.train.step.make_train_step`) with a port of
``cse_tpu/ops/fused_train.py``'s ``_fwd_kernel`` and ``_bwd_kernel``
(``ops/fused_train.py``, ``csrc/fused_train.cu``), the flash attention pair
(``ops/attention.py``, ``csrc/attention.cu``), w8a8 serving
(``ops/fused_stack_w8a8.py``), the trainer entry point
(``python -m cse_tpu_torch.train_ContExt``: :mod:`cse_tpu_torch.train.loop`
with the loaders and the on-device mixture synthesis of
:mod:`cse_tpu_torch.data.pipeline`) and the kernel-parts dev tool
(``python -m cse_tpu_torch.scripts.bench_kernel_parts``,
``csrc/kernel_parts.cu``), the eval entry point (``python -m
cse_tpu_torch.test``: :mod:`cse_tpu_torch.eval`, released-checkpoint import
and export in :mod:`cse_tpu_torch.compat`) and the bench (``python -m
cse_tpu_torch.bench``).

The package file imports nothing (device resolution lives in
:mod:`cse_tpu_torch.core.device`): the eval's metric workers import
:mod:`cse_tpu_torch.eval.host_metrics` and stay numpy-only.
"""
